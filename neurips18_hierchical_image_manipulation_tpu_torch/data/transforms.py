"""Paired host-side transforms (pix2pixHD data/base_dataset.py).

``get_params`` draws the crop position / flip coin once per sample;
``apply_transform`` applies the SAME geometry to label (nearest), inst
(nearest) and RGB (bicubic) — the reference's paired-transform contract.
resize_or_crop ∈ {resize_and_crop, scale_width, scale_width_and_crop,
crop, none}; normalize maps RGB to [-1, 1].

Host work is geometry + decode only — one-hot/edges/masking happen on
the device (kernels/encode.py).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def get_params(opt, size, rng: np.random.RandomState):
    w, h = size
    new_h, new_w = h, w
    if opt.resize_or_crop == "resize_and_crop":
        new_h = new_w = opt.loadSize
    elif opt.resize_or_crop in ("scale_width", "scale_width_and_crop"):
        new_w = opt.loadSize
        new_h = opt.loadSize * h // w

    x = rng.randint(0, max(0, new_w - opt.fineSize) + 1)
    y = rng.randint(0, max(0, new_h - opt.fineSize) + 1)
    flip = bool(rng.rand() > 0.5)
    return {"crop_pos": (x, y), "flip": flip, "new_size": (new_w, new_h)}


def _scale_width(img, target_width, method):
    ow, oh = img.size
    if ow == target_width:
        return img
    w = target_width
    h = int(target_width * oh / ow)
    return img.resize((w, h), method)


def _crop(img, pos, size):
    ow, oh = img.size
    x, y = pos
    if ow > size or oh > size:
        return img.crop((x, y, x + size, y + size))
    return img


def apply_transform(img: Image.Image, opt, params, method=Image.BICUBIC):
    if opt.resize_or_crop == "resize_and_crop":
        img = img.resize((opt.loadSize, opt.loadSize), method)
    elif opt.resize_or_crop.startswith("scale_width"):
        img = _scale_width(img, opt.loadSize, method)
    if "crop" in opt.resize_or_crop:
        img = _crop(img, params["crop_pos"], opt.fineSize)
    if opt.isTrain and not opt.no_flip and params["flip"]:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def normalize_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [-1,1] (Normalize(0.5, 0.5))."""
    from . import native

    if arr.dtype == np.uint8:
        return native.u8_to_pm1(arr)
    return arr.astype(np.float32) / 127.5 - 1.0

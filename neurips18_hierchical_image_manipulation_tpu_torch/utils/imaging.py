"""Tensor→image utilities (pix2pixHD util/util.py).

``tensor2im``: [-1,1] float -> uint8 RGB. ``tensor2label``: label ids or
one-hot/logits -> Cityscapes-palette RGB via ``Colorize``. NHWC layout
(single image: HWC).
"""

from __future__ import annotations

import numpy as np

# 35-entry Cityscapes palette (labelIds order, includes void classes) —
# the reference colorizes 35-class Cityscapes label maps.
CITYSCAPES_PALETTE_35 = np.array(
    [
        (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0),
        (111, 74, 0), (81, 0, 81), (128, 64, 128), (244, 35, 232),
        (250, 170, 160), (230, 150, 140), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (180, 165, 180), (150, 100, 100), (150, 120, 90),
        (153, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90),
        (0, 0, 110), (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
    ],
    dtype=np.uint8,
)


def _generic_palette(n):
    """pix2pixHD-style bit-twiddled colormap for arbitrary label counts."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(7):
            r |= ((idx >> 0) & 1) << (7 - j)
            g |= ((idx >> 1) & 1) << (7 - j)
            b |= ((idx >> 2) & 1) << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    return cmap


class Colorize:
    def __init__(self, n=35):
        self.cmap = CITYSCAPES_PALETTE_35 if n == 35 else _generic_palette(n)

    def __call__(self, label_ids):
        """(H,W) int ids -> (H,W,3) uint8."""
        ids = np.clip(np.asarray(label_ids, np.int64), 0, len(self.cmap) - 1)
        return self.cmap[ids]


def tensor2im(t, imtype=np.uint8):
    """(H,W,3) or (B,H,W,3) in [-1,1] -> uint8 (first image if batched).
    uint8 input (an --uint8_transfer batch) is already display-ready."""
    a = np.asarray(t)
    if a.dtype == np.uint8:
        return a[0] if a.ndim == 4 else a
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        a = a[0]
    a = (a + 1.0) / 2.0
    return (np.clip(a, 0, 1) * 255.0).astype(imtype)


def tensor2label(t, n_label=35):
    """Label ids (H,W)/(B,H,W) or one-hot/logits (...,C) -> palette RGB."""
    a = np.asarray(t)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3:
        # Disambiguate batched (B,H,W) integer id maps from (H,W,C)
        # one-hot/logits: integer dtype (or a last dim that can't be the
        # class axis) means batch-of-ids — take the first image, don't
        # argmax over W (which produced garbage label visuals).
        if np.issubdtype(a.dtype, np.integer) or a.shape[-1] != n_label:
            a = a[0]
        else:  # (H,W,C) one-hot / logits / probs
            a = a.argmax(-1)
    return Colorize(n_label)(a)


def save_image(arr, path):
    from PIL import Image

    Image.fromarray(np.asarray(arr)).save(path)

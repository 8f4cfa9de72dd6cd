"""Synthetic Cityscapes-shaped data for tests and smoke runs.

Generates structured random (label, inst, image, box) batches with the
reference dataset's contract: label ids in [0, label_nc), instance ids
``class*1000+k`` for "thing" classes, RGB in [-1, 1]; and box2mask's
fixed-size context-window crops. Both give the JAX package's
``data/synthetic.py`` arrays for the same ``RandomState``.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(
    rng: np.random.RandomState,
    batch_size: int = 1,
    hw=(256, 512),
    label_nc: int = 35,
    with_boxes: bool = True,
):
    h, w = hw
    label = np.zeros((batch_size, h, w), np.int32)
    inst = np.zeros((batch_size, h, w), np.int32)
    boxes = np.zeros((batch_size, 4), np.float32)
    # horizon-style background bands + a few rectangular "objects"
    for b in range(batch_size):
        split = rng.randint(h // 4, 3 * h // 4)
        label[b, :split] = rng.randint(0, label_nc // 2)
        label[b, split:] = rng.randint(0, label_nc // 2)
        for k in range(3):
            cls = rng.randint(label_nc // 2, label_nc)
            bh = rng.randint(h // 8, h // 2)
            bw = rng.randint(w // 8, w // 2)
            y0 = rng.randint(0, h - bh)
            x0 = rng.randint(0, w - bw)
            label[b, y0 : y0 + bh, x0 : x0 + bw] = cls
            inst[b, y0 : y0 + bh, x0 : x0 + bw] = cls * 1000 + k
            if k == 0:
                boxes[b] = (y0, x0, bh, bw)
    image = rng.uniform(-1, 1, size=(batch_size, h, w, 3)).astype(np.float32)
    batch = {"label": label, "inst": inst, "image": image}
    if with_boxes:
        batch["boxes"] = boxes
    return batch


def synthetic_box2mask_batch(
    rng: np.random.RandomState,
    batch_size: int = 1,
    size: int = 128,
    label_nc: int = 35,
):
    """Fixed-size context-window crops for the structure generator: the
    GT layout, the box-masked layout, in-window box mask, class id, and the
    GT object mask (pixels of class c inside the box)."""
    s = size
    gt = np.zeros((batch_size, s, s), np.int32)
    boxmask = np.zeros((batch_size, s, s, 1), np.float32)
    objmask = np.zeros((batch_size, s, s, 1), np.float32)
    cls_ids = np.zeros((batch_size,), np.int32)
    for b in range(batch_size):
        gt[b] = rng.randint(0, label_nc // 2)
        cls = rng.randint(label_nc // 2, label_nc)
        cls_ids[b] = cls
        bh = rng.randint(s // 4, s // 2)
        bw = rng.randint(s // 4, s // 2)
        y0 = rng.randint(s // 8, s - bh - s // 8)
        x0 = rng.randint(s // 8, s - bw - s // 8)
        boxmask[b, y0 : y0 + bh, x0 : x0 + bw] = 1.0
        # object fills an ellipse-ish sub-region of the box
        yy, xx = np.mgrid[0:s, 0:s]
        cy, cx = y0 + bh / 2, x0 + bw / 2
        obj = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1.0
        gt[b][obj] = cls
        objmask[b, :, :, 0] = obj.astype(np.float32)
    masked = gt.copy()
    # the box interior is unknown to the model (encode_input zeroes the
    # one-hot there; keep ids valid)
    return {
        "gt_layout": gt,
        "masked_layout": masked,
        "boxmask": boxmask,
        "gt_objmask": objmask * boxmask[..., 0:1] if objmask.ndim == 4 else objmask,
        "cls": cls_ids,
    }

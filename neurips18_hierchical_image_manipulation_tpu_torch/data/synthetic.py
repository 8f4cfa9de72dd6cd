"""Synthetic Cityscapes-shaped data for tests and smoke runs.

Generates structured random (label, inst, image, box) batches with the
reference dataset's contract: label ids in [0, label_nc), instance ids
``class*1000+k`` for "thing" classes, RGB in [-1, 1].
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

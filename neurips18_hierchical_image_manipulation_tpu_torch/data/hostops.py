"""Host-side numpy helpers of the data pipeline: the plain forms of the
C++ tier (``data/native.py``, ``csrc/dataio.cpp``), which returns the same
results and falls back to these where it cannot be built.
"""

from __future__ import annotations

import numpy as np


def extract_bboxes(inst: np.ndarray, min_id: int = 1000):
    """(H,W) instance map -> [{inst_id, cls, bbox=(y0,x0,h,w)}] for every
    id >= min_id, in ascending id order (Cityscapes ``class*1000+k``)."""
    inst = np.ascontiguousarray(inst, np.int32)
    recs = []
    for iid in np.unique(inst):
        if iid < min_id:
            continue
        ys, xs = np.nonzero(inst == iid)
        recs.append(
            {
                "inst_id": int(iid),
                "cls": int(iid // 1000),
                "bbox": [
                    int(ys.min()),
                    int(xs.min()),
                    int(ys.max() - ys.min() + 1),
                    int(xs.max() - xs.min() + 1),
                ],
            }
        )
    return recs


def u8_to_pm1(img: np.ndarray) -> np.ndarray:
    """uint8 array -> float32 in [-1, 1]."""
    return np.asarray(img, np.uint8).astype(np.float32) / 127.5 - 1.0


def nearest_resize_i32(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest-neighbour resize of an int map to (oh, ow), pixel centers."""
    arr = np.ascontiguousarray(arr, np.int32)
    ys = np.minimum(((np.arange(oh) + 0.5) * arr.shape[0] / oh).astype(np.int64),
                    arr.shape[0] - 1)
    xs = np.minimum(((np.arange(ow) + 0.5) * arr.shape[1] / ow).astype(np.int64),
                    arr.shape[1] - 1)
    return arr[ys][:, xs]


def box_mask_f32(h: int, w: int, y0: int, x0: int, bh: int, bw: int) -> np.ndarray:
    """(h, w, 1) float32 mask, 1 inside the (y0, x0, bh, bw) box."""
    out = np.zeros((h, w, 1), np.float32)
    out[max(y0, 0) : y0 + bh, max(x0, 0) : x0 + bw] = 1.0
    return out

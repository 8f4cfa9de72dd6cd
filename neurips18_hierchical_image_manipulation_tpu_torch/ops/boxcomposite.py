"""Box masks for the masked-RGB conditioning, NHWC.

Counterpart of ``box_mask`` / ``mask_box`` in ``ops/boxcomposite.py`` of
the JAX package. Boxes are (y0, x0, h, w) in pixels; the inside test runs
in fp32 on pixel indices exactly as ``_box_mask_one`` does, so fractional
boxes land on the same pixels.
"""

from __future__ import annotations

import torch


def box_mask(boxes: torch.Tensor, hw, dtype=torch.float32):
    """(B,4) boxes -> (B,H,W,1) binary inside-box masks."""
    b = boxes.to(torch.float32)
    y0, x0, bh, bw = (b[:, k, None, None] for k in range(4))
    yy = torch.arange(hw[0], dtype=torch.float32, device=b.device)[None, :, None]
    xx = torch.arange(hw[1], dtype=torch.float32, device=b.device)[None, None, :]
    inside = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
    return inside.to(dtype)[..., None]


def mask_box(images: torch.Tensor, boxes: torch.Tensor, fill: float = 0.0):
    """Fill each image's box interior with ``fill``: images*(1-m) + fill*m."""
    m = box_mask(boxes, images.shape[1:3], dtype=images.dtype)
    return images * (1.0 - m) + fill * m

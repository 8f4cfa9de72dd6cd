"""Box crop / resize / paste-back compositing, NHWC.

Counterpart of ``ops/boxcomposite.py`` in the JAX package. Boxes are (y0,
x0, h, w) in pixels, fp32, and stay on the device: a dynamic box is
cropped and resized to a fixed window by index arithmetic and per-image
gathers (``crop_resize``), and a fixed-size patch is composited back into
its box by the inverse map from each canvas pixel (``paste_resize``). The
sample coordinates are computed in fp32 with the roundings of the JAX
package's compiled form (a division by a constant as a product with its
reciprocal, ``a * b + c`` as one fused multiply-add, a quotient as one
division), so both packages gather the same pixels; ``F.grid_sample`` and
``F.interpolate`` are not used, since their normalized coordinates and
edge rules are not these. Integer maps go through fp32 (ids up to 2^24
are exact there).

``box_mask`` / ``mask_box`` build the box-masked conditioning, and
``context_window_math`` is the one context-window rule of the host
dataset (numpy) and the two-step pipeline (torch).
"""

from __future__ import annotations

import numpy as np
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


def _fma(a, b, c):
    """fp32 ``a * b + c`` rounded once, as the JAX package's compiled form
    computes it (XLA contracts it into a fused multiply-add): the fp64
    product of two fp32 values is exact. A coordinate one ulp off can move
    a nearest sample to the next pixel where it lands on a half."""
    return (a.to(torch.float64) * b.to(torch.float64) + c).to(torch.float32)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as one IEEE division per element. (``num / t`` in torch is
    computed as ``t.reciprocal() * num``, two roundings, which lands one ulp
    off the JAX package's quotient.)"""
    return torch.full_like(t, float(num)) / t


def _sample_coords(start, size, out_size: int):
    """(B,) start, size -> (B, out_size) sample centres of the interval
    resized to out_size (align_corners=False): start + (i + 0.5) * step -
    0.5, where step = size / out_size is taken, as XLA compiles a division
    by a constant, as size times the fp32 reciprocal."""
    i = torch.arange(out_size, dtype=torch.float32, device=start.device)
    step = size * torch.tensor(1.0 / out_size, dtype=torch.float32)
    return _fma((i + 0.5)[None, :], step[:, None], start[:, None].double()) - 0.5


def _gather(images, yi, xi):
    """images (B,H,W,C), yi (B,h,1) and xi (B,1,w) int64 -> (B,h,w,C)."""
    bidx = torch.arange(images.shape[0], device=images.device)[:, None, None]
    return images[bidx, yi, xi]


def _pil_cubic(t):
    """PIL's bicubic kernel (Keys, a = -0.5), support 2."""
    at = t.abs()
    near = ((1.5 * at - 2.5) * at) * at + 1.0
    far = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
    return torch.where(at < 1.0, near, torch.where(at < 2.0, far, torch.zeros_like(at)))


def _pil_resample_weights(start, size, out_size: int, full: int):
    """(B,) start, size -> (B, out_size, full) resample matrices of PIL's
    bicubic resize of the window [start, start + size) to out_size, over the
    full axis (JAX ``_pil_resample_weights``, ``boxcomposite.py:56-89``): a
    downscale widens the kernel by size / out_size, taps outside the window
    are dropped and each row is normalized over the taps left. A row whose
    taps sum to about 0 (a window of size 0, or outside the axis) is zeros,
    not NaN."""
    scale = size / out_size
    fscale = torch.clamp_min(scale, 1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=start.device)
    centers = start[:, None] + (i + 0.5)[None, :] * scale[:, None]
    j = torch.arange(full, dtype=torch.float32, device=start.device)[None, None, :]
    w = _pil_cubic((j + 0.5 - centers[:, :, None]) / fscale[:, None, None])
    inside = (j >= start[:, None, None]) & (j < (start + size)[:, None, None])
    w = torch.where(inside, w, torch.zeros_like(w))
    denom = w.sum(-1, keepdim=True)
    ok = denom.abs() > 1e-6
    return torch.where(ok, w / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(w))


def _crop_resize_pil(images, boxes, out_hw):
    """PIL-bicubic crop + resize as two products a window (JAX
    ``_crop_resize_pil_one``): rows, then columns, in fp32. A float input
    keeps its dtype; an unsigned one is clipped to its range, as PIL clamps
    the cubic's overshoot (PIL also rounds its intermediate pass to the
    integer type, which this does not). The products run on the matmul
    precision the caller's tier set: TF32 moves them by about 1e-3 relative,
    so the fp32 tier keeps it off (models/factory.precision_scope)."""
    b = boxes.to(torch.float32)
    wy = _pil_resample_weights(b[:, 0], b[:, 2], out_hw[0], images.shape[1])
    wx = _pil_resample_weights(b[:, 1], b[:, 3], out_hw[1], images.shape[2])
    f = images.to(torch.float32).permute(0, 3, 1, 2)           # (B,C,H,W)
    y = torch.matmul(torch.matmul(wy[:, None], f), wx[:, None].transpose(-1, -2))
    y = y.permute(0, 2, 3, 1)                                   # (B,oh,ow,C)
    if images.dtype.is_floating_point:
        return y.to(images.dtype)
    if images.dtype in (torch.uint8, torch.uint16):
        return y.clamp(0.0, float(torch.iinfo(images.dtype).max))
    return y


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, out_hw, method: str = "bilinear"):
    """Crop each image's box and resize it to out_hw.

    images (B,H,W,C); boxes (B,4) = (y0,x0,h,w) -> (B,out_h,out_w,C).
    "nearest" keeps the dtype; "bilinear" (edge clamp) returns a float
    input's dtype, else fp32; "pil_bicubic" (PIL's bicubic with its
    downscale antialiasing, the streaming bbox loader's resample) returns a
    float input's dtype, else fp32 clipped to an unsigned input's range."""
    if method == "pil_bicubic":
        return _crop_resize_pil(images, boxes, out_hw)
    if method not in ("nearest", "bilinear"):
        raise ValueError(f"unknown crop_resize method {method!r}")
    h_img, w_img = images.shape[1], images.shape[2]
    b = boxes.to(torch.float32)
    ys = _sample_coords(b[:, 0], b[:, 2], out_hw[0])
    xs = _sample_coords(b[:, 1], b[:, 3], out_hw[1])
    if method == "nearest":
        yi = torch.floor(ys + 0.5).to(torch.int64).clamp(0, h_img - 1)
        xi = torch.floor(xs + 0.5).to(torch.int64).clamp(0, w_img - 1)
        return _gather(images, yi[:, :, None], xi[:, None, :])
    # clamp the sample coordinate first, so the weights match the clipped
    # indices
    ys = ys.clamp(0.0, h_img - 1.0)
    xs = xs.clamp(0.0, w_img - 1.0)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0f)[:, :, None, None]
    wx = (xs - x0f)[:, None, :, None]
    yi0 = y0f.to(torch.int64)
    yi1 = torch.clamp_max(yi0 + 1, h_img - 1)
    xi0 = x0f.to(torch.int64)
    xi1 = torch.clamp_max(xi0 + 1, w_img - 1)
    f = images.to(torch.float32)
    yi0, yi1, xi0, xi1 = yi0[:, :, None], yi1[:, :, None], xi0[:, None, :], xi1[:, None, :]
    top = _gather(f, yi0, xi0) * (1 - wx) + _gather(f, yi0, xi1) * wx
    bot = _gather(f, yi1, xi0) * (1 - wx) + _gather(f, yi1, xi1) * wx
    out_dtype = images.dtype if images.dtype.is_floating_point else torch.float32
    return (top * (1 - wy) + bot * wy).to(out_dtype)


def paste_resize(canvases: torch.Tensor, patches: torch.Tensor, boxes: torch.Tensor,
                 method: str = "bilinear"):
    """Resize each patch to its box and composite it into the canvas.

    canvases (B,H,W,C); patches (B,ph,pw,C); boxes (B,4) -> (B,H,W,C):
    inside the box, the patch sampled at the canvas pixel's inverse-mapped
    coordinate; outside, the canvas unchanged."""
    if method not in ("nearest", "bilinear"):
        raise ValueError(f"unknown paste_resize method {method!r}")
    h, w = canvases.shape[1], canvases.shape[2]
    ph, pw = patches.shape[1], patches.shape[2]
    b = boxes.to(torch.float32)
    y0, x0, bh, bw = (b[:, k, None, None] for k in range(4))
    yy = torch.arange(h, dtype=torch.float32, device=b.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=b.device)[None, None, :]
    inside = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
    py = _fma(yy - y0 + 0.5, rdiv(ph, torch.clamp_min(bh, 1.0)), -0.5)
    px = _fma(xx - x0 + 0.5, rdiv(pw, torch.clamp_min(bw, 1.0)), -0.5)
    if method == "nearest":
        pyi = torch.floor(py + 0.5).to(torch.int64).clamp(0, ph - 1)
        pxi = torch.floor(px + 0.5).to(torch.int64).clamp(0, pw - 1)
        sampled = _gather(patches, pyi, pxi)
    else:
        py = py.clamp(0.0, ph - 1.0)
        px = px.clamp(0.0, pw - 1.0)
        y0f, x0f = torch.floor(py), torch.floor(px)
        wy = (py - y0f)[..., None]
        wx = (px - x0f)[..., None]
        yi0 = y0f.to(torch.int64)
        yi1 = torch.clamp_max(yi0 + 1, ph - 1)
        xi0 = x0f.to(torch.int64)
        xi1 = torch.clamp_max(xi0 + 1, pw - 1)
        f = patches.to(torch.float32)
        sampled = (
            _gather(f, yi0, xi0) * (1 - wy) * (1 - wx)
            + _gather(f, yi0, xi1) * (1 - wy) * wx
            + _gather(f, yi1, xi0) * wy * (1 - wx)
            + _gather(f, yi1, xi1) * wy * wx
        ).to(canvases.dtype)
    return torch.where(inside[..., None], sampled, canvases)


def context_window_math(y0, x0, bh, bw, hw, context_scale, out_size, xp=np):
    """The context-window rule, one source for the host bbox dataset
    (``xp=numpy``, training crops) and the two-step pipeline (``xp=torch``,
    inference), so that both see windows of one distribution: a square
    window of ``context_scale`` x the box's max side, floored at
    ``max(out_size/8, 8)``, centred, clipped to the image, integer-floored
    like the host crop indices. (Written with ``clip``, whose scalar bounds
    numpy and torch both take, where the JAX package's uses ``maximum`` /
    ``minimum``: the same values.)"""
    cy = y0 + bh / 2.0
    cx = x0 + bw / 2.0
    min_side = max(float(out_size) / 8.0, 8.0)
    side = xp.clip(xp.maximum(bh, bw) * context_scale, min_side, None)
    side_h = xp.clip(side, None, float(hw[0]))
    side_w = xp.clip(side, None, float(hw[1]))
    wy0 = xp.floor(xp.minimum(xp.clip(cy - side_h / 2.0, 0.0, None), hw[0] - side_h))
    wx0 = xp.floor(xp.minimum(xp.clip(cx - side_w / 2.0, 0.0, None), hw[1] - side_w))
    return wy0, wx0, xp.floor(side_h), xp.floor(side_w)


def expand_to_context_window(boxes: torch.Tensor, hw, context_scale: float = 2.0,
                             out_size: int = 128):
    """(B,4) fp32 object boxes -> (B,4) fp32 context windows (y0, x0, h, w),
    clipped to the image."""
    b = boxes.to(torch.float32)
    wy0, wx0, side_h, side_w = context_window_math(
        b[:, 0], b[:, 1], b[:, 2], b[:, 3], hw, context_scale, out_size, torch)
    return torch.stack([wy0, wx0, side_h, side_w], dim=1)

"""The three forms of ConvTranspose2d(k3, s2, p1, op1) at the generator's
four upsampling shapes, forward + backward, on one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.bench_convt \\
        [--bs 32] [--iters 30] [--out FILE]

Counterpart of ``tools/bench_convt.py`` in the JAX package, at its shapes
(the G's four ups at 512x256 training: 16x32 1024->512 ... 128x256
128->64), bs 32, bf16, forward + backward of sum(y.float()^2) with respect
to x and w:

  * ``adjoint``: the port's ``ops/nnops.conv_transpose2d``
    (``F.conv_transpose2d``: cuDNN's transposed convolution, whose dgrad
    is the step's nondeterministic one);
  * ``subpixel``: four phase convolutions and an interleave (JAX
    ``nnops.conv_transpose2d_subpixel``);
  * ``d2s``: one 2x2 convolution to 4*Co channels, then depth-to-space
    (``F.pixel_shuffle``; JAX ``nnops.conv_transpose2d_d2s``).

The forms live here; the port's ``ops/nnops.py`` keeps its one form.
Activations are NHWC as in the port (each convolution takes the
channels_last NCHW view). Before timing, the tool holds the three forms to
each other in fp32 with TF32 off at each shape (``AGREE_RTOL`` of max |y|)
and raises if they disagree. Times by CUDA events
(``roofline_resblock.cuda_ms``); one JSON line a shape and the report to
``--out`` (default under ``reports/torch_r13/``), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nnops
from . import roofline_step as rs

# the G's four upsamplers at 512x256 training: (H, W, Cin -> Cout)
SHAPES = [(16, 32, 1024, 512), (32, 64, 512, 256), (64, 128, 256, 128), (128, 256, 128, 64)]
SMOKE_SHAPES = [(4, 8, 16, 8), (8, 16, 8, 4)]
AGREE_RTOL = 1e-5   # fp32, the same products summed in another order


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def adjoint(x, w):
    """x (N,H,W,Ci) NHWC, w (Ci,Co,3,3) -> (N,2H,2W,Co)."""
    return nnops.conv_transpose2d(x, w)


def subpixel(x, w):
    """The four output phases as ordinary convolutions (JAX
    ``conv_transpose2d_subpixel``): out[2i+r, 2j+s] reads x[i, j] and,
    where r or s is 1, its right and lower neighbours (zero past the
    edge)."""
    wt = w.transpose(0, 1)   # (Co, Ci, ky, kx)
    xc = _nchw(x)

    def pconv(k, pad_h, pad_w):
        return _nhwc(F.conv2d(F.pad(xc, (0, pad_w, 0, pad_h)) if pad_h or pad_w else xc, k))

    p00 = pconv(wt[:, :, 1:2, 1:2], 0, 0)
    p01 = pconv(torch.stack([wt[:, :, 1, 2], wt[:, :, 1, 0]], -1)[:, :, None], 0, 1)
    p10 = pconv(torch.stack([wt[:, :, 2, 1], wt[:, :, 0, 1]], -1)[:, :, :, None], 1, 0)
    k11 = torch.stack([torch.stack([wt[:, :, 2, 2], wt[:, :, 2, 0]], -1),
                       torch.stack([wt[:, :, 0, 2], wt[:, :, 0, 0]], -1)], -2)
    p11 = pconv(k11, 1, 1)
    n, h, wd, co = p00.shape
    top = torch.stack([p00, p01], 3)
    bot = torch.stack([p10, p11], 3)
    return torch.stack([top, bot], 2).reshape(n, 2 * h, 2 * wd, co)


def d2s_kernel(w):
    """(4*Co, Ci, 2, 2): tap (dy, dx) of phase r*2+s at channel c*4 +
    r*2 + s (``F.pixel_shuffle``'s order), zero where the phase does not
    read that tap (JAX ``_convt_d2s_kernel``, channels phase-major there)."""
    ci, co = w.shape[:2]
    wt = w.transpose(0, 1)
    k = wt.new_zeros((co, 4, ci, 2, 2))
    taps = {(0, 0): ((0, 1, 1), (1, 1, 2), (2, 2, 1), (3, 2, 2)),
            (0, 1): ((1, 1, 0), (3, 2, 0)),
            (1, 0): ((2, 0, 1), (3, 0, 2)),
            (1, 1): ((3, 0, 0),)}
    for (dy, dx), uses in taps.items():
        for phase, ky, kx in uses:
            k[:, phase, :, dy, dx] = wt[:, :, ky, kx]
    return k.reshape(co * 4, ci, 2, 2)


def d2s(x, w):
    """One 2x2 convolution to 4*Co channels, then depth-to-space."""
    y4 = F.conv2d(F.pad(_nchw(x), (0, 1, 0, 1)), d2s_kernel(w))
    return _nhwc(F.pixel_shuffle(y4, 2))


FORMS = {"adjoint": adjoint, "subpixel": subpixel, "d2s": d2s}


def inputs(bs, h, w, ci, co, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(bs, h, w, ci).astype(np.float32))
    k = torch.from_numpy((0.05 * rng.randn(ci, co, 3, 3)).astype(np.float32))
    return x.to(device=device, dtype=dtype), k.to(device=device, dtype=dtype)


def agree(shape, bs, device):
    """max |form - adjoint| / max |adjoint| over the forms, fp32, TF32 off."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, k = inputs(min(bs, 4), *shape, torch.float32, device)
        ref = adjoint(x, k)
        scale = float(ref.abs().max())
        return {n: float((f(x, k) - ref).abs().max()) / scale for n, f in FORMS.items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def fwd_bwd(form, x, k):
    def run():
        x.grad = k.grad = None
        y = form(x, k)
        (y.float() ** 2).sum().backward()
    return run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--smoke", action="store_true", help="tiny shapes (the CPU tests')")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "bench_convt.json"))
    args = p.parse_args(argv)
    device = rs.device_of(args.gpu_ids)
    rows = []
    for h, w_, ci, co in SMOKE_SHAPES if args.smoke else SHAPES:
        diffs = agree((h, w_, ci, co), args.bs, device)
        bad = {n: d for n, d in diffs.items() if d > AGREE_RTOL}
        if bad:
            raise AssertionError(f"ConvT forms disagree at {h}x{w_}x{ci}->{co}: {bad}")
        x, k = inputs(args.bs, h, w_, ci, co, torch.bfloat16, device)
        x.requires_grad_(True)
        k.requires_grad_(True)
        row = {"shape": f"{h}x{w_}x{ci}->{co}", "max_rel_diff_fp32": diffs}
        for name, form in FORMS.items():
            row[name + "_ms"] = rs.timed_ms(fwd_bwd(form, x, k), device, args.iters)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, k
    report = {"device": rs.device_line(device), "bs": args.bs, "dtype": "bfloat16",
              "iters": args.iters, "agree_rtol": AGREE_RTOL, "rows": rows}
    rs.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()

"""InstanceNorm(affine=False) forward, fused with an optional residual add
and an optional activation: ``y = act(IN(x) + residual)``, NHWC.

Replaces the forward TPU kernel of ``ops/pallas/instance_norm.py`` (JAX
package): ``fused_instance_norm`` -> ``_run_fwd`` / ``_fwd_kernel``. eps
1e-5 inside the sqrt, biased variance, fp32 statistics, IO in x's dtype;
also returns the per-(n, c) mean and rstd (fp32, (N, C)) for a backward.

Bound: bytes (a few operations per byte). The TPU kernel carries its sums
across a sequential grid axis; blocks on this card run in parallel, and
at the stem (HW 131072, C 64) one block per (n, channel tile) would fill 2
of 132 SMs. So ``csrc/instance_norm.cu`` splits HW across blocks (Welford
partials), merges them with Chan's formula, then normalizes elementwise —
see the source. ``_splits`` picks the split so the first launch fills the
card about once.

The JAX package gates its IN kernel off (``ops/pallas/config.py``
``_IN_KERNEL = False``); that was a TPU measurement and does not carry
over: on the card every IN site of the generator goes through this
kernel. A CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import nnops
from . import _build

EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "lrelu": 2}
_TARGET_BLOCKS = 132 * 8  # resident 256-thread blocks on an H100
_MIN_ROWS = 64            # at least 8 rows for each of a block's 8 row lanes


def instance_norm_plain(x, act="none", residual=None, eps=EPS):
    """Plain PyTorch version: two-pass fp32 statistics, the same epilogue."""
    n, _, _, c = x.shape
    mean, rstd = nnops.instance_norm_stats(x, eps)
    y = nnops.normalize_act(x, mean, rstd, act, residual)
    return y, mean.reshape(n, c), rstd.reshape(n, c)


def _splits(n: int, hw: int, c: int):
    """(splits, rows per split) of the HW axis for the statistics launch."""
    tiles = n * -(-c // 32)
    s = max(1, min(-(-_TARGET_BLOCKS // tiles), hw // _MIN_ROWS))
    chunk = -(-hw // s)
    chunk = -(-chunk // 8) * 8
    return -(-hw // chunk), chunk


def _check(x, act, residual):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if residual is not None and (
        residual.shape != x.shape
        or residual.dtype != x.dtype
        or residual.device != x.device
        or not residual.is_contiguous()
    ):
        raise ValueError("residual must match x in shape, dtype, device and layout")


def instance_norm(x, act: str = "none", residual: Optional[torch.Tensor] = None,
                  eps: float = EPS):
    """NHWC -> (y, mean, rstd): y = act(IN(x) + residual) in x's dtype."""
    _check(x, act, residual)
    if x.device.type == "cpu":
        return instance_norm_plain(x, act, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    if n > 65535 or h * w * c >= 2**30:
        raise ValueError(f"instance_norm grid limits: N {n} <= 65535, H*W*C {h * w * c} < 2^30")
    lib = _lib()
    s, chunk = _splits(n, h * w, c)
    y = torch.empty_like(x)
    # one fp32 allocation: mean, rstd, then the (3, n, s, c) split partials
    ws = torch.empty(2 * n * c + 3 * n * s * c, dtype=torch.float32, device=x.device)
    mean, rstd = ws[: n * c].view(n, c), ws[n * c : 2 * n * c].view(n, c)
    err = lib.himan_instance_norm_fwd(
        x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), ws[2 * n * c :].data_ptr(),
        n, h * w, c, s, chunk, ACTS[act], eps,
        int(x.dtype == torch.bfloat16), _build.stream_for(x.device),
    )
    _build.check(err, "himan_instance_norm_fwd")
    instance_norm.launches += 1
    return y, mean, rstd


instance_norm.launches = 0


def _lib():
    lib = _build.load("instance_norm")
    fn = lib.himan_instance_norm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return lib

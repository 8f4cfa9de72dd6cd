"""ReflectionPad2d on NHWC with a hand-written backward.

The forward is the plain reflect pad (``F.pad``), as in the JAX package,
where it is ``jnp.pad``. The backward replaces the TPU kernel of
``ops/pallas/reflect_pad.py`` (JAX package): ``reflect_pad_fused_bwd`` ->
``reflect_pad_bwd`` / ``_bwd_kernel``, which folds the mirrored border
strips of the padded cotangent back into the input's gradient.

Bound: bytes (one read of dy, one write of dx). ``csrc/reflect_pad.cu`` is
a gather: one thread per dx element sums the 1-9 dy entries that reflect
onto it, so no atomics are needed and any H, W > pad is taken — the
overlapping-mirror sizes the TPU kernel refused included, so no site needs
a gate. The JAX package gates its kernel off (``ops/pallas/config.py``
``_PAD_BWD_KERNEL = False``), a TPU measurement that does not carry over:
on the card every pad with a gradient (the 18 resblock pads and the head
pad of the generator) folds through this kernel.

``reflect_pad_bwd`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors (or raises).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def reflect_pad_plain(x, pad: int):
    """torch.nn.ReflectionPad2d(pad) on NHWC (no edge repeat), with
    PyTorch's own backward."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def _sources(n: int, pad: int, device):
    """For each padded index, the input index it reflects."""
    i = torch.arange(n + 2 * pad, device=device) - pad
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad_bwd_plain(dy, pad: int):
    """Plain PyTorch version of the backward kernel: fold rows, then
    columns, summing in fp32, one rounding to dy's dtype."""
    b, hp, wp, c = dy.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    f32 = torch.float32
    rows = torch.zeros((b, h, wp, c), dtype=f32, device=dy.device)
    rows.index_add_(1, _sources(h, pad, dy.device), dy.to(f32))
    dx = torch.zeros((b, h, w, c), dtype=f32, device=dy.device)
    dx.index_add_(2, _sources(w, pad, dy.device), rows)
    return dx.to(dy.dtype)


def reflect_pad_bwd(dy, pad: int):
    """dy (N, H+2p, W+2p, C), the cotangent of the padded tensor ->
    dx (N, H, W, C)."""
    if dy.dim() != 4 or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous NHWC, got shape {tuple(dy.shape)}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dy must be float32 or bfloat16, got {dy.dtype}")
    n, hp, wp, c = dy.shape
    h, w = hp - 2 * pad, wp - 2 * pad
    if pad < 1 or h <= pad or w <= pad:
        raise ValueError(f"reflect pad {pad} needs H, W > {pad}, got {h}x{w}")
    if dy.device.type == "cpu":
        return reflect_pad_bwd_plain(dy, pad)
    if dy.device.type != "cuda":
        raise ValueError(f"unsupported device {dy.device}")
    if n * h >= 2**31 or wp * c >= 2**31:
        raise ValueError(f"reflect_pad_bwd grid limits: N*H {n * h}, (W+2p)*C {wp * c} < 2^31")
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    err = _lib().himan_reflect_pad_bwd(
        dy.data_ptr(), dx.data_ptr(), n, h, w, c, pad,
        int(dy.dtype == torch.bfloat16), _build.stream_for(dy.device),
    )
    _build.check(err, "himan_reflect_pad_bwd")
    reflect_pad_bwd.launches += 1
    return dx


reflect_pad_bwd.launches = 0


class _ReflectPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return reflect_pad_plain(x, pad)

    @staticmethod
    def backward(ctx, g):
        return reflect_pad_bwd(g.contiguous(), ctx.pad), None


def reflect_pad(x, pad: int):
    """ReflectionPad2d(pad) on NHWC; its gradient goes through
    ``reflect_pad_bwd``."""
    return _ReflectPad.apply(x, pad)


def _lib():
    lib = _build.load("reflect_pad")
    fn = lib.himan_reflect_pad_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, p]
        fn.restype = i
    return lib

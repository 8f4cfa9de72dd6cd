"""Loss reductions to a scalar: ``mse_to_scalar`` (LSGAN) and
``l1_to_scalar`` (feature matching, VGG).

Replaces the TPU kernels of ``ops/pallas/losses.py`` (JAX package):
``mse_to_scalar`` / ``l1_to_scalar`` -> ``_reduce_call`` (``_sq_kernel``,
``_abs_kernel``): one pass, an fp32 accumulator, the true element count as
the denominator. The port's kernel (``csrc/losses.cu``) takes the two
operands, so no diff tensor is written: ``mse_to_scalar(pred, t)`` is
mean((pred - t)²) for a scalar target t and ``l1_to_scalar(a, b)`` is
mean(|a - b|); the difference is taken in fp32. Per-block partials, then
one small launch: deterministic, no atomics.

Bound: bytes (each element read once). The backward is the closed form,
2(pred - t)/N and sign(a - b)/N, in plain PyTorch, as the JAX package
leaves it to XLA. Every loss term on the card launches the kernel, down to
the ~2.3k-element D logits: the JAX ``diff.size < _CHUNK`` gate was a TPU
tiling limit, and its ``_LOSS_KERNELS = False`` gate a TPU measurement.
A CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MODES = {"mse": 0, "l1": 1}


def _check(a, b):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand must be float32 or bfloat16, got {a.dtype}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype or b.device != a.device):
        raise ValueError("both operands must match in shape, dtype and device")
    if a.numel() == 0:
        raise ValueError("the mean of an empty tensor is undefined")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _reduce_plain(a, b, t, mode):
    d = a.to(torch.float32) - (b.to(torch.float32) if b is not None else t)
    return d.square().mean() if mode == "mse" else d.abs().mean()


def _reduce_kernel(a, b, t, mode):
    """Launch the kernel: -> 0-dim fp32 tensor on a's device."""
    a = a.contiguous()
    b = b.contiguous() if b is not None else None
    n = a.numel()
    lib = _lib()
    part = torch.empty(lib.himan_loss_blocks(n), dtype=torch.float32, device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    err = lib.himan_loss_reduce(
        a.data_ptr(), b.data_ptr() if b is not None else None, float(t), n,
        MODES[mode], part.data_ptr(), out.data_ptr(),
        int(a.dtype == torch.bfloat16), _build.stream_for(a.device),
    )
    _build.check(err, "himan_loss_reduce")
    return out


class _MSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target):
        ctx.target = target
        ctx.save_for_backward(pred)
        if pred.device.type == "cpu":
            return _reduce_plain(pred, None, target, "mse")
        out = _reduce_kernel(pred, None, target, "mse")
        mse_to_scalar.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (pred,) = ctx.saved_tensors
        d = pred.to(torch.float32) - ctx.target
        return ((2.0 * g / pred.numel()) * d).to(pred.dtype), None


class _L1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return _reduce_plain(a, b, 0.0, "l1")
        out = _reduce_kernel(a, b, 0.0, "l1")
        l1_to_scalar.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        s = (g / a.numel()) * torch.sign(a.to(torch.float32) - b.to(torch.float32))
        da = s.to(a.dtype) if ctx.needs_input_grad[0] else None
        db = (-s).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def mse_to_scalar(pred, target: float):
    """mean((pred - target)²) in fp32 for a scalar target (LSGAN)."""
    _check(pred, None)
    return _MSE.apply(pred, float(target))


mse_to_scalar.launches = 0


def l1_to_scalar(a, b):
    """mean(|a - b|) in fp32 (feature matching, VGG perceptual)."""
    _check(a, b)
    return _L1.apply(a, b)


l1_to_scalar.launches = 0


def mse_to_scalar_plain(pred, target: float):
    """Plain PyTorch version, with PyTorch's own backward."""
    return _reduce_plain(pred, None, float(target), "mse")


def l1_to_scalar_plain(a, b):
    """Plain PyTorch version, with PyTorch's own backward."""
    return _reduce_plain(a, b, 0.0, "l1")


def _lib():
    lib = _build.load("losses")
    if lib.himan_loss_reduce.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.himan_loss_blocks.argtypes = [ctypes.c_int64]
        lib.himan_loss_blocks.restype = i
        lib.himan_loss_reduce.argtypes = [p, p, ctypes.c_float, ctypes.c_int64, i, p, p, i, p]
        lib.himan_loss_reduce.restype = i
    return lib

"""The precision the reference computes its convolutions in.

``fp32`` is the reference itself: float32 with TF32 off. The controls are
the step below a configuration's stated precision: ``tf32`` (TF32
convolutions and matmuls) below full fp32, and ``fp8`` below bf16, as fp8
training computes: every convolution's input, weight and output rounded to
float8 e4m3 in the forward and every gradient through them to float8 e5m2
in the backward, each with a per-tensor scale (its amax to the format's
largest value), the products accumulated in fp32. So the activations
between layers, the logits and features the losses read and the gradients
of the backward are fp8 where the bf16 tier holds them in bf16.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "tf32", "fp8")
_mode = ["fp32"]


def _round(x, dtype, largest):
    scale = largest / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def operand(x: torch.Tensor) -> torch.Tensor:
    """A convolution operand as the current mode computes with it."""
    return _RoundFp8.apply(x) if _mode[0] == "fp8" else x


@contextlib.contextmanager
def mode(name: str):
    """Compute the reference in ``name`` inside the block; TF32 off
    except under ``tf32``."""
    if name not in MODES:
        raise ValueError(f"precision mode {name!r}: one of {MODES}")
    prev = (_mode[0], torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _mode[0] = name
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        _mode[0], torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

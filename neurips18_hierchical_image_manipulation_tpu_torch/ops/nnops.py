"""NN primitives with the JAX package's semantics, NHWC activations.

Counterpart of the subset of ``ops/nnops.py`` (JAX package) that the
generators, the Encoder, the multiscale discriminator and VGG19 need.
Weights are in torch's layouts: conv (Cout, Cin, kh, kw), transposed
conv (Cin, Cout, kh, kw). The JAX HWIO kernels map to them by
``transpose(3, 2, 0, 1)`` and ``transpose(2, 3, 0, 1)`` (no spatial
flip) — see ``utils/checkpoint.py``.

The JAX package's TPU layout rewrites (space-to-depth packing, phasepack,
lane padding, the strip-form reflect conv) have no counterpart: the port
matches their values, not their layouts. Convolutions take
``x.permute(0, 3, 1, 2)`` of the contiguous NHWC tensor — a channels_last
NCHW view that ``F.conv2d`` accepts as it is — and return contiguous NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import reflect_pad as _krp

_EPS = 1e-5


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def ids_int32(t):
    """Integer ids as int32. A uint16 plane (``--uint8_transfer`` instance
    ids, up to 65535) goes through its int16 bits, masked back to unsigned:
    the card's kernels do not all take uint16."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def conv2d(x, w, b=None, *, stride=1, padding=0):
    """torch.nn.Conv2d on NHWC x; w (Cout, Cin, kh, kw), zero padding."""
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding))


def conv_transpose2d(x, w, b=None, *, stride=2, padding=1, output_padding=1):
    """torch.nn.ConvTranspose2d on NHWC x; w (Cin, Cout, kh, kw). The
    generator's upsamplers are k3 s2 p1 op1 (exactly 2x)."""
    return _nhwc(
        F.conv_transpose2d(
            _nchw(x), w, b, stride=stride, padding=padding,
            output_padding=output_padding,
        )
    )


def reflect_pad(x, pad: int):
    """torch.nn.ReflectionPad2d(pad) on NHWC (no edge repeat); the backward
    is the reflect-pad kernel (kernels/reflect_pad.py)."""
    return _krp.reflect_pad(x, pad)


def avg_pool_3x3s2(x):
    """torch.nn.AvgPool2d(3, 2, 1, count_include_pad=False) on NHWC — the
    multiscale discriminator's inter-scale downsampler."""
    return _nhwc(F.avg_pool2d(_nchw(x), 3, 2, 1, count_include_pad=False))


def max_pool_2x2(x):
    """torch.nn.MaxPool2d(2, 2) on NHWC (VGG19); the backward routes a
    tied window's gradient to its first maximum in scan order, as the JAX
    package's does."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def instance_norm_stats(x, eps=_EPS):
    """fp32 per-(N,C) mean and rstd over (H, W), keepdims: torch's two-pass
    form (mean, then mean of squared deviations), biased variance, eps
    inside the sqrt — the JAX package's parity-tier IN statistics."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    return mean, torch.rsqrt(var + eps)


def apply_act(y, act: str):
    if act == "relu":
        return relu(y)
    if act == "lrelu":
        return leaky_relu(y, 0.2)
    if act != "none":
        raise ValueError(f"unsupported act: {act}")
    return y


def normalize_act(x, mean, rstd, act="none", residual=None):
    """act((x - mean) * rstd [+ residual]) in fp32, one rounding to x's
    dtype at the end — the arithmetic of the fused IN kernel."""
    y = (x.to(torch.float32) - mean) * rstd
    if residual is not None:
        y = y + residual.to(torch.float32)
    return apply_act(y, act).to(x.dtype)


def instance_norm_act(x, act="none", residual=None, *, eps=_EPS):
    """InstanceNorm2d(affine=False) [+ residual], then ``act``."""
    mean, rstd = instance_norm_stats(x, eps)
    return normalize_act(x, mean, rstd, act, residual)


def instance_norm(x, *, eps=_EPS):
    """torch.nn.InstanceNorm2d(affine=False) on NHWC, fp32 statistics."""
    return instance_norm_act(x, "none", eps=eps)


def batch_norm(x, scale=None, bias=None, *, eps=_EPS):
    """torch.nn.BatchNorm2d(affine=True) in TRAIN mode on NHWC: batch
    statistics over (N,H,W) always (pix2pixHD never calls .eval(), so they
    govern its inference too), biased variance, fp32 statistics."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(0, 1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(0, 1, 2), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def leaky_relu(x, negative_slope=0.2):
    return torch.where(x >= 0, x, x * negative_slope)


def relu(x):
    return torch.clamp_min(x, 0)


def segment_mean_2d(feat, seg_ids, num_segments: int):
    """Instance-wise average pooling (the pix2pixHD Encoder's; JAX
    ``nnops.segment_mean_2d``): feat (N,H,W,C), seg_ids (N,H,W) ints in
    [0, num_segments) -> (N,H,W,C), every pixel the mean of its segment in
    its image. Sums and counts accumulate in fp32 whatever feat's dtype (a
    bf16 running sum stalls at 256), one rounding to feat's dtype at the
    end. Differentiable. The sums are ``index_put(accumulate=True)`` and the
    gather back is indexing of the rounded means, whose backward is the same
    accumulation in feat's dtype (the JAX function's gradient sums in it
    too, so a bf16 gradient carries its running-sum rounding): on a CUDA tensor
    both take PyTorch's sort-based accumulation, a fixed order (no atomics),
    so the result and its gradient are the same bits run to run."""
    n, h, w, c = feat.shape
    ids = seg_ids.reshape(n, h * w).to(torch.int64)
    ids = (ids + num_segments * torch.arange(n, device=ids.device)[:, None]).reshape(-1)
    f32 = feat.reshape(n * h * w, c).to(torch.float32)
    sums = f32.new_zeros((n * num_segments, c)).index_put((ids,), f32, accumulate=True)
    counts = f32.new_zeros((n * num_segments,)).index_put(
        (ids,), f32.new_ones((n * h * w,)), accumulate=True)
    means = (sums / torch.clamp_min(counts, 1.0)[:, None]).to(feat.dtype)
    return means[ids].reshape(n, h, w, c)


class PaddedStemInput:
    """Marker: the generator input already reflect-padded by 3, so the
    stem conv runs VALID with no pad of its own. Counterpart of the JAX
    package's ``nnops.PackedStemInput`` (which is also space-to-depth
    packed; the port's stem is not)."""

    def __init__(self, padded: torch.Tensor):
        self.padded = padded

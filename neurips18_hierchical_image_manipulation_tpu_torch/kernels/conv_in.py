"""Fused reflect-pad-1 3x3 conv + InstanceNorm (+ residual) (+ ReLU), NHWC:
``y = relu?(IN(conv3x3(reflect_pad(x, 1), w3x3) + b) + residual?)``.

Replaces the TPU kernel of ``ops/pallas/conv_in.py`` (JAX package):
``conv3x3_in_act`` -> ``_fused`` -> ``_run`` / ``_kernel``, at the same
public signature and in the same layouts (x NHWC, ``w3x3`` HWIO
``(3, 3, Cin, Cout)``, ``b`` ``(Cout,)``). The conv accumulates in fp32, b
is added before the statistics, IN takes eps 1e-5 and the biased variance
from the fp32 sums, and y is written once in x's dtype.

Bound: operations (9.66 GFLOP a call at the generator bottleneck, bs 1,
16x32x1024; 309 GFLOP at the roofline tool's bs 32). ``csrc/conv_in.cu``
runs the conv as an implicit GEMM, one of three hand-written kernels that
``_plan`` picks by shape: bf16 calls that fill the card take the Hopper
kernel (TMA ring, ``wgmma``, the IN statistics merged across a thread-block
cluster that holds the plane, one write of y); other bf16 calls the
``mma.sync`` kernel, whose per-tile IN statistics a second launch merges
while it normalizes; fp32 calls the FMA kernel (a ``cp.async`` ring, K
split where the tiles alone do not fill the card, the splits summed and
the statistics merged by the launches after it) — see the source.
``conv3x3_in_act.variants`` counts the calls of each. The TPU kernel's
gates (Cout % 128, a 10 MB VMEM plan) have no counterpart: every shape
with H, W > 1 is served. The JAX ``use_pallas=False`` is the caller asking
for ``conv3x3_in_act_plain`` by name.

Gradient: ``_ConvInAct`` recomputes the plain composition and takes its
autograd gradient, as the JAX ``_fused_bwd`` takes ``jax.vjp`` of
``_reference``; there is no backward kernel. As in the JAX package, no
network of the port calls this op: its path is the resblock roofline tool
(``tools/roofline_resblock.py``). A CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops import nnops
from . import _build

EPS = 1e-5


def conv3x3_in_act_plain(x, w3x3, b, *, relu: bool = False,
                         residual: Optional[torch.Tensor] = None):
    """Plain PyTorch version, the JAX ``_reference``: reflect pad, conv
    (bias in x's dtype), IN, then the residual and ReLU in x's dtype."""
    y = nnops.conv2d(nnops.reflect_pad(x, 1), w3x3.permute(3, 2, 0, 1), b.to(x.dtype))
    y = nnops.instance_norm(y)
    if residual is not None:
        y = y + residual
    return nnops.relu(y) if relu else y


def _check(x, w3x3, b, residual):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, h, w, cin = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"reflect pad 1 needs H, W > 1, got {h}x{w}")
    if w3x3.dim() != 4 or tuple(w3x3.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w3x3 must be HWIO (3, 3, {cin}, Cout), got {tuple(w3x3.shape)}")
    cout = w3x3.shape[3]
    if w3x3.dtype != x.dtype or w3x3.device != x.device:
        raise ValueError("w3x3 must match x in dtype and device")
    if b.shape != (cout,) or b.device != x.device:
        raise ValueError(f"b must be ({cout},) on x's device, got {tuple(b.shape)}")
    if residual is not None and (
        tuple(residual.shape) != (n, h, w, cout) or residual.dtype != x.dtype
        or residual.device != x.device
    ):
        raise ValueError("residual must be (N, H, W, Cout) in x's dtype, on x's device")


_MIN_BLOCKS = 64      # wgmma blocks (one resident per SM): half of an H100's 132
_MAX_CLUSTER = 8      # portable cluster size: the plane's tiles in one cluster
_FMA_MIN_BLOCKS = 128  # fma blocks (one resident per SM) that fill most of the card
_FMA_MAX_SPLIT = 8
_FMA_TILE = (128, 256)  # fma: pixels x output channels of a tile
_FMA_K = 32           # fma: input channels of one tap per K step


def _fma_split(n: int, hw: int, cin: int, cout: int):
    """The fp32 kernel's K split: 1, or the smallest of 2, 4, 8 that brings
    the blocks to ``_FMA_MIN_BLOCKS``, each split whole K steps (at least
    4) of the 9 * ceil(Cin / 32) -> (pixel tiles of a plane, split)."""
    mt = -(-hw // _FMA_TILE[0])
    tiles = n * mt * -(-cout // _FMA_TILE[1])
    steps = 9 * -(-cin // _FMA_K)
    ks = 1
    while (tiles * ks < _FMA_MIN_BLOCKS and 2 * ks <= _FMA_MAX_SPLIT
           and steps % (2 * ks) == 0 and steps // (2 * ks) >= 4):
        ks *= 2
    return mt, ks


@functools.lru_cache(maxsize=1024)
def _plan(n: int, h: int, w: int, cin: int, cout: int, dtype) -> dict:
    """Which hand-written kernel serves an (n, h, w, cin) -> cout call.

    ``variant``: "fma" (fp32: the parity tier, no TF32); "wgmma" (bf16, Cin
    and Cout multiples of 8, whose tiles of 256 output channels make at
    least ``_MIN_BLOCKS`` blocks); "mma" (bf16 otherwise:
    the ``mma.sync`` kernel, which serves bs 1 and any channel count).
    ``tile``: (rows, columns) of the image a "wgmma" block owns: whole rows
    of up to 128 pixels (``128 // w`` rows of ``w`` columns, at most H, or
    128 columns of one row when w > 128); else None, and ``pixels`` of the
    flattened H*W (64 "mma", 128 "fma").
    ``tiles``: pixel tiles over one sample's plane. ``k_split`` ("fma"):
    blocks that share a tile's K steps. ``cluster``: blocks of a
    thread-block cluster: "wgmma" the plane's tiles (<= 8) or 1; "fma" 1.
    ``launches``: 1 when a cluster (or one unsplit block) holds the plane;
    else 2 (the conv, then the merge of the statistics and the
    normalization), 3 for an "fma" K split (the conv's partial sums, their
    sum with the slices' statistics, the normalization).
    """
    hw = h * w
    plan = {"variant": "mma", "tile": (None, None), "pixels": 64, "tiles": -(-hw // 64),
            "k_split": 1, "cluster": 1, "launches": 2}
    if dtype == torch.float32:
        mt, ks = _fma_split(n, hw, cin, cout)
        return dict(plan, variant="fma", pixels=_FMA_TILE[0], tiles=mt, k_split=ks,
                    launches=3 if ks > 1 else 1 if mt == 1 else 2)
    if cin % 8 == 0 and cout % 8 == 0:
        wt = min(w, 128)
        rb = min(128 // wt, h)
        tiles = -(-h // rb) * -(-w // wt)
        if n * tiles * -(-cout // 256) >= _MIN_BLOCKS:
            cluster = tiles if tiles <= _MAX_CLUSTER else 1
            return dict(plan, variant="wgmma", tile=(rb, wt), pixels=None, tiles=tiles,
                        cluster=cluster, launches=1 if cluster > 1 else 2)
    return plan


_VARIANT_ID = {"fma": 0, "mma": 1, "wgmma": 2}


def _launch(x, w3x3, b, residual, relu):
    """The kernel on a CUDA tensor: -> y in x's dtype."""
    n, h, w, cin = x.shape
    cout = w3x3.shape[3]
    if n > 65535 or -(-cout // 64) > 65535:
        raise ValueError(f"conv3x3_in_act grid limits: N {n}, Cout {cout}")
    lib = _lib()
    plan = _plan(n, h, w, cin, cout, x.dtype)
    variant, (rb, wt) = _VARIANT_ID[plan["variant"]], plan["tile"]
    rb, wt, ks, cl = rb or 0, wt or 0, plan["k_split"], plan["cluster"]
    w3x3 = w3x3.contiguous()
    bias = b.to(torch.float32).contiguous()
    res = residual.contiguous() if residual is not None else None
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    ws = torch.empty(lib.himan_conv_in_workspace(n, h, w, cin, cout, variant, wt, rb, ks, cl),
                     dtype=torch.uint8, device=x.device)
    err = lib.himan_conv3x3_in_act(
        x.data_ptr(), w3x3.data_ptr(), bias.data_ptr(),
        res.data_ptr() if res is not None else None, y.data_ptr(), ws.data_ptr(),
        n, h, w, cin, cout, int(relu), EPS, variant, wt, rb, ks, cl,
        _build.stream_for(x.device),
    )
    _build.check(err, "himan_conv3x3_in_act")
    conv3x3_in_act.launches += 1
    conv3x3_in_act.variants[plan["variant"]] += 1
    return y


class _ConvInAct(torch.autograd.Function):
    """Forward: the kernel (the plain version for CPU tensors). Backward:
    the plain composition recomputed, then its autograd gradient."""

    @staticmethod
    def forward(ctx, x, w3x3, b, residual, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w3x3, b, residual)
        if x.device.type == "cpu":
            return conv3x3_in_act_plain(x, w3x3, b, relu=relu, residual=residual)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(x, w3x3, b, residual, relu)

    @staticmethod
    def backward(ctx, g):
        x, w3x3, b, residual = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, w3x3, b, residual), ctx.needs_input_grad)]
        with torch.enable_grad():
            y = conv3x3_in_act_plain(inputs[0], inputs[1], inputs[2], relu=ctx.relu,
                                     residual=inputs[3])
            wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
            grads = iter(torch.autograd.grad(y, wanted, g)) if wanted else iter(())
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad[:4]) + (None,)


def conv3x3_in_act(x, w3x3, b, *, relu: bool = False,
                   residual: Optional[torch.Tensor] = None):
    """NHWC fused reflect-pad-1 conv3x3 + IN (+ residual) (+ ReLU),
    differentiable; the kernel for a CUDA tensor, the plain version for a
    CPU one."""
    _check(x, w3x3, b, residual)
    return _ConvInAct.apply(x, w3x3, b, residual, bool(relu))


conv3x3_in_act.launches = 0
conv3x3_in_act.variants = {"fma": 0, "mma": 0, "wgmma": 0}


def _lib():
    lib = _build.load("conv_in")
    fn = lib.himan_conv3x3_in_act
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.himan_conv_in_workspace.argtypes = [i] * 10
        lib.himan_conv_in_workspace.restype = ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, i, p]
        fn.restype = i
    return lib

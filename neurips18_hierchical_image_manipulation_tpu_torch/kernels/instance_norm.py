"""InstanceNorm(affine=False) forward, fused with an optional residual add
and an optional activation: ``y = act(IN(x) + residual)``, NHWC.

Replaces the forward TPU kernel of ``ops/pallas/instance_norm.py`` (JAX
package): ``fused_instance_norm`` -> ``_run_fwd`` / ``_fwd_kernel``. eps
1e-5 inside the sqrt, biased variance, fp32 statistics, IO in x's dtype;
also returns the per-(n, c) mean and rstd (fp32, (N, C)) for a backward.

Bound: bytes (a few operations per byte). The TPU kernel carries its sums
across a sequential grid axis; blocks on this card run in parallel. So
``_fwd_plan`` picks, by shape, one launch in which a thread-block cluster
holds the (sample, 32-channel) plane of x in shared memory (read once,
exact two-pass statistics exchanged through distributed shared memory in
rank order), or, for planes too large for 16 blocks and channel counts off
the 16-byte vectors, a two-launch split form (Chan partials, then each
block merges them itself and normalizes) — see ``csrc/instance_norm.cu``.
No atomics, every sum in a fixed order; ``instance_norm.variants`` counts
the launches of each.

Backward: ``instance_norm_bwd`` replaces ``_run_bwd`` / ``_bwd_kernel``
of the same file: dx = (gm - mean(gm) - x̂·mean(gm·x̂))·rstd with gm the
cotangent after the activation's mask (relu y > 0; lrelu 1 where y >= 0,
else 0.2, as ``nnops.leaky_relu``'s ``where(x >= 0, ...)``), and the
residual's gradient gm itself. ``_bwd_plan`` picks, by shape, one launch in
which a thread-block cluster holds the (sample, channel tile) plane in
shared memory and merges its blocks' sums through distributed shared memory,
or, for planes too large for 16 blocks, a two-launch split form; fp32 sums in
a fixed order, no atomics (deterministic); ``instance_norm_bwd.variants``
counts the launches of each. ``instance_norm_act`` is the differentiable
entry point: an ``autograd.Function`` whose forward is the forward kernel
and whose backward is this one; ``instance_norm_act_plain`` is plain
autograd through the plain version.

The JAX package gates its IN kernel off (``ops/pallas/config.py``
``_IN_KERNEL = False``); that was a TPU measurement and does not carry
over: on the card every IN site of the generator and the discriminator
goes through these kernels, forward and backward. A CPU tensor takes the
plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops import nnops
from . import _build

EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "lrelu": 2}
_BLOCKS = 2 * 132          # two 256-thread blocks per SM of an H100
_SLAB = 196_608            # shared memory a cluster block stages its rows in,
                           # at most (csrc/instance_norm.cu kSlab)
_FWD_SLAB = 98_304         # the forward's: a larger slab a block was slower
                           # than a larger cluster or the split form on H100
_MAX_CLUSTER = 16          # non-portable cluster size limit on Hopper


def instance_norm_plain(x, act="none", residual=None, eps=EPS):
    """Plain PyTorch version: two-pass fp32 statistics, the same epilogue."""
    n, _, _, c = x.shape
    mean, rstd = nnops.instance_norm_stats(x, eps)
    y = nnops.normalize_act(x, mean, rstd, act, residual)
    return y, mean.reshape(n, c), rstd.reshape(n, c)


def _plan(n: int, h: int, w: int, c: int, dtype, slab: int, grow: int) -> dict:
    """The launch plan of an (n, h, w, c) site for a kernel pair whose
    cluster form stages ``slab`` bytes of a block's rows in shared memory.

    ``variant`` "cluster": one launch, the (sample, 32-channel) plane held by
    the ``cluster`` blocks of one thread-block cluster, ``chunk`` rows each,
    in shared memory (16-byte rows: c a multiple of 4 fp32 / 8 bf16
    channels). The cluster is the smallest that holds the plane, grown (up
    to ``grow``) while the grid is short of ``_BLOCKS`` and each block keeps
    a full pass of its row lanes.
    ``variant`` "split": two launches over ``splits`` blocks of ``chunk``
    rows (a multiple of the row lanes) per (sample, channel tile), about
    ``_BLOCKS`` blocks in all, each at least 4 passes of its row lanes.
    """
    hw, item = h * w, torch.empty((), dtype=dtype).element_size()
    vec = 16 // item
    lanes = 256 // (32 // vec)          # row lanes of a block: 32 fp32, 64 bf16
    tiles = n * -(-c // 32)
    max_rows = slab // (32 * item)
    cs = -(-hw // max_rows)
    if c % vec or cs > _MAX_CLUSTER:
        s = max(1, min(-(-_BLOCKS // tiles), hw // (4 * lanes)))
        rows = -(-hw // s)
        chunk = -(-rows // lanes) * lanes
        return {"variant": "split", "cluster": 1, "splits": -(-hw // chunk), "chunk": chunk}
    while cs < grow and tiles * cs < _BLOCKS and -(-hw // (cs + 1)) >= lanes:
        cs += 1
    chunk = -(-hw // cs)
    return {"variant": "cluster", "cluster": -(-hw // chunk), "splits": -(-hw // chunk),
            "chunk": chunk}


@functools.lru_cache(maxsize=1024)
def _fwd_plan(n: int, h: int, w: int, c: int, dtype) -> dict:
    """The forward kernel's launch plan (``_plan``): its cluster form stages
    x alone, up to 768 rows a block in fp32, 1536 in bf16, in clusters of up
    to 16."""
    return _plan(n, h, w, c, dtype, _FWD_SLAB, _MAX_CLUSTER)


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
    """NHWC -> (y, mean, rstd): y = act(IN(x) + residual) in x's dtype.
    While ``torch.export`` traces, the call is the ``himan::instance_norm``
    op (``kernels/ops.py``), whose implementation is this function."""
    if torch.compiler.is_exporting():
        from . import ops

        return ops.instance_norm(x, act, residual, eps)
    _check(x, act, residual)
    if x.device.type == "cpu":
        return instance_norm_plain(x, act, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    if n > 65535 or h * w * c >= 2**30:
        raise ValueError(f"instance_norm grid limits: N {n} <= 65535, H*W*C {h * w * c} < 2^30")
    lib = _lib()
    plan = _fwd_plan(n, h, w, c, x.dtype)
    split = plan["variant"] == "split"
    # y, and one fp32 tensor of mean, rstd and the split form's (2, n,
    # splits, c) partials (two allocations cost the host less than views
    # of one)
    y = torch.empty_like(x)
    ws = torch.empty((2 + 2 * plan["splits"] * split, n, c), dtype=torch.float32,
                     device=x.device)
    mean, rstd = ws[0], ws[1]
    err = lib.himan_instance_norm_fwd(
        x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        ws.data_ptr() + 8 * n * c if split else None,
        n, h * w, c, plan["splits"], plan["chunk"], ACTS[act], eps, int(not split),
        int(x.dtype == torch.bfloat16), _build.stream_for(x.device),
    )
    _build.check(err, "himan_instance_norm_fwd")
    instance_norm.launches += 1
    instance_norm.variants[plan["variant"]] += 1
    return y, mean, rstd


instance_norm.launches = 0
instance_norm.variants = {"cluster": 0, "split": 0}


def _mask(g, y, act):
    """The cotangent of the activation's input, from its output y."""
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    if act == "lrelu":
        return torch.where(y >= 0, g, g * 0.2)
    return g


def instance_norm_bwd_plain(x, y, g, mean, rstd, act="none", want_dres=False):
    """Plain PyTorch version of the backward kernel, the same fp32 closed
    form: -> (dx, dres or None) in x's dtype."""
    n, _, _, c = x.shape
    gm = _mask(g.to(torch.float32), y.to(torch.float32) if y is not None else None, act)
    mu, rs = mean.reshape(n, 1, 1, c), rstd.reshape(n, 1, 1, c)
    xh = (x.to(torch.float32) - mu) * rs
    mg = gm.mean(dim=(1, 2), keepdim=True)
    mgx = (gm * xh).mean(dim=(1, 2), keepdim=True)
    dx = ((gm - mg - xh * mgx) * rs).to(x.dtype)
    return dx, (gm.to(x.dtype) if want_dres else None)


@functools.lru_cache(maxsize=1024)
def _bwd_plan(n: int, h: int, w: int, c: int, dtype) -> dict:
    """The backward kernel's launch plan (``_plan``): its cluster form
    stages x, g and y, in clusters grown up to 8 (the portable size)."""
    return _plan(n, h, w, c, dtype, _SLAB // 3, 8)


def instance_norm_bwd(x, y, g, mean, rstd, act: str = "none", want_dres: bool = False):
    """Backward of ``instance_norm``: x, y (its output; unused and may be
    None for act 'none'), g (the cotangent of y), mean, rstd (its fp32
    (N, C) statistics) -> (dx, dres): dres, the residual's gradient, only
    when ``want_dres``."""
    _check(x, act, None)
    n, h, w, c = x.shape
    for name, t in (("g", g), ("y", y)):
        if t is None and name == "y" and act == "none":
            continue
        if t is None or t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must match x in shape, dtype, device and layout")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, c) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 (N, C)")
    if x.device.type == "cpu":
        return instance_norm_bwd_plain(x, y, g, mean, rstd, act, want_dres)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if n > 65535 or h * w * c >= 2**30:
        raise ValueError(f"instance_norm grid limits: N {n} <= 65535, H*W*C {h * w * c} < 2^30")
    lib = _lib()
    plan = _bwd_plan(n, h, w, c, x.dtype)
    split = plan["variant"] == "split"
    # one allocation of x's shape a slot: dx, dres, then the split form's
    # fp32 partials, 2 n splits c floats (one slot but at tiny H*W)
    scratch = -(-8 * plan["splits"] // (h * w * x.element_size())) if split else 0
    buf = torch.empty((1 + int(want_dres) + scratch, n, h, w, c), dtype=x.dtype,
                      device=x.device)
    dx = buf[0]
    dres = buf[1] if want_dres else None
    ws = buf[1 + int(want_dres)].data_ptr() if split else None
    err = lib.himan_instance_norm_bwd(
        x.data_ptr(), y.data_ptr() if act != "none" else None, g.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dres.data_ptr() if want_dres else None, ws,
        n, h * w, c, plan["splits"], plan["chunk"], ACTS[act], int(not split),
        int(x.dtype == torch.bfloat16), _build.stream_for(x.device),
    )
    _build.check(err, "himan_instance_norm_bwd")
    instance_norm_bwd.launches += 1
    instance_norm_bwd.variants[plan["variant"]] += 1
    return dx, dres


instance_norm_bwd.launches = 0
instance_norm_bwd.variants = {"cluster": 0, "split": 0}


class _InstanceNormAct(torch.autograd.Function):
    """Forward: the forward kernel. Backward: the backward kernel. The
    residual's gradient is the masked cotangent (g itself for act 'none')."""

    @staticmethod
    def forward(ctx, x, residual, act):
        y, mean, rstd = instance_norm(x, act, residual)
        ctx.act, ctx.has_res = act, residual is not None
        ctx.save_for_backward(x, y, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, mean, rstd = ctx.saved_tensors
        act, need_x = ctx.act, ctx.needs_input_grad[0]
        need_res = ctx.has_res and ctx.needs_input_grad[1]
        g = g.contiguous()
        if not need_x:
            return None, (_mask(g, y, act) if need_res else None), None
        dx, dres = instance_norm_bwd(
            x, y, g, mean, rstd, act, want_dres=need_res and act != "none"
        )
        if need_res and act == "none":
            dres = g
        return dx, dres, None


def instance_norm_act(x, act: str = "none", residual: Optional[torch.Tensor] = None):
    """Differentiable ``act(IN(x) + residual)`` through the kernels (the
    plain versions for CPU tensors). An exported program is inference
    only: it holds the forward op."""
    if torch.compiler.is_exporting():
        return instance_norm(x, act, residual)[0]
    return _InstanceNormAct.apply(x, residual, act)


def instance_norm_act_plain(x, act: str = "none", residual: Optional[torch.Tensor] = None):
    """Plain PyTorch version: autograd through ``instance_norm_plain``."""
    return instance_norm_plain(x, act, residual)[0]


def _lib():
    lib = _build.load("instance_norm")
    fn = lib.himan_instance_norm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
        bwd = lib.himan_instance_norm_bwd
        bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        bwd.restype = i
    return lib

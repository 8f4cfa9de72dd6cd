"""ReflectionPad2d on NHWC with a hand-written backward.

The forward is the plain reflect pad (``F.pad``), as in the JAX package,
where it is ``jnp.pad``. The backward replaces the TPU kernel of
``ops/pallas/reflect_pad.py`` (JAX package): ``reflect_pad_fused_bwd`` ->
``reflect_pad_bwd`` / ``_bwd_kernel``, which folds the mirrored border
strips of the padded cotangent back into the input's gradient.

Bound: bytes (one read of dy, one write of dx). ``_plan`` picks, by
shape, one of two forms of ``csrc/reflect_pad.cu``: "bulk" (C * itemsize a
multiple of 16 bytes: every pad of the networks), where a persistent grid
moves each dx row tile's contiguous source segments into a 3-stage
shared-memory ring with 1-D TMA bulk copies, folds the mirrors there and
writes the tile back with a bulk store; or "gather", one thread per dx
element summing the 1-9 dy entries that reflect onto it.
``reflect_pad_bwd.variants`` counts the launches of each. Both sum in fp32
in the plain version's order, with no atomics, and take any H, W > pad —
the overlapping-mirror sizes the TPU kernel refused included, so no site
needs a gate. The JAX package gates its kernel off
(``ops/pallas/config.py`` ``_PAD_BWD_KERNEL = False``), a TPU measurement
that does not carry over: on the card every pad with a gradient (the 18
resblock pads and the head pad of the generator) folds through this
kernel.

``reflect_pad_bwd`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors (or raises).
"""

from __future__ import annotations

import ctypes
import functools

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


_STAGES = 3            # the bulk form's ring (csrc/reflect_pad.cu kStages)
_SMEM = 204_800        # its shared memory a block, at most (kSmem)
_BARS = 128            # bytes of mbarriers before the stages (kBars)
_SM_SMEM = 233_472     # shared memory of an H100 SM
_SMS = 132
_ITEMS = 2 * _SMS      # work items wanted, at least, where the rows allow


@functools.lru_cache(maxsize=1024)
def _plan(n: int, h: int, w: int, c: int, pad: int, dtype) -> dict:
    """The backward kernel's launch plan for dy of (n, h + 2 pad, w + 2
    pad, c).

    ``variant`` "bulk" (16-byte pixels): the work items are the ``tiles``
    tiles of ``tile`` pixels of each of the n * h dx rows, walked by
    ``blocks`` persistent blocks of ``smem`` bytes (``_SMS`` times as many
    as fit an SM). A tile's source segments (its pixels, extended to the
    row's edge on the first and last tile; up to 3 source rows) and the
    output tile fit a stage of the ring: 3 (tile + 2 pad) + tile pixels. The tile is the largest that fits and leaves at least
    ``_ITEMS`` items where the rows allow, such that the left mirror
    targets (columns 1..pad) fall in the first tile and the right ones
    (w-1-pad..w-2) in the last: a tile of more than ``pad`` pixels and a
    last tile of more than ``pad`` (or one tile).
    ``variant`` "gather": C * itemsize not a multiple of 16, or a pixel too
    large for a stage.
    """
    px = c * torch.empty((), dtype=dtype).element_size()
    gather = {"variant": "gather", "tile": 0, "tiles": 0, "blocks": 0, "smem": 0}
    if px % 16:
        return gather
    fit = ((_SMEM - _BARS) // _STAGES // px - 6 * pad) // 4
    want = -(-w // -(-_ITEMS // (n * h)))
    top = min(w, fit, max(want, pad + 1))
    tp = next((t for t in range(top, pad, -1) if w % t == 0 or w % t > pad),
              w if w <= fit else 0)
    if tp == 0:
        return gather
    tiles = -(-w // tp)
    smem = _BARS + _STAGES * (4 * tp + 6 * pad) * px
    blocks = min(n * h * tiles, _SMS * max(1, _SM_SMEM // (smem + 1024)))
    return {"variant": "bulk", "tile": tp, "tiles": tiles, "blocks": blocks, "smem": smem}


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
    plan = _plan(n, h, w, c, pad, dy.dtype)
    if n * h * max(1, plan["tiles"]) >= 2**31 or wp * c >= 2**31:
        raise ValueError(f"reflect_pad_bwd grid limits: N*H {n * h}, (W+2p)*C {wp * c} < 2^31")
    if plan["variant"] == "bulk" and dy.data_ptr() % 16:
        raise ValueError("reflect_pad_bwd: dy must be 16-byte aligned for the bulk copies")
    dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    err = _lib().himan_reflect_pad_bwd(
        dy.data_ptr(), dx.data_ptr(), n, h, w, c, pad, plan["tile"], plan["blocks"],
        int(dy.dtype == torch.bfloat16), _build.stream_for(dy.device),
    )
    _build.check(err, "himan_reflect_pad_bwd")
    reflect_pad_bwd.launches += 1
    reflect_pad_bwd.variants[plan["variant"]] += 1
    return dx


reflect_pad_bwd.launches = 0
reflect_pad_bwd.variants = {"bulk": 0, "gather": 0}


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
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    return lib

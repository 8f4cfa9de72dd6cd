"""ReflectionPad2d on NHWC, a hand-written kernel each way.

The forward, ``reflect_pad_fwd``, replaces no TPU kernel: the JAX package
pads with ``jnp.pad``, which XLA fuses. Its plain version,
``reflect_pad_plain`` (``F.pad`` on the channels_last view), takes three
passes on the card: aten's reflection pad makes its input contiguous NCHW,
pads in NCHW, and the result is copied back to NHWC. The kernel is one NHWC
pass, bound by bytes (one read of x, one write of y), with 16-byte vectors
on both sides. ``_fwd_plan`` picks, from the pixel's byte width and x's
alignment, one of two forms of ``csrc/reflect_pad.cu``: "wide" (C *
itemsize a multiple of 16 and x 16-byte aligned: every resblock and head
pad), a whole number of vectors a pixel, each copied from its source
pixel; or "narrow" (the 39- and 36-channel stems, or a misaligned x), the
flat output's aligned 16-byte chunks, each shifted into place from the
one or two aligned source vectors that hold its bytes, the mirrors' and
the rows' edge chunks gathered element by element. It is a copy: the bits
are the plain version's. ``reflect_pad_fwd.variants`` counts the launches
of each.

The backward replaces the TPU kernel of ``ops/pallas/reflect_pad.py``
(JAX package): ``reflect_pad_fused_bwd`` -> ``reflect_pad_bwd`` /
``_bwd_kernel``, which folds the mirrored border strips of the padded
cotangent back into the input's gradient.

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

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises).
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


def _check(t, what: str):
    """The shape of t, which a kernel takes: contiguous NHWC, fp32 or bf16,
    on the CPU or a CUDA card."""
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous NHWC, got shape {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.shape


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


_FWD_ITEM = 16384      # output bytes of a forward item, at most: 256 threads x 4 vectors


@functools.lru_cache(maxsize=1024)
def _fwd_plan(n: int, h: int, w: int, c: int, pad: int, dtype, aligned: bool = True) -> dict:
    """The forward kernel's launch plan for x of (n, h, w, c), 16-byte
    aligned or not.

    ``variant`` "wide" (C * itemsize a multiple of 16 and x aligned): the
    unit is a pixel. "narrow" (any other): the unit is a 16-byte chunk of
    the flat output, an output row owning those that start in it (at most
    ceil(row bytes / 16)). The work items are the n (h + 2 pad) output rows
    times ``tiles`` tiles of ``tile`` units each: at most ``_FWD_ITEM``
    output bytes an item, and at least ``_ITEMS`` items where the row's
    units allow, the units split evenly among a row's tiles."""
    item = torch.empty((), dtype=dtype).element_size()
    px, rows, wp = c * item, n * (h + 2 * pad), w + 2 * pad
    wide = px % 16 == 0 and aligned
    unit, units = (px, wp) if wide else (16, -(-wp * px // 16))
    tiles = max(-(-units // max(1, _FWD_ITEM // unit)), -(-_ITEMS // rows))
    tiles = min(tiles, units)
    tile = -(-units // tiles)
    tiles = -(-units // tile)
    return {"variant": "wide" if wide else "narrow", "tile": tile, "tiles": tiles,
            "items": rows * tiles}


def reflect_pad_fwd(x, pad: int):
    """x (N, H, W, C) -> y (N, H+2p, W+2p, C), ReflectionPad2d(pad)."""
    n, h, w, c = _check(x, "x")
    if pad < 1 or h <= pad or w <= pad:
        raise ValueError(f"reflect pad {pad} needs H, W > {pad}, got {h}x{w}")
    if x.device.type == "cpu":
        return reflect_pad_plain(x, pad)
    plan = _fwd_plan(n, h, w, c, pad, x.dtype, x.data_ptr() % 16 == 0)
    if plan["items"] >= 2**31 or (w + 2 * pad) * c * x.element_size() >= 2**30:
        raise ValueError(f"reflect_pad_fwd grid limits: {plan['items']} items < 2^31, "
                         f"(W+2p)*C*itemsize {(w + 2 * pad) * c * x.element_size()} < 2^30")
    y = torch.empty((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = _lib().himan_reflect_pad_fwd(
        x.data_ptr(), y.data_ptr(), n, h, w, c, pad, int(plan["variant"] == "wide"),
        plan["tile"], plan["tiles"], int(x.dtype == torch.bfloat16), _build.stream_for(x.device),
    )
    _build.check(err, "himan_reflect_pad_fwd")
    reflect_pad_fwd.launches += 1
    reflect_pad_fwd.variants[plan["variant"]] += 1
    return y


reflect_pad_fwd.launches = 0
reflect_pad_fwd.variants = {"wide": 0, "narrow": 0}


def reflect_pad_bwd(dy, pad: int):
    """dy (N, H+2p, W+2p, C), the cotangent of the padded tensor ->
    dx (N, H, W, C)."""
    n, hp, wp, c = _check(dy, "dy")
    h, w = hp - 2 * pad, wp - 2 * pad
    if pad < 1 or h <= pad or w <= pad:
        raise ValueError(f"reflect pad {pad} needs H, W > {pad}, got {h}x{w}")
    if dy.device.type == "cpu":
        return reflect_pad_bwd_plain(dy, pad)
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
        return reflect_pad_fwd(x.contiguous(), pad)

    @staticmethod
    def backward(ctx, g):
        return reflect_pad_bwd(g.contiguous(), ctx.pad), None


def reflect_pad(x, pad: int):
    """ReflectionPad2d(pad) on NHWC through ``reflect_pad_fwd``; its
    gradient goes through ``reflect_pad_bwd``. While ``torch.export``
    traces, the call is the ``himan::reflect_pad`` op (``kernels/ops.py``),
    whose implementation is ``reflect_pad_fwd``: an exported program is
    inference only."""
    if torch.compiler.is_exporting():
        from . import ops

        return ops.reflect_pad(x.contiguous(), pad)
    return _ReflectPad.apply(x, pad)


def _lib():
    lib = _build.load("reflect_pad")
    if lib.himan_reflect_pad_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.himan_reflect_pad_bwd.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        lib.himan_reflect_pad_fwd.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p]
        lib.himan_reflect_pad_bwd.restype = lib.himan_reflect_pad_fwd.restype = i
    return lib

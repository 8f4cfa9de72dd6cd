"""The least time one H100 could take for the work of each port kernel:
the bytes the function must move (each input read once, each output
written once) over the card's memory rate, and its operations over the
peak rate of their type, the larger of the two (NVIDIA's data sheet, SXM
part, dense rates).

``chip_smoke.py`` bounds its kernel rows with these, and the measurement
tools (``tools/roofline_step.py``, ``tools/byte_ledger.py``) count the port
kernels' bytes of a step with them: a kernel launched through ``ctypes`` is
no aten op, so a ``TorchDispatchMode`` never sees its traffic.
``call_bytes`` gives the bytes of one wrapper call from its arguments.
"""

from __future__ import annotations

import torch

from . import losses as klosses

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense


def encode_bytes(b, h, w, nc, pad, itemsize):
    c = nc + 1 + 3
    read = b * h * w * (4 + 4 + 3 * itemsize) + b * 16
    write = b * (h + 2 * pad) * (w + 2 * pad) * c * itemsize
    return read + write, b * (h + 2 * pad) * (w + 2 * pad) * c


def in_bytes(n, hw, c, itemsize, residual):
    elems = n * hw * c
    return elems * itemsize * (2 + int(residual)) + 2 * n * c * 4, 8 * elems


def bound(bytes_, ops, ops_per_s=FP32_OPS_PER_S):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def in_bwd_bytes(shape, itemsize, act, want_dres):
    """x, g (and y for a masked act) read once, dx (and dres) written once,
    the fp32 mean/rstd read; ~12 operations an element."""
    n, h, w, c = shape
    elems = n * h * w * c
    return elems * itemsize * (3 + int(act != "none") + int(want_dres)) + 2 * n * c * 4, 12 * elems


def pad_fwd_bytes(x_shape, pad, itemsize):
    """x read once, the padded y written once; no operations."""
    n, h, w, c = x_shape
    return (n * h * w + n * (h + 2 * pad) * (w + 2 * pad)) * c * itemsize, 0


def pad_bwd_bytes(dy_shape, pad, itemsize):
    n, hp, wp, c = dy_shape
    dy = n * hp * wp * c
    dx = n * (hp - 2 * pad) * (wp - 2 * pad) * c
    return (dy + dx) * itemsize, dy


def loss_bytes(numel, itemsize, two_operands):
    return numel * itemsize * (1 + int(two_operands)), 3 * numel


def loss_bwd_bytes(numel, itemsize, two_operands, gradients):
    """a (and b) read once, each of the term's ``gradients`` written once;
    ~4 operations an element."""
    return numel * itemsize * (1 + int(two_operands) + gradients), 4 * numel


def cond_bytes(b, h, w, width, itemsize):
    """label and inst (int32) read, the width-channel conditioning written."""
    return b * h * w * (8 + width * itemsize), b * h * w * width


def conv_in_bound(shape, dtype, residual):
    """x, w, b (fp32), the residual read once and y written once; the
    conv's multiply-adds at the dtype's peak (bf16 tensor cores, fp32
    outside them)."""
    n, h, w, cin, cout = shape
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = item * (n * h * w * (cin + cout * (1 + int(residual))) + 9 * cin * cout) + 4 * cout
    ops = 2 * n * h * w * 9 * cin * cout
    return bound(nbytes, ops, BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S)


def _item(dtype):
    return torch.empty((), dtype=dtype).element_size()


def call_bytes(kind, *args, **kw):
    """Bytes that one call of the wrapper ``kind`` must move, from the
    arguments it was given: ``instance_norm``, ``instance_norm_bwd``,
    ``reflect_pad_fwd``, ``reflect_pad_bwd``, ``reduce_group``,
    ``loss_group_bwd``, ``encode``, ``encode_cond``."""
    if kind == "instance_norm":
        x = args[0]
        residual = kw.get("residual", args[2] if len(args) > 2 else None)
        n, h, w, c = x.shape
        return in_bytes(n, h * w, c, x.element_size(), residual is not None)[0]
    if kind == "instance_norm_bwd":
        x = args[0]
        act = kw.get("act", args[5] if len(args) > 5 else "none")
        want = kw.get("want_dres", args[6] if len(args) > 6 else False)
        return in_bwd_bytes(tuple(x.shape), x.element_size(), act, bool(want))[0]
    if kind == "reflect_pad_fwd":
        x, pad = args[0], kw.get("pad", args[1] if len(args) > 1 else None)
        return pad_fwd_bytes(tuple(x.shape), pad, x.element_size())[0]
    if kind == "reflect_pad_bwd":
        dy, pad = args[0], kw.get("pad", args[1] if len(args) > 1 else None)
        return pad_bwd_bytes(tuple(dy.shape), pad, dy.element_size())[0]
    if kind == "reduce_group":
        return sum(loss_bytes(a.numel(), a.element_size(), torch.is_tensor(t))[0]
                   for _, a, t in args[0])
    if kind == "loss_group_bwd":
        spec, tensors, needs = args[:3]
        return sum(loss_bwd_bytes(a.numel(), a.element_size(), b is not None,
                                  (ga is not None) + (gb is not None))[0]
                   for _, _, _, a, b, ga, gb in klosses._operands(spec, tensors, needs))
    if kind == "encode":
        label, inst, image, _boxes, nc = args[:5]
        pad = kw.get("pad", args[5] if len(args) > 5 else 0)
        dtype = kw.get("dtype", args[6] if len(args) > 6 else None)
        b, h, w = label.shape
        if image is not None:
            dtype = dtype or image.dtype
            return encode_bytes(b, h, w, nc, pad, _item(dtype))[0]
        width = nc + int(inst is not None)
        return b * h * w * 8 + b * (h + 2 * pad) * (w + 2 * pad) * width * _item(
            dtype or torch.float32)
    if kind == "encode_cond":
        label, inst, nc = args[:3]
        dtype = kw.get("dtype", args[3] if len(args) > 3 else torch.float32)
        b, h, w = label.shape
        return cond_bytes(b, h, w, nc + int(inst is not None), _item(dtype))[0]
    raise ValueError(f"no byte reckoning for {kind!r}")

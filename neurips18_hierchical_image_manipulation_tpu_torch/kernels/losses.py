"""Loss reductions to fp32 means: ``reduce_group`` (up to 16 terms, one
launch), ``reduce_terms`` (any number of terms, the losses' entry point),
and the single-term ``mse_to_scalar`` (LSGAN) and ``l1_to_scalar``
(feature matching, VGG).

Replaces the TPU kernels of ``ops/pallas/losses.py`` (JAX package):
``mse_to_scalar`` / ``l1_to_scalar`` -> ``_reduce_call`` (``_sq_kernel``,
``_abs_kernel``): one pass, an fp32 accumulator, the true element count as
the denominator. A term is ``(mode, a, target)``: ``("mse", pred, t)`` is
mean((pred - t)²) and ``("l1", a, b)`` is mean(|a - b|); the target is a
tensor of a's shape, dtype and device, or a float. The port's kernel
(``csrc/losses.cu``) takes the two operands, so no diff tensor is written,
and reduces a whole group of terms in one launch that also finishes the
means: deterministic, the same bits for a term alone or in any group.

Bound: bytes (each element read once). Every loss term on the card
launches the kernel, down to the ~2.3k-element D logits: the JAX
``diff.size < _CHUNK`` gate was a TPU tiling limit, and its
``_LOSS_KERNELS = False`` gate a TPU measurement. A CPU tensor takes the
plain version.

The backward, ``loss_group_bwd``, is each term's closed form, 2 g (pred -
t)/N and g sign(a - b)/N (the JAX package leaves it to XLA): one launch of
``csrc/losses.cu``'s backward kernel a group for CUDA tensors, over the
terms that take a gradient, with the bits of the plain closed form
(``loss_group_bwd_plain``, which CPU tensors take). Bound: bytes, 6 an
element in bf16 and 12 in fp32, where the plain closed form moves about 46
through its fp32 temporaries.

``mse_to_scalar.launches`` / ``l1_to_scalar.launches`` count the terms of
each mode that a launch reduced; ``.variants["group"]`` counts the launches
that held a term of that mode. ``loss_group_bwd.launches`` counts the
backward's launches; its ``.variants["terms"]`` the terms they wrote a
gradient for, and ``["unaligned"]`` those of them off the 16-byte grid
(read and written element by element).

The launches' tickets and partials live in a workspace of each (device,
stream), zeroed once when it is made and left at zero by every launch, so
launches on one stream, which run one after another, share it and another
stream has its own. A CUDA graph keeps the workspace of the stream it was
captured on: capture on a stream that has launched the kernel before (as
``torch.cuda.graph(g, stream=s)`` after a warm-up on ``s``), and replay it
where no launch on that stream runs at the same time.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MODES = {"mse": 0, "l1": 1}
MAX_TERMS = 16  # csrc/losses.cu kMaxTerms

_workspaces = {}  # (device index, stream) -> the kernel's tickets and partials


def _check(a, b):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand must be float32 or bfloat16, got {a.dtype}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype or b.device != a.device):
        raise ValueError("both operands must match in shape, dtype and device")
    if a.numel() == 0:
        raise ValueError("the mean of an empty tensor is undefined")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _check_group(terms):
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"a group holds 1 to {MAX_TERMS} terms, got {len(terms)}")
    a0 = terms[0][1]
    for mode, a, t in terms:
        if mode not in MODES:
            raise ValueError(f"unknown loss mode {mode!r}")
        _check(a, t if torch.is_tensor(t) else None)
        if a.dtype != a0.dtype or a.device != a0.device:
            raise ValueError("the terms of a group must share one dtype and device")


def _reduce_plain(a, b, t, mode):
    d = a.to(torch.float32) - (b.to(torch.float32) if b is not None else t)
    return d.square().mean() if mode == "mse" else d.abs().mean()


def _plain_means(terms):
    return torch.stack([_reduce_plain(a, t if torch.is_tensor(t) else None,
                                      0.0 if torch.is_tensor(t) else float(t), mode)
                        for mode, a, t in terms])


def reduce_group_plain(terms):
    """Plain PyTorch version of ``reduce_group``, one term at a time, with
    PyTorch's own backward."""
    _check_group(terms)
    return _plain_means(terms)


def _workspace(device, stream):
    """The tickets and partials of launches on one stream of the device
    (``stream``: its handle), zeroed once when allocated, on that stream."""
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "reduce_group: the first launch on this stream is being captured in a CUDA "
                "graph, where its workspace cannot be zeroed; launch it on the capture "
                "stream once before capturing")
        ws = torch.zeros(_lib().himan_loss_workspace_bytes(), dtype=torch.uint8, device=device)
        _workspaces[(device.index, stream)] = ws
    return ws


def _launch(terms):
    """One launch over the group -> (T,) fp32 means on the terms' device."""
    lib = _lib()
    a0 = terms[0][1]
    count = len(terms)
    ops = [(a.contiguous(), t.contiguous() if torch.is_tensor(t) else None) for _, a, t in terms]
    ptr = ctypes.c_void_p * count
    out = torch.empty(count, dtype=torch.float32, device=a0.device)
    stream = _build.stream_for(a0.device)
    err = lib.himan_loss_group(
        ptr(*[a.data_ptr() for a, _ in ops]),
        ptr(*[b.data_ptr() if b is not None else None for _, b in ops]),
        (ctypes.c_float * count)(*[0.0 if torch.is_tensor(t) else float(t)
                                   for _, _, t in terms]),
        (ctypes.c_int64 * count)(*[a.numel() for a, _ in ops]),
        (ctypes.c_int * count)(*[MODES[m] for m, _, _ in terms]),
        count, int(a0.dtype == torch.bfloat16), _workspace(a0.device, stream).data_ptr(),
        out.data_ptr(), stream,
    )
    _build.check(err, "himan_loss_group")
    for wrapper, mode in ((mse_to_scalar, "mse"), (l1_to_scalar, "l1")):
        k = sum(m == mode for m, _, _ in terms)
        if k:
            wrapper.launches += k
            wrapper.variants["group"] += 1
    return out


def _operands(spec, tensors, needs):
    """The terms of ``spec`` that take a gradient: (index in g, mode,
    scalar target, a, target tensor or None, index in ``tensors`` of a's
    gradient, of the target's; None where that one takes none)."""
    out, i = [], 0
    for k, (mode, t) in enumerate(spec):
        ib = i + 1 if t is None else None
        ga = i if needs[i] else None
        gb = ib if ib is not None and needs[ib] else None
        if ga is not None or gb is not None:
            out.append((k, mode, 0.0 if t is None else t, tensors[i],
                        None if ib is None else tensors[ib], ga, gb))
        i += 1 if ib is None else 2
    return out


def loss_group_bwd_plain(spec, tensors, needs, g):
    """Plain PyTorch version of ``loss_group_bwd``: each term's closed form
    in fp32, rounded once to the operand's dtype."""
    grads = [None] * len(tensors)
    for k, mode, t, a, b, ga, gb in _operands(spec, tensors, needs):
        d = a.to(torch.float32) - (b.to(torch.float32) if b is not None else t)
        if mode == "mse":
            s = (2.0 * g[k] / a.numel()) * d
        else:
            s = (g[k] / a.numel()) * torch.sign(d)
        if ga is not None:
            grads[ga] = s.to(a.dtype)
        if gb is not None:
            grads[gb] = (-s).to(b.dtype)
    return grads


def loss_group_bwd(spec, tensors, needs, g):
    """The backward of ``reduce_group``: ``spec`` and ``tensors`` as
    ``_Group.forward`` takes them, ``needs`` whether each tensor takes a
    gradient, ``g`` the (T,) fp32 upstream gradient -> each tensor's
    gradient (None where it takes none). One launch for CUDA tensors over
    the terms that take a gradient (none where no term does); g is read on
    the card, so nothing waits for the host. CPU tensors take the plain
    version."""
    if tensors[0].device.type == "cpu":
        return loss_group_bwd_plain(spec, tensors, needs, g)
    grads = [None] * len(tensors)
    rows = []  # per term: its index in g, mode, scalar target, then a, b, da, db
    for k, mode, t, a, b, ga, gb in _operands(spec, tensors, needs):
        a = a.contiguous()
        b = b.contiguous() if b is not None else None
        if ga is not None:
            grads[ga] = torch.empty_like(a)
        if gb is not None:
            grads[gb] = torch.empty_like(b)
        rows.append((k, MODES[mode], float(t), a, b, None if ga is None else grads[ga],
                     None if gb is None else grads[gb]))
    if not rows:
        return grads
    count, a0 = len(rows), rows[0][3]
    ks, modes, ts, *ops = zip(*rows)
    ptrs = [[x.data_ptr() if x is not None else None for x in col] for col in ops]
    g = g.to(torch.float32)
    err = _lib().himan_loss_group_bwd(
        *((ctypes.c_void_p * count)(*col) for col in ptrs),
        (ctypes.c_float * count)(*ts), (ctypes.c_int64 * count)(*[a.numel() for a in ops[0]]),
        (ctypes.c_int * count)(*modes), (ctypes.c_int * count)(*ks),
        count, int(a0.dtype == torch.bfloat16), g.data_ptr(), g.stride(0),
        _build.stream_for(a0.device),
    )
    _build.check(err, "himan_loss_group_bwd")
    loss_group_bwd.launches += 1
    loss_group_bwd.variants["terms"] += count
    loss_group_bwd.variants["unaligned"] += sum(any(p and p % 16 for p in term)
                                                for term in zip(*ptrs))
    return grads


loss_group_bwd.launches = 0
loss_group_bwd.variants = {"terms": 0, "unaligned": 0}


class _Group(torch.autograd.Function):
    """Forward: the (T,) means, by the kernel (the plain version for CPU
    tensors). Backward: each term's closed form, ``loss_group_bwd``."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        # spec: per term (mode, target float or None when the target is the
        # next tensor); tensors: a, then the target tensor where there is one
        it = iter(tensors)
        terms = [(mode, next(it), next(it) if t is None else t) for mode, t in spec]
        ctx.spec = spec
        ctx.save_for_backward(*tensors)
        if tensors[0].device.type == "cpu":
            return _plain_means(terms)
        return _launch(terms)

    @staticmethod
    def backward(ctx, g):
        return (None, *loss_group_bwd(ctx.spec, ctx.saved_tensors, ctx.needs_input_grad[1:], g))


def reduce_group(terms):
    """Up to 16 terms ``(mode, a, target)`` of one dtype and device -> their
    (T,) fp32 means, differentiable; one kernel launch for CUDA tensors."""
    _check_group(terms)
    spec, tensors = [], []
    for mode, a, t in terms:
        tensors.append(a)
        if torch.is_tensor(t):
            tensors.append(t)
            spec.append((mode, None))
        else:
            spec.append((mode, float(t)))
    return _Group.apply(tuple(spec), *tensors)


def reduce_terms(terms):
    """Any number of terms of one dtype -> their (T,) fp32 means: one
    ``reduce_group`` for each run of up to 16 terms (one launch for every
    loss of the default networks; feature matching over more than 16 D
    layers takes more)."""
    means = [reduce_group(terms[i : i + MAX_TERMS]) for i in range(0, len(terms), MAX_TERMS)]
    return means[0] if len(means) == 1 else torch.cat(means)


def mse_to_scalar(pred, target: float):
    """mean((pred - target)²) in fp32 for a scalar target (LSGAN)."""
    return reduce_group([("mse", pred, float(target))])[0]


mse_to_scalar.launches = 0
mse_to_scalar.variants = {"group": 0}


def l1_to_scalar(a, b):
    """mean(|a - b|) in fp32 (feature matching, VGG perceptual)."""
    return reduce_group([("l1", a, b)])[0]


l1_to_scalar.launches = 0
l1_to_scalar.variants = {"group": 0}


def mse_to_scalar_plain(pred, target: float):
    """Plain PyTorch version, with PyTorch's own backward."""
    _check(pred, None)
    return _reduce_plain(pred, None, float(target), "mse")


def l1_to_scalar_plain(a, b):
    """Plain PyTorch version, with PyTorch's own backward."""
    _check(a, b)
    return _reduce_plain(a, b, 0.0, "l1")


def _lib():
    lib = _build.load("losses")
    if lib.himan_loss_group.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.himan_loss_workspace_bytes.argtypes = []
        lib.himan_loss_workspace_bytes.restype = ctypes.c_int64
        lib.himan_loss_group.argtypes = [p, p, p, p, p, i, i, p, p, p]
        lib.himan_loss_group.restype = i
        lib.himan_loss_group_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, p,
                                             ctypes.c_int64, p]
        lib.himan_loss_group_bwd.restype = i
    return lib

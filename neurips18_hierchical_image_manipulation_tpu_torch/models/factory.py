"""Model factory — counterpart of ``models/factory.py`` in the JAX package:
resolves the device and the numeric precision, then builds the model
(``--model pix2pixHD`` or ``box2mask``)."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(opt) -> torch.device:
    """``--gpu_ids -1`` is the CPU; otherwise the first listed card, or
    under several ranks this rank's (``parallel.distributed.rank_devices``:
    the rank-th listed id, else ``cuda:rank``). With a card requested and
    none present this raises: the port never carries on on the CPU in its
    place."""
    from ..parallel.distributed import local_rank, rank_devices

    r = local_rank()
    device = rank_devices(opt.gpu_ids, r + 1)[r]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {opt.gpu_ids} asks for a CUDA device but none is "
            "available; pass --gpu_ids -1 to run on the CPU"
        )
    return device


def resolve_precision(opt) -> str:
    """``--conv_precision``: auto -> 'default' under --dtype bfloat16,
    else 'highest' (the fp32 parity tier)."""
    prec = getattr(opt, "conv_precision", "auto")
    if prec == "auto":
        prec = "default" if getattr(opt, "dtype", "float32") == "bfloat16" else "highest"
    if prec not in ("default", "highest"):
        raise ValueError(f"--conv_precision must be auto|default|highest, got {prec!r}")
    return prec


def _set_tf32(allow: bool) -> None:
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow


@contextlib.contextmanager
def precision_scope(model):
    """Run a block under the precision ``model`` was created with, then put
    the caller's TF32 switches back: the switches are process-wide, so two
    models of different tiers in one process (the two stages of the
    two-step pipeline) each need their own around their inference."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _set_tf32(model.conv_precision_resolved == "default")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def create_model(opt):
    # 'highest' keeps fp32 convolutions and matmuls in full fp32: cuDNN
    # would otherwise run fp32 convolutions in TF32 (about three decimal
    # digits). 'default' allows TF32, the counterpart of the JAX package's
    # Precision.DEFAULT tier. These are process-wide switches
    # (precision_scope re-pins them for one model).
    prec = resolve_precision(opt)
    _set_tf32(prec == "default")
    # --no_pallas is accepted and changes nothing here: it selected the JAX
    # package's lax fallbacks over its TPU kernels, while on the card every
    # ported kernel IS the path (the plain versions serve CPU tensors only).
    # The JAX factory also turns on its IN custom VJP and fused reflect conv
    # for --netG local: rewrites of the same math that change only the
    # rounding, with no counterpart here.
    if opt.model == "pix2pixHD":
        from .pix2pixhd import Pix2PixHDModel as Model
    elif opt.model == "box2mask":
        from .box2mask import BoxToMaskModel as Model
    else:
        raise ValueError(f"unknown model: {opt.model}")
    model = Model(opt, resolve_device(opt))
    model.conv_precision_resolved = prec
    return model

"""Generator-input build: one-hot ⊕ instance edge ⊕ box-masked RGB, with an
optional reflect pad of 3 (the stem's ReflectionPad) folded in.

Replaces the TPU kernels of ``ops/pallas/encode.py`` (JAX package):
``encode_full`` / ``_expand_rgb_kernel`` (pad 0) and ``encode_packed`` /
``_expand_packed_kernel`` (pad 3, emitted unpacked: the space-to-depth
packing served the TPU's matrix unit and has no counterpart here); with no
image it is ``encode_cond`` / ``_expand_kernel``.

Bound: bytes — the output is 13x wider than the inputs and nothing is
computed but compares and selects. The CUDA kernel (``csrc/encode.cu``)
stages a tile of pixels' ids, edges and masked RGB in shared memory, then
writes the tile's outputs with fully coalesced stores, the dominant
traffic; see the source for the numbers.

``encode_cond`` is the no-image mode, ``encode_cond`` / ``_expand_kernel``
of the JAX package: the discriminator's conditioning (one-hot ⊕ edge) of
the train step. Its launches count on ``encode_cond.launches``, the RGB
modes' on ``encode.launches``, and by pad on ``encode.variants`` ("pad3":
the GlobalGenerator's stem input, ``encode_packed``'s counterpart; "pad0":
the LocalEnhancer's and the instance-feature path's, ``encode_full``'s).

``encode`` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors (or raises). No gradient flows through it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import boxcomposite, nnops, onehot_edges
from . import _build

PADS = (0, 3)
_MAX_W = 65535 * 128  # padded width: the kernel's grid.y x pixels per block


def encode_plain(label, inst, image, boxes, nc: int, pad: int = 0, dtype=None):
    """Plain PyTorch version: ``encode_input_rgb ∘ mask_box`` (or
    ``encode_input`` with no image), then the reflect pad."""
    if dtype is None:
        dtype = image.dtype if image is not None else torch.float32
    if image is None:
        g = onehot_edges.encode_input(label, inst, nc, dtype)
    else:
        rgb = boxcomposite.mask_box(image, boxes, fill=0.0)
        g = onehot_edges.encode_input_rgb(label, inst, rgb, nc, dtype)
    return nnops.reflect_pad(g, pad) if pad else g


def _check(label, inst, image, boxes, pad):
    if pad not in PADS:
        raise ValueError(f"pad must be one of {PADS}, got {pad}")
    if label.dim() != 3:
        raise ValueError(f"label must be (B,H,W), got {tuple(label.shape)}")
    b, h, w = label.shape
    if pad and (h <= pad or w <= pad):
        raise ValueError(f"reflect pad {pad} needs H, W > {pad}, got {h}x{w}")
    ints = [("label", label)] + ([("inst", inst)] if inst is not None else [])
    for name, t in ints:
        if t.dtype != torch.int32 or t.shape != label.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 (B,H,W)")
    if image is not None:
        if image.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"image must be float32 or bfloat16, got {image.dtype}")
        if tuple(image.shape) != (b, h, w, 3) or not image.is_contiguous():
            raise ValueError("image must be contiguous NHWC (B,H,W,3)")
        if (
            boxes is None
            or boxes.dtype != torch.float32
            or tuple(boxes.shape) != (b, 4)
            or not boxes.is_contiguous()
        ):
            raise ValueError("boxes must be contiguous float32 (B,4)")
    for t in (label, inst, image, boxes):
        if t is not None and t.device != label.device:
            raise ValueError("all inputs must be on one device")


def encode(label, inst: Optional[torch.Tensor], image: Optional[torch.Tensor],
           boxes: Optional[torch.Tensor], nc: int, pad: int = 0, dtype=None):
    """(B,H,W) int32 label [+ inst], [(B,H,W,3) image + (B,4) fp32 boxes]
    -> (B, H+2pad, W+2pad, nc [+1] [+3]) NHWC in the image's dtype (or
    ``dtype`` when there is no image). While ``torch.export`` traces, the
    call is the ``himan::encode`` op (``kernels/ops.py``), whose
    implementation is this function."""
    if torch.compiler.is_exporting():
        from . import ops

        return ops.encode(label, inst, image, boxes, nc, pad, dtype)
    _check(label, inst, image, boxes, pad)
    if label.device.type == "cpu":
        return encode_plain(label, inst, image, boxes, nc, pad, dtype)
    if label.device.type != "cuda":
        raise ValueError(f"unsupported device {label.device}")
    out_dtype = image.dtype if image is not None else (dtype or torch.float32)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"output dtype must be float32 or bfloat16, got {out_dtype}")
    if image is not None and dtype is not None and dtype != image.dtype:
        raise ValueError("dtype must match the image's dtype")
    b, h, w = label.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    if b * hp >= 2**31 or wp > _MAX_W:
        raise ValueError(f"encode grid limits: B*Hp {b * hp} < 2^31, Wp {wp} <= {_MAX_W}")
    has_edge = int(inst is not None)
    n_rgb = 3 if image is not None else 0
    out = torch.empty((b, hp, wp, nc + has_edge + n_rgb), dtype=out_dtype, device=label.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.himan_encode(
        label.data_ptr(),
        inst.data_ptr() if inst is not None else None,
        image.data_ptr() if image is not None else None,
        boxes.data_ptr() if image is not None else None,
        out.data_ptr(), b, h, w, nc, has_edge, n_rgb, pad,
        int(out_dtype == torch.bfloat16), _build.stream_for(label.device),
    )
    _build.check(err, "himan_encode")
    if image is None:
        encode_cond.launches += 1
    else:
        encode.launches += 1
        encode.variants[f"pad{pad}"] += 1
    return out


encode.launches = 0
encode.variants = {"pad0": 0, "pad3": 0}


def encode_cond_plain(label, inst: Optional[torch.Tensor], nc: int, dtype=torch.float32):
    """Plain PyTorch version of ``encode_cond``."""
    return encode_plain(label, inst, None, None, nc, 0, dtype)


def encode_cond(label, inst: Optional[torch.Tensor], nc: int, dtype=torch.float32):
    """(B,H,W) int32 label [+ inst] -> (B,H,W,nc [+1]) one-hot ⊕ edge in
    ``dtype``: the discriminator's conditioning."""
    return encode(label, inst, None, None, nc, 0, dtype)


encode_cond.launches = 0


def _lib():
    lib = _build.load("encode")
    if lib.himan_encode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.himan_encode.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.himan_encode.restype = i
    return lib

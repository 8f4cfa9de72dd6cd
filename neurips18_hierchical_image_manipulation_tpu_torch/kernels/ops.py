"""The serving path's kernels as ``torch.library`` custom ops, for
``torch.export``.

The wrappers launch their kernels through ``ctypes`` on raw
``data_ptr()``s, which ``torch.export`` cannot trace: an exported program
of the plain composition would drop the kernels without a word. So the two
kernels on the serving path are ops of their own:

  * ``himan::encode``: ``kernels/encode.encode``, all modes (pad 0 / 3,
    with or without the masked image): rows 2 and 3 of the TPU kernel
    table (``encode_full``, ``encode_packed``) and, with no image, row 1
    (``encode_cond``);
  * ``himan::instance_norm``: ``kernels/instance_norm.instance_norm``, row
    4 (``fused_instance_norm``'s forward): -> (y, mean, rstd).

Each op's implementation is the wrapper itself: on a CUDA tensor the
hand-written kernel, counted by the wrapper's launch counter; on a CPU
tensor the plain version; any other device raises. ``register_fake``
gives the shapes and dtypes, so the op traces without running.

The wrappers route through these ops only while
``torch.compiler.is_exporting()`` is true; eager calls keep the direct
call. ``tools/export_inference.load`` imports this module before
``torch.export.load``, so that a reloaded program finds the ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import encode as kenc
from . import instance_norm as kin

NAMESPACE = "himan"
ENCODE = f"{NAMESPACE}::encode"
INSTANCE_NORM = f"{NAMESPACE}::instance_norm"


@torch.library.custom_op(ENCODE, mutates_args=())
def encode(label: torch.Tensor, inst: Optional[torch.Tensor], image: Optional[torch.Tensor],
           boxes: Optional[torch.Tensor], nc: int, pad: int,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    return kenc.encode(label, inst, image, boxes, nc, pad, dtype)


@encode.register_fake
def _encode_fake(label, inst, image, boxes, nc, pad, dtype):
    kenc._check(label, inst, image, boxes, pad)
    b, h, w = label.shape
    width = nc + int(inst is not None) + (3 if image is not None else 0)
    out_dtype = image.dtype if image is not None else (dtype or torch.float32)
    return label.new_empty((b, h + 2 * pad, w + 2 * pad, width), dtype=out_dtype)


@torch.library.custom_op(INSTANCE_NORM, mutates_args=())
def instance_norm(x: torch.Tensor, act: str, residual: Optional[torch.Tensor],
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    y, mean, rstd = kin.instance_norm(x, act, residual, eps)
    # an op's outputs may not alias each other (the kernel's mean and rstd
    # are views of one workspace)
    return y, mean.clone(), rstd.clone()


@instance_norm.register_fake
def _instance_norm_fake(x, act, residual, eps):
    kin._check(x, act, residual)
    n, _, _, c = x.shape
    stats = x.new_empty((n, c), dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


def exported_ops(graph_module) -> dict:
    """Nodes of each ``himan::`` op in an exported graph, by op name."""
    counts = {ENCODE: 0, INSTANCE_NORM: 0}
    for node in graph_module.graph.nodes:
        schema = getattr(node.target, "_schema", None) if node.op == "call_function" else None
        if schema is not None and schema.name in counts:
            counts[schema.name] += 1
    return counts

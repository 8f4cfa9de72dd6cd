"""One-hot label maps and instance edge maps, NHWC.

Counterpart of ``ops/onehot_edges.py`` in the JAX package (pix2pixHD
``encode_input``): one-hot of the label ids, an edge plane marking pixels
whose instance id differs from any 4-neighbour, and the extra float
conditioning channels (the box-masked RGB), built as one tensor with the
channel layout of ``concat([one_hot, edges?, rgb], -1)``.
"""

from __future__ import annotations

from typing import Optional

import torch


def one_hot_label(label_ids: torch.Tensor, label_nc: int, dtype=torch.float32):
    """(B,H,W) int ids -> (B,H,W,label_nc). Ids outside [0, label_nc) give
    an all-zero row (the JAX package's documented divergence from torch's
    scatter_, which would raise)."""
    ids = label_ids.to(torch.int32)
    nc_range = torch.arange(label_nc, dtype=torch.int32, device=ids.device)
    return (ids[..., None] == nc_range).to(dtype)


def instance_edges(inst: torch.Tensor, dtype=torch.float32):
    """(B,H,W) instance ids -> (B,H,W,1) edge map (pix2pixHD get_edges):
    both pixels next to an id change are marked, borders zero-extended."""
    inst = inst.to(torch.int32)
    e = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    dif_w = inst[:, :, 1:] != inst[:, :, :-1]
    dif_h = inst[:, 1:, :] != inst[:, :-1, :]
    e[:, :, 1:] |= dif_w
    e[:, :, :-1] |= dif_w
    e[:, 1:, :] |= dif_h
    e[:, :-1, :] |= dif_h
    return e.to(dtype)[..., None]


def encode_input(label_ids, inst: Optional[torch.Tensor] = None, label_nc=35,
                 dtype=torch.float32):
    """One-hot [+ edge channel]: (B,H,W,label_nc [+1])."""
    oh = one_hot_label(label_ids, label_nc, dtype)
    if inst is None:
        return oh
    return torch.cat([oh, instance_edges(inst, dtype)], -1)


def encode_input_rgb(label_ids, inst: Optional[torch.Tensor], rgb: torch.Tensor,
                     label_nc=35, dtype=torch.float32):
    """One-hot ⊕ [edge] ⊕ rgb extras: (B,H,W,label_nc [+1] + k)."""
    return torch.cat([encode_input(label_ids, inst, label_nc, dtype), rgb.to(dtype)], -1)

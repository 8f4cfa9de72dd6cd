"""box2mask's reconstruction losses — counterpart of ``losses/layout.py`` in
the JAX package: the per-pixel cross-entropy of the layout logits against
the GT label ids (optionally weighted), and the BCE of the object-mask
stream inside the box. Plain PyTorch: the JAX package computes them outside
any TPU kernel too."""

from __future__ import annotations

import torch


def layout_ce_loss(layout_logits, gt_label_ids, weight_mask=None):
    """layout_logits (B,H,W,C), gt_label_ids (B,H,W) int -> the mean
    per-pixel CE, or with a (B,H,W,1) ``weight_mask`` sum(nll * w) /
    max(sum(w), 1) (not ``F.cross_entropy``'s weighting)."""
    logp = torch.log_softmax(layout_logits, dim=-1)
    nll = -torch.gather(logp, -1, gt_label_ids.to(torch.int64)[..., None])[..., 0]
    if weight_mask is None:
        return nll.mean()
    w = weight_mask[..., 0]
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)


def object_mask_loss(mask_logit, gt_mask, boxmask):
    """The stable BCE with logits of the object-mask stream, restricted to
    the box: sum(bce * box) / max(sum(box), 1)."""
    x, t, w = mask_logit[..., 0], gt_mask[..., 0], boxmask[..., 0]
    bce = torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return (bce * w).sum() / torch.clamp_min(w.sum(), 1.0)

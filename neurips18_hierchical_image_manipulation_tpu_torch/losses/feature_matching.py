"""Discriminator feature-matching loss — counterpart of
``losses/feature_matching.py`` in the JAX package: L1 between the per-layer
D features of fake and real, over every layer except the logits, weighted
4/(n_layers_D+1) · 1/num_D · lambda_feat; the real branch is detached.
Every layer's term of every scale is reduced by one launch
(``kernels/losses.reduce_terms``), and the terms are summed in the JAX
order."""

from __future__ import annotations

from ..kernels import losses as klosses


def feature_matching_loss(d_fake, d_real, n_layers_D=3, num_D=2, lambda_feat=10.0):
    feat_w = 4.0 / (n_layers_D + 1)
    d_w = 1.0 / num_D
    pairs = [("l1", f_fake, f_real.detach())
             for scale_fake, scale_real in zip(d_fake, d_real)
             for f_fake, f_real in zip(scale_fake[:-1], scale_real[:-1])]
    loss = 0.0
    if not pairs:
        return loss
    for term in klosses.reduce_terms(pairs).unbind(0):
        loss = loss + feat_w * d_w * term * lambda_feat
    return loss

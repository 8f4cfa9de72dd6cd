"""Discriminator feature-matching loss — counterpart of
``losses/feature_matching.py`` in the JAX package: L1 between the per-layer
D features of fake and real, over every layer except the logits, weighted
4/(n_layers_D+1) · 1/num_D · lambda_feat; the real branch is detached."""

from __future__ import annotations

from ..kernels import losses as klosses


def feature_matching_loss(d_fake, d_real, n_layers_D=3, num_D=2, lambda_feat=10.0):
    feat_w = 4.0 / (n_layers_D + 1)
    d_w = 1.0 / num_D
    loss = 0.0
    for scale_fake, scale_real in zip(d_fake, d_real):
        for f_fake, f_real in zip(scale_fake[:-1], scale_real[:-1]):
            loss = loss + feat_w * d_w * klosses.l1_to_scalar(f_fake, f_real.detach()) * lambda_feat
    return loss

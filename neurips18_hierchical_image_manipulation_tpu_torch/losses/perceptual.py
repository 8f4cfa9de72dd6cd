"""VGG19 perceptual loss — counterpart of ``losses/perceptual.py`` in the
JAX package: L1 over the relu1_1..relu5_1 taps with weights
(1/32, 1/16, 1/8, 1/4, 1), [-1, 1] images fed as they are, the real
branch detached (its taps are computed without a graph)."""

from __future__ import annotations

import torch

from ..kernels import losses as klosses

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(vgg, fake, real):
    """vgg: a ``Vgg19Features`` (or a function of an image to its taps);
    fake, real: (B,H,W,3) in [-1, 1]."""
    taps_fake = vgg(fake)
    with torch.no_grad():
        taps_real = vgg(real)
    loss = 0.0
    for w, tf_, tr in zip(VGG_WEIGHTS, taps_fake, taps_real):
        loss = loss + w * klosses.l1_to_scalar(tf_, tr)
    return loss

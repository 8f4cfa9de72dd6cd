"""GAN losses — LSGAN (MSE) by default, vanilla BCE with logits under
--no_lsgan. Counterpart of ``losses/gan.py`` in the JAX package: a
multiscale list of per-layer feature lists uses the LAST entry of each
scale (the logits), and the loss over scales is SUMMED."""

from __future__ import annotations

import torch

from ..kernels import losses as klosses


def _single(pred, target_is_real: bool, use_lsgan: bool):
    t = 1.0 if target_is_real else 0.0
    if use_lsgan:
        return klosses.mse_to_scalar(pred, t)
    # -[t log σ(x) + (1-t) log(1-σ(x))], the stable form
    x = pred.to(torch.float32)
    return torch.mean(torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs())))


def gan_loss(d_out, target_is_real: bool, use_lsgan: bool = True):
    """d_out: a multiscale list of per-layer feature lists (last = logits),
    one such list, or a logits tensor -> the scalar loss, summed over
    scales."""
    if isinstance(d_out, (list, tuple)) and len(d_out) and isinstance(d_out[0], (list, tuple)):
        total = 0.0
        for scale in d_out:
            total = total + _single(scale[-1], target_is_real, use_lsgan)
        return total
    if isinstance(d_out, (list, tuple)):
        return _single(d_out[-1], target_is_real, use_lsgan)
    return _single(d_out, target_is_real, use_lsgan)


def discriminator_loss(d_real, d_fake, use_lsgan: bool = True):
    """-> (0.5 * (L(D(real), 1) + L(D(fake), 0)), real term, fake term)."""
    loss_real = gan_loss(d_real, True, use_lsgan)
    loss_fake = gan_loss(d_fake, False, use_lsgan)
    return 0.5 * (loss_real + loss_fake), loss_real, loss_fake

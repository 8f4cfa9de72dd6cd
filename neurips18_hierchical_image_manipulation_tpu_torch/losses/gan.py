"""GAN losses — LSGAN (MSE) by default, vanilla BCE with logits under
--no_lsgan. Counterpart of ``losses/gan.py`` in the JAX package: a
multiscale list of per-layer feature lists uses the LAST entry of each
scale (the logits), and the loss over scales is SUMMED. Under LSGAN every
scale's term of one call (of ``discriminator_loss``: the real and the fake
ones) is reduced by one launch (``kernels/losses.reduce_terms``), and the
terms are summed in the JAX order."""

from __future__ import annotations

import torch

from ..kernels import losses as klosses


def _bce(pred, target_is_real: bool):
    # -[t log σ(x) + (1-t) log(1-σ(x))], the stable form
    t = 1.0 if target_is_real else 0.0
    x = pred.to(torch.float32)
    return torch.mean(torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs())))


def _logits(d_out):
    """(the logits of each scale, whether d_out is multiscale)"""
    if isinstance(d_out, (list, tuple)) and len(d_out) and isinstance(d_out[0], (list, tuple)):
        return [scale[-1] for scale in d_out], True
    if isinstance(d_out, (list, tuple)):
        return [d_out[-1]], False
    return [d_out], False


def _sum(terms, multiscale):
    if not multiscale:
        return terms[0]
    total = 0.0
    for term in terms:
        total = total + term
    return total


def _terms(logits, target_is_real, use_lsgan):
    """Each scale's loss term; one launch for all of them under LSGAN."""
    if not use_lsgan:
        return [_bce(x, target_is_real) for x in logits]
    t = 1.0 if target_is_real else 0.0
    return list(klosses.reduce_terms([("mse", x, t) for x in logits]).unbind(0))


def gan_loss(d_out, target_is_real: bool, use_lsgan: bool = True):
    """d_out: a multiscale list of per-layer feature lists (last = logits),
    one such list, or a logits tensor -> the scalar loss, summed over
    scales."""
    logits, multiscale = _logits(d_out)
    return _sum(_terms(logits, target_is_real, use_lsgan), multiscale)


def discriminator_loss(d_real, d_fake, use_lsgan: bool = True):
    """-> (0.5 * (L(D(real), 1) + L(D(fake), 0)), real term, fake term)."""
    real, ms_real = _logits(d_real)
    fake, ms_fake = _logits(d_fake)
    if use_lsgan:
        terms = list(klosses.reduce_terms([("mse", x, 1.0) for x in real]
                                          + [("mse", x, 0.0) for x in fake]).unbind(0))
    else:
        terms = [_bce(x, True) for x in real] + [_bce(x, False) for x in fake]
    loss_real = _sum(terms[: len(real)], ms_real)
    loss_fake = _sum(terms[len(real):], ms_fake)
    return 0.5 * (loss_real + loss_fake), loss_real, loss_fake

"""Parity evaluators: layout mIoU, segmentation consistency and FID —
counterpart of ``eval/metrics.py`` in the JAX package.

* ``layout_miou``: mean IoU between predicted and GT semantic layouts, the
  structure generator's metric.
* ``segmentation_consistency``: pixel accuracy inside the edited box.
* ``fid_from_stats`` / ``FIDEvaluator``: the Frechet distance between
  Gaussian fits of feature activations, in float64 on the host. The
  feature extractor is injected (``feature_fn``); ``vgg_pool_features``
  pools the port's VGG19 relu5_1, which gives paper-comparable numbers
  only with pretrained weights loaded (``cli/evaluate.py
  --feature_params``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def layout_miou(pred_ids, gt_ids, num_classes: int, ignore_empty=True):
    """pred/gt: (B,H,W) int arrays. Returns mIoU over classes present in
    either map."""
    pred = np.asarray(pred_ids).reshape(-1)
    gt = np.asarray(gt_ids).reshape(-1)
    ious = []
    for c in range(num_classes):
        p = pred == c
        g = gt == c
        union = np.logical_or(p, g).sum()
        if union == 0:
            if not ignore_empty:
                ious.append(1.0)
            continue
        inter = np.logical_and(p, g).sum()
        ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0


def pixel_accuracy(pred_ids, gt_ids, mask=None):
    pred = np.asarray(pred_ids)
    gt = np.asarray(gt_ids)
    correct = (pred == gt).astype(np.float64)
    if mask is not None:
        m = np.asarray(mask).astype(np.float64)
        return float((correct * m).sum() / max(m.sum(), 1.0))
    return float(correct.mean())


def segmentation_consistency(pred_ids, gt_ids, boxmask):
    """Pixel accuracy restricted to the edited box; boxmask (B,H,W[,1])."""
    boxmask = np.asarray(boxmask)
    return pixel_accuracy(pred_ids, gt_ids, boxmask[..., 0] if boxmask.ndim == 4 else boxmask)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root of a PSD matrix via eigendecomposition."""
    w, v = np.linalg.eigh(a)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def fid_from_stats(mu1, sigma1, mu2, sigma2, eps=1e-6):
    diff = mu1 - mu2
    # trace(sqrt(s1 s2)) via sqrt(s1) s2 sqrt(s1) (symmetric PSD form)
    s1_sqrt = _sqrtm_psd(sigma1 + eps * np.eye(len(mu1)))
    inner = s1_sqrt @ (sigma2 + eps * np.eye(len(mu2))) @ s1_sqrt
    covmean_trace = np.sqrt(np.clip(np.linalg.eigvalsh(inner), 0.0, None)).sum()
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * covmean_trace)


class RunningStats:
    """Streaming mean/covariance accumulator for feature batches."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(0)
        self.outer += f.T @ f

    def finalize(self):
        if self.n < 2:
            raise ValueError(f"need at least 2 samples for a covariance, got {self.n}")
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


class FIDEvaluator:
    """FID over an injected feature extractor.

    feature_fn: (B,H,W,3) [-1,1] tensor -> (B,D) pooled features, run on
    the images' device; the statistics accumulate on the host."""

    def __init__(self, feature_fn: Callable[[torch.Tensor], torch.Tensor], dim: int):
        self.feature_fn = feature_fn
        self.real = RunningStats(dim)
        self.fake = RunningStats(dim)

    def _features(self, images) -> np.ndarray:
        with torch.inference_mode():
            return self.feature_fn(images).to(torch.float32).cpu().numpy()

    def update(self, real_images=None, fake_images=None):
        if real_images is not None:
            self.real.update(self._features(real_images))
        if fake_images is not None:
            self.fake.update(self._features(fake_images))

    def compute(self) -> float:
        mu_r, s_r = self.real.finalize()
        mu_f, s_f = self.fake.finalize()
        return fid_from_stats(mu_r, s_r, mu_f, s_f)


def vgg_pool_features(vgg: torch.nn.Module):
    """The default feature_fn: relu5_1 of ``networks.Vgg19Features``,
    averaged over H and W."""

    def fn(images):
        return vgg(images)[-1].mean(dim=(1, 2))

    return fn

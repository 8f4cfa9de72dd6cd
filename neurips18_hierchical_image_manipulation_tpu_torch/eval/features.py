"""Instance-feature clustering — the port's own copy of ``eval/features.py``
in the JAX package (pix2pixHD's encode_features path; plain numpy there
and here, apart from running the Encoder):

  1. ``encode_dataset_features``: the trained Encoder over a loader, one
     pooled feature vector per instance, grouped by semantic class;
  2. ``cluster_features``: per-class k-means into ``n_clusters`` centers, an
     (label_nc, n_clusters, feat_num) array (``features_clustered_010.npy``);
  3. ``sample_cluster_features``: at test time, the (B,H,W,feat_num) feature
     map with each instance's region painted with a center of its class.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """Plain numpy k-means (the JAX package's, step for step)."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    if n == 0:
        return np.zeros((k, x.shape[1]), np.float32)
    centers = x[rng.choice(n, size=min(k, n), replace=False)]
    if centers.shape[0] < k:  # fewer samples than clusters: repeat
        reps = -(-k // centers.shape[0])
        centers = np.tile(centers, (reps, 1))[:k]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = centers.copy()
        for j in range(k):
            m = assign == j
            if m.any():
                new[j] = x[m].mean(0)
        if np.allclose(new, centers):
            break
        centers = new
    return centers.astype(np.float32)


def _instance_class(iid) -> int:
    """Things carry class * 1000 + k, stuff regions the class id itself."""
    return int(iid // 1000) if iid >= 1000 else int(iid)


@torch.inference_mode()
def encode_dataset_features(model, loader, max_batches: int = 10_000):
    """-> {class id: [feature vector of each instance]}: the model's Encoder
    on each batch's image (normalized to [-1, 1] when the loader gives
    uint8) over ``inst`` (--instance_feat) or ``label``, as the train step
    runs it; one vector per instance id of ``inst``."""
    feats: Dict[int, List[np.ndarray]] = {}
    use_inst = bool(getattr(model.opt, "instance_feat", False))
    dev = model.device
    for bi, host_batch in enumerate(loader):
        if bi >= max_batches:
            break
        img = np.asarray(host_batch["image"])
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 127.5 - 1.0
        seg = host_batch["inst"] if use_inst else host_batch["label"]
        fmap = model.netE(torch.from_numpy(np.ascontiguousarray(img)).to(dev),
                          torch.from_numpy(np.asarray(seg)).to(dev))
        fmap = fmap.to(torch.float32).cpu().numpy()
        inst_np = np.asarray(host_batch["inst"])
        for b in range(fmap.shape[0]):
            for iid in np.unique(inst_np[b]):
                ys, xs = np.nonzero(inst_np[b] == iid)
                # constant within the instance
                feats.setdefault(_instance_class(iid), []).append(fmap[b, ys[0], xs[0]])
    return feats


def cluster_features(feats: Dict[int, List[np.ndarray]], label_nc: int,
                     n_clusters: int, feat_num: int, seed: int = 0):
    """-> (label_nc, n_clusters, feat_num) cluster-center array."""
    out = np.zeros((label_nc, n_clusters, feat_num), np.float32)
    for cls, vecs in feats.items():
        if 0 <= cls < label_nc and vecs:
            out[cls] = kmeans(np.stack(vecs), n_clusters, seed=seed)
    return out


def sample_cluster_features(clusters: np.ndarray, inst: np.ndarray,
                            rng: np.random.RandomState = None, cluster_idx: int = 0):
    """Paint a (B,H,W,F) feature map from per-class cluster centers: every
    instance region gets one center of its class (drawn from ``rng`` when
    given, else ``cluster_idx``)."""
    label_nc, n_clusters, feat_num = clusters.shape
    b, h, w = inst.shape
    out = np.zeros((b, h, w, feat_num), np.float32)
    for i in range(b):
        for iid in np.unique(inst[i]):
            cls = _instance_class(iid)
            if not 0 <= cls < label_nc:
                continue
            k = rng.randint(n_clusters) if rng is not None else cluster_idx
            out[i][inst[i] == iid] = clusters[cls, k]
    return out

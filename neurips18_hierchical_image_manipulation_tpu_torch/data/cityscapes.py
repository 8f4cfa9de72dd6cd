"""Aligned (label, inst, img) dataset (pix2pixHD data/aligned_dataset.py): ``{dataroot}/{phase}_label`` (nearest-resized id maps),
``{phase}_inst``, ``{phase}_img`` — paired transforms, dict samples.

Returns numpy NHWC samples; all tensor math (one-hot, edges, masking)
runs on the device in the model's encode_input.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict

import numpy as np
from PIL import Image

from .image_folder import make_dataset
from .transforms import apply_transform, get_params, normalize_rgb


def _open_cached(path: str, cache_root: str):
    """Decode-once image open (--decode_cache): the first epoch persists
    the decoded array as an .npy sidecar and later epochs read it back
    instead of inflating the PNG again. mtime-keyed; falls back to a plain
    decode on any error."""
    try:
        st = os.stat(path)
        # Stable digest (NOT Python hash(), which is salt-randomized per
        # process and would defeat the cache across runs).
        digest = hashlib.md5(os.path.abspath(path).encode()).hexdigest()[:16]
        key = f"{digest}_{int(st.st_mtime)}_{st.st_size}"
        # Raw .npy for the common modes (plain np.load, no zipfile/crc32
        # per read); .npz with the palette for 'P'-mode so .convert('RGB')
        # on the reconstruction yields true colors.
        cpath = os.path.join(cache_root, key + ".npy")
        ppath = os.path.join(cache_root, key + ".npz")
        if os.path.exists(cpath):
            arr = np.load(cpath)
            return Image.fromarray(arr, "I" if arr.dtype == np.int32 else None)
        if os.path.exists(ppath):
            with np.load(ppath, allow_pickle=False) as z:
                img = Image.fromarray(z["arr"], "P")
                img.putpalette(z["palette"].tolist())
                return img
        img = Image.open(path)
        img.load()
        arr = np.asarray(img)
        os.makedirs(cache_root, exist_ok=True)
        if img.mode == "P":
            tmp = ppath + f".{os.getpid()}.tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    arr=arr,
                    palette=np.asarray(img.getpalette(), dtype=np.uint8),
                )
            os.replace(tmp, ppath)
        else:
            tmp = cpath + f".{os.getpid()}.tmp.npy"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, cpath)
        return img
    except OSError:
        return Image.open(path)


class AlignedDataset:
    def __init__(self, opt):
        self.opt = opt
        self.root = opt.dataroot
        phase = getattr(opt, "phase", "train")

        self.label_paths = make_dataset(
            os.path.join(self.root, f"{phase}_label"), opt.max_dataset_size
        )
        self.inst_paths = None
        if not opt.no_instance:
            self.inst_paths = make_dataset(
                os.path.join(self.root, f"{phase}_inst"), opt.max_dataset_size
            )
        self.image_paths = None
        img_dir = os.path.join(self.root, f"{phase}_img")
        if os.path.isdir(img_dir):
            self.image_paths = make_dataset(img_dir, opt.max_dataset_size)
        # --load_features: per-image encoder feature maps from {phase}_feat/,
        # keyed by the label file's basename (tools/precompute_feature_maps.py
        # writes them as exact float .npy, JAX data/cityscapes.py:91-102)
        self.feat_dir = None
        if getattr(opt, "load_features", False):
            self.feat_dir = os.path.join(self.root, f"{phase}_feat")
            if not os.path.isdir(self.feat_dir):
                raise FileNotFoundError(
                    f"--load_features set but {self.feat_dir} is missing; run "
                    "tools/precompute_feature_maps.py first")
        self.seed = getattr(opt, "seed", 0)
        self._epoch = 0
        self._cache = (
            os.path.join(self.root, ".decoded_cache")
            if getattr(opt, "decode_cache", False)
            else None
        )
        # In-RAM decoded-array cache (--ram_cache_mb): a hit is a plain
        # Image.fromarray view. Insertion stops when the budget is full
        # (deterministic, no eviction churn).
        self._ram_budget = int(getattr(opt, "ram_cache_mb", 0)) * 1_000_000
        self._ram: Dict[str, tuple] = {}
        self._ram_bytes = 0
        self._ram_lock = threading.Lock()

    def _open(self, path):
        if self._ram_budget > 0:
            hit = self._ram.get(path)
            if hit is not None:
                arr, mode = hit
                return Image.fromarray(arr, "I" if mode == "I" else None)
        if self._cache is not None:
            img = _open_cached(path, self._cache)
        else:
            img = Image.open(path)
            img.load()
        if self._ram_budget > 0 and img.mode != "P":
            arr = np.asarray(img)
            # check-then-insert under a lock: the loader's thread pool can
            # race two workers on the same path, double-counting nbytes
            # (the stale counter then starves the cache for the process
            # lifetime) and overshooting the budget
            with self._ram_lock:
                if (
                    path not in self._ram
                    and self._ram_bytes + arr.nbytes <= self._ram_budget
                ):
                    self._ram[path] = (arr, img.mode)
                    self._ram_bytes += arr.nbytes
        return img

    def set_epoch(self, epoch: int) -> None:
        """Augmentation draws are a pure function of (seed, epoch, index) —
        thread-safe under the loader's worker pool and independent of
        scheduling order (no shared mutable RandomState)."""
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.RandomState:
        mix = (self.seed + 1) * 2654435761 + self._epoch * 40503 + index * 97
        return np.random.RandomState(mix % (2**31 - 1))

    def __len__(self):
        return len(self.label_paths)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        label_img = self._open(self.label_paths[index])
        params = get_params(self.opt, label_img.size, self._item_rng(index))

        u8 = getattr(self.opt, "uint8_transfer", False)
        label = apply_transform(label_img, self.opt, params, Image.NEAREST)
        label_ids = np.asarray(label).astype(np.uint8 if u8 else np.int32)
        if label_ids.ndim == 3:
            label_ids = label_ids[..., 0]

        sample = {"label": label_ids, "path": self.label_paths[index]}

        if self.inst_paths is not None:
            inst = apply_transform(
                self._open(self.inst_paths[index]), self.opt, params, Image.NEAREST
            )
            inst_ids = np.asarray(inst).astype(np.uint16 if u8 else np.int32)
            if inst_ids.ndim == 3:
                inst_ids = inst_ids[..., 0]
            sample["inst"] = inst_ids
        else:
            sample["inst"] = np.zeros_like(label_ids)

        if self.image_paths is not None:
            rgb = apply_transform(
                self._open(self.image_paths[index]).convert("RGB"),
                self.opt,
                params,
                Image.BICUBIC,
            )
            arr = np.asarray(rgb)
            sample["image"] = arr if u8 else normalize_rgb(arr)

        if self.feat_dir is not None:
            stem = os.path.splitext(os.path.basename(self.label_paths[index]))[0]
            feat = np.load(os.path.join(self.feat_dir, stem + ".npy"))
            # piecewise constant per instance: NEAREST is exact; each channel
            # an 'F' image under the label's (crop, flip) draw
            sample["feat"] = np.stack([
                np.asarray(apply_transform(
                    Image.fromarray(feat[..., c].astype(np.float32), mode="F"),
                    self.opt, params, Image.NEAREST), np.float32)
                for c in range(feat.shape[-1])], -1)
        return sample

"""Data-loader factory (pix2pixHD CreateDataLoader).

Batches dataset samples into stacked numpy NHWC arrays with background
thread prefetch (threads hide PIL decode latency; the tensor math runs on
the device). ``shuffle = not serial_batches``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def _collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals
        else:
            out[key] = np.stack(vals)
    return out


class DataLoader:
    """Thread-pool prefetching loader.

    ``num_threads`` workers run ``dataset.__getitem__`` concurrently
    (per-SAMPLE futures, so even a single in-flight batch parallelizes);
    at most ``prefetch`` batches are in flight, yielded strictly in order.
    Determinism: datasets must not draw from shared mutable RNG state in
    ``__getitem__`` — augmentation seeds derive from ``(epoch, index)``
    via ``dataset.set_epoch`` (see AlignedDataset), so sample contents are
    independent of worker scheduling.
    """

    def __init__(self, dataset, batch_size=1, shuffle=True, seed=0,
                 drop_last=True, prefetch=2, num_threads=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.num_threads = max(1, num_threads)
        self.rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        batches = list(self._index_batches())

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            inflight: deque = deque()  # deque of lists of per-sample futures

            def submit(batch_idx):
                inflight.append(
                    [pool.submit(self.dataset.__getitem__, int(i)) for i in batch_idx]
                )

            b = 0
            while b < len(batches) and len(inflight) < self.prefetch:
                submit(batches[b])
                b += 1
            while inflight:
                futs = inflight.popleft()
                if b < len(batches):
                    submit(batches[b])
                    b += 1
                yield _collate([f.result() for f in futs])


def CreateDataLoader(opt, records=None):
    """opt.model / --use_bbox_dataset select the dataset family (aligned
    scenes vs bbox-crop windows). ``--load_features`` reads precomputed
    feature maps into the aligned scenes' samples. The device-resident and
    grain loaders of the JAX package are not ported yet."""
    bbox = getattr(opt, "model", "pix2pixHD") == "box2mask" or getattr(
        opt, "use_bbox_dataset", False)
    if getattr(opt, "load_features", False):
        if getattr(opt, "device_resident_data", False):
            # the JAX package's refusal (its resident stores hold no maps)
            raise ValueError(
                "--device_resident_data does not support --load_features; "
                "drop one of the two (on-the-fly --instance_feat works)"
            )
        if bbox:
            # the JAX package's bbox windows carry no maps and silently train
            # on the Encoder's features instead: refused here
            raise ValueError(
                "--load_features reads {phase}_feat maps into aligned scenes; pass "
                "--no-use_bbox_dataset (the bbox-window dataset carries no feature maps)"
            )
    if getattr(opt, "device_resident_data", False):
        raise NotImplementedError(
            "--device_resident_data is not ported yet: it waits for ROADMAP.md §A.7")
    if getattr(opt, "data_backend", "threads") != "threads":
        raise NotImplementedError(
            f"--data_backend {opt.data_backend} is not ported yet (use threads)"
        )
    if bbox:
        from .bbox import BboxCropDataset

        ds = BboxCropDataset(opt, records=records)
    else:
        from .cityscapes import AlignedDataset

        ds = AlignedDataset(opt)
    return DataLoader(
        ds,
        batch_size=opt.batchSize,
        shuffle=not opt.serial_batches,
        seed=getattr(opt, "seed", 0),
        num_threads=opt.nThreads,
    )

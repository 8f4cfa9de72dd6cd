"""The grain host pipeline (``--data_backend grain``): checkpointable
epoch iterators with decode in worker processes (``--grain_workers N``).

Counterpart of ``data/grain_pipeline.py`` in the JAX package, whose
``GrainLoader`` iterates the chain

    source(dataset) -> seed(base_seed + epoch) -> [shuffle] -> batch(_collate)

through the ``grain`` package. This module needs no such package: it keeps
its own copy of what that chain does, so both loaders yield the same
batches in the same order.

* **The order.** ``MapDataset.seed(s)`` followed by ``.shuffle()`` gives the
  shuffle the seed ``SeedSequence([s, 1]).generate_state(1, uint32)[0]`` (1:
  the shuffle node's distance to the seeded node; ``derived_seed``), and
  the shuffle puts source item ``index_shuffle(i, n - 1, seed, rounds=4)``
  at position ``i``. ``index_shuffle`` is a Simon block cipher (``rounds``
  keys of ``std::seed_seq{seed}.generate``, half-words of at least 8 bits)
  that walks the cycle until the value falls in ``[0, n - 1]``; this file
  holds it in numpy (``index_shuffle``, ``shuffled_order``).
* **Checkpointable iteration.** ``epoch_iterator(epoch)`` returns an
  iterator with ``get_state()`` (``{"next_index": k}``: the batches the
  consumer has taken, not the workers' read-ahead) and ``set_state()``,
  which continues at batch ``k``, on a fresh iterator too.
* **Worker processes.** ``num_workers > 0`` runs ``dataset.__getitem__`` and
  the collate in that many forked processes (``torch.utils.data.DataLoader``
  over the epoch's index batches, ``prefetch_factor=per_worker_buffer``),
  yielded in order, so any worker count gives the batches of
  ``num_workers=0``. Each request carries its epoch, so a worker's copy of
  the dataset draws that epoch's augmentation. A worker stacks each batch
  into one torch tensor in shared memory (one file descriptor to hand
  over), and the parent hands out numpy views of it. The workers never
  touch the card: a forked child of a process that made a CUDA context
  cannot make one, and each request checks that the worker holds none.
  ``data/native``'s C++ tier is built and loaded in the parent before the
  workers start, which inherit it.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils import data as tud

from .loader import _collate

ROUNDS = 4          # grain's ShuffleMapDataset: index_shuffle(..., rounds=4)
_SHARED = "__shared_batch__"
_ALIGN = 64         # each array's offset in a shared batch
MIN_BLOCK_BITS = 16
_M32 = 0xFFFFFFFF


def derived_seed(seed: int) -> int:
    """The shuffle's seed under ``MapDataset.seed(seed).shuffle()``."""
    return int(np.random.SeedSequence([int(seed), 1]).generate_state(1, np.uint32)[0])


def seed_seq_generate(values: List[int], n: int) -> List[int]:
    """``std::seed_seq(values).generate`` of n 32-bit words."""
    v = [int(x) & _M32 for x in values]
    b = [0x8B8B8B8B] * n
    if n == 0:
        return b
    s, m = len(v), max(len(v) + 1, n)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p, q = (n - t) // 2, (n - t) // 2 + t
    for k in range(m):
        x = b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]
        r1 = (1664525 * (x ^ (x >> 27))) & _M32
        r2 = (r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        x = (b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32
        r3 = (1566083941 * (x ^ (x >> 27))) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def block_bits(max_index: int) -> int:
    """The cipher's block: ceil(log2(max_index)) made even, at least 16."""
    bits = int(math.ceil(math.log2(max_index)))
    return max(bits + bits % 2, MIN_BLOCK_BITS)


def simon_encrypt(x: np.ndarray, keys: List[int], half_bits: int) -> np.ndarray:
    """The cipher on uint64 values: two half-words of ``half_bits`` (the
    high half truncated to them, as a ``std::bitset`` is), two keys a round
    pair."""
    w = half_bits
    mask = np.uint64((1 << w) - 1)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(w - r))) & mask

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    x = np.asarray(x, np.uint64)
    left, right = (x >> np.uint64(w)) & mask, x & mask
    for i in range(0, len(keys) - 1, 2):
        left = left ^ f(right) ^ (np.uint64(keys[i]) & mask)
        right = right ^ f(left) ^ (np.uint64(keys[i + 1]) & mask)
    return (left << np.uint64(w)) | right


def _walk_table(bits: int, keys: List[int]) -> List[int]:
    return simon_encrypt(np.arange(1 << bits, dtype=np.uint64), keys, bits // 2).tolist()


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = ROUNDS) -> int:
    """Position ``index``'s item under the permutation of [0, max_index]."""
    return int(_shuffle(np.array([index], np.uint64), max_index, seed, rounds)[0])


def shuffled_order(n: int, seed: int, rounds: int = ROUNDS) -> np.ndarray:
    """[index_shuffle(i, n - 1, seed) for i in range(n)]."""
    return _shuffle(np.arange(n, dtype=np.uint64), n - 1, seed, rounds)


def _shuffle(index: np.ndarray, max_index: int, seed: int, rounds: int) -> np.ndarray:
    """The first step on the indices themselves (one past the block keeps
    only its low bits of each half, as the cipher's bitsets do), the cycle
    walks on one table of the cipher over its block: walks from distinct
    starts are disjoint, so they take at most 2**bits < 4n steps together."""
    if max_index <= 0:
        return np.zeros(len(index), np.int64)
    bits = block_bits(max_index)
    keys = seed_seq_generate([seed], rounds)
    out = simon_encrypt(index, keys, bits // 2).tolist()
    table = None
    for i, y in enumerate(out):
        while y > max_index:
            table = table or _walk_table(bits, keys)
            y = table[y]
        out[i] = y
    return np.asarray(out, np.int64)


# --- worker processes ------------------------------------------------------

def worker_init(worker_id: int) -> None:
    """Each worker process starts here (``worker_init_fn``)."""
    _check_no_cuda()


def _call_worker_init(worker_id: int) -> None:
    # looked up at call time, so a probe set on the module reaches the workers
    worker_init(worker_id)


def _check_no_cuda() -> None:
    if torch.cuda.is_initialized():
        raise RuntimeError("a grain worker process holds a CUDA context; the workers "
                           "decode on the host only")


class _EpochRequests:
    """The dataset as the workers see it: a request is (epoch, indices)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.epoch: Optional[int] = None

    def __getitem__(self, request):
        epoch, indices = request
        if epoch != self.epoch and hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self.epoch = epoch
        samples = [self.dataset[int(i)] for i in indices]
        _check_no_cuda()
        return samples


def _collate_shared(samples) -> Dict:
    """``_collate`` stacked straight into one torch uint8 tensor in shared
    memory: the batch crosses to the parent as one file descriptor (each
    descriptor costs a handshake with the worker), its arrays as a layout
    of (key, dtype, shape, offset), its strings pickled."""
    out, layout, nbytes = {}, [], 0
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals
            continue
        first = np.asarray(vals[0])
        shape = (len(vals),) + first.shape
        layout.append((key, first.dtype.str, shape, nbytes))
        nbytes += -(-first.dtype.itemsize * int(np.prod(shape)) // _ALIGN) * _ALIGN
        out[key] = None   # keeps the key's place
    buf = torch.empty(max(nbytes, 1), dtype=torch.uint8).share_memory_()
    view = buf.numpy()
    for key, dtype, shape, offset in layout:
        np.stack([s[key] for s in samples],
                 out=np.ndarray(shape, dtype, buffer=view, offset=offset))
    out[_SHARED] = (buf, layout)
    return out


def _unpack(batch) -> Dict:
    """The parent's side of ``_collate_shared``: numpy views of the buffer."""
    if _SHARED not in batch:
        return batch
    buf, layout = batch.pop(_SHARED)
    view = buf.numpy()
    for key, dtype, shape, offset in layout:
        batch[key] = np.ndarray(shape, dtype, buffer=view, offset=offset)
    return batch


class EpochIterator:
    """One epoch's batches in order, with ``get_state`` / ``set_state``."""

    def __init__(self, loader: "GrainLoader", epoch: int):
        self.loader, self.epoch = loader, epoch
        self.batches = loader.index_batches(epoch)
        self.next_index = 0
        self._workers = None

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.next_index >= len(self.batches):
            self.close()
            raise StopIteration
        if self.loader.num_workers == 0:
            ds = self.loader.dataset
            batch = _collate([ds[int(i)] for i in self.batches[self.next_index]])
        else:
            if self._workers is None:
                self._workers = iter(self.loader.worker_loader(self.epoch,
                                                               self.batches[self.next_index:]))
            try:
                batch = _unpack(next(self._workers))
            except BaseException:
                self.close()   # a worker raised: stop every worker now, not at gc
                raise
        self.next_index += 1
        return batch

    def get_state(self) -> Dict[str, int]:
        return {"next_index": self.next_index}

    def set_state(self, state: Dict[str, int]) -> None:
        """Continue at batch ``state["next_index"]`` (workers restart there)."""
        self.close()
        self.next_index = int(state["next_index"])

    def close(self) -> None:
        """Stop the workers (an abandoned iterator's stop when it is freed)."""
        workers, self._workers = self._workers, None
        if workers is not None and hasattr(workers, "_shutdown_workers"):
            workers._shutdown_workers()


class GrainLoader:
    """The grain pipeline's loader with the DataLoader interface
    (``__len__`` / ``__iter__`` / ``first_batch``)."""

    def __init__(self, dataset, batch_size=1, shuffle=True, seed=0, drop_last=True,
                 num_workers=0, per_worker_buffer=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.per_worker_buffer = max(1, int(per_worker_buffer))
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def first_batch(self) -> Dict[str, np.ndarray]:
        """One batch for model init, loaded synchronously: consumes no
        shuffle or epoch state."""
        n = min(self.batch_size, len(self.dataset))
        return _collate([self.dataset[i] for i in range(n)])

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The dataset's indices in the epoch's order."""
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n, dtype=np.int64)
        return shuffled_order(n, derived_seed(self.seed + epoch))

    def index_batches(self, epoch: int) -> List[np.ndarray]:
        order = self.epoch_order(epoch)
        return [order[b * self.batch_size:(b + 1) * self.batch_size] for b in range(len(self))]

    def worker_loader(self, epoch: int, batches: List[np.ndarray]):
        """A ``torch.utils.data.DataLoader`` that makes ``batches`` of
        ``epoch`` in ``num_workers`` forked processes, in order."""
        from . import native

        native.available()   # build and load the C++ tier once, before the fork
        return tud.DataLoader(
            _EpochRequests(self.dataset), batch_size=None,
            sampler=[(epoch, b) for b in batches],
            collate_fn=_collate_shared,
            num_workers=self.num_workers, prefetch_factor=self.per_worker_buffer,
            multiprocessing_context="fork", worker_init_fn=_call_worker_init)

    def epoch_iterator(self, epoch: int) -> EpochIterator:
        """The epoch's iterator; supports ``get_state()`` / ``set_state()``."""
        if hasattr(self.dataset, "set_epoch"):
            # the in-process path (num_workers 0) and first_batch read it; the
            # workers take the epoch from each request
            self.dataset.set_epoch(epoch)
        return EpochIterator(self, epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        return self.epoch_iterator(epoch)

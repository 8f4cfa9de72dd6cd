"""Host-to-device prefetch: stage batch N+1 while step N runs.

Counterpart of ``train/prefetch.py`` in the JAX package, with its contract:
``device_prefetch`` yields ``(put_fn(batch), batch)`` in the loader's
order, running ``put_fn`` up to ``depth`` batches ahead on a worker thread;
an exception of the loader or of ``put_fn`` re-raises at the consumer's
``next()``; the worker stops when the consumer abandons the iterator; and
``depth <= 0`` is the synchronous path, with no thread.

On a CUDA device ``H2DStager`` is the ``put_fn``: it copies the batch from
pinned host memory with ``non_blocking=True`` on a stream of its own and
records an event there. ``ready`` makes the consuming stream wait on that
event before the step reads the batch, and marks the batch's memory as in
use by that stream (``record_stream``), so the caching allocator does not
hand it to the next staged copy while the step still reads it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Tuple

import torch

_SENTINEL = object()


def to_device(host_batch, device):
    """A loader batch as device tensors: numpy arrays copied, tensors moved
    (a resident batch is already there), lists (paths) dropped."""
    out = {}
    for k, v in host_batch.items():
        if isinstance(v, list):
            continue
        out[k] = v.to(device) if torch.is_tensor(v) else torch.from_numpy(v).to(device)
    return out


class Staged:
    """A batch whose copy to the device was queued on a side stream."""

    def __init__(self, tensors, event, device):
        self.tensors, self.event, self.device = tensors, event, device

    def wait(self):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class H2DStager:
    """``put_fn`` for a CUDA device: pinned memory, an asynchronous copy on
    a side stream, an event after it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def __call__(self, host_batch) -> Staged:
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {}
            for k, v in host_batch.items():
                if isinstance(v, list):
                    continue
                t = v if torch.is_tensor(v) else torch.from_numpy(v)
                if t.device.type == "cpu":
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return Staged(out, event, self.device)


def ready(staged):
    """The batch ``device_prefetch`` handed out, safe to read on the
    current stream."""
    return staged.wait() if isinstance(staged, Staged) else staged


def device_prefetch(host_iter: Iterable, put_fn: Callable,
                    depth: int = 2) -> Iterator[Tuple[object, object]]:
    """Yield ``(put_fn(batch), batch)`` pairs, running ``put_fn`` up to
    ``depth`` batches ahead on a worker thread (``depth <= 0``: inline)."""
    if depth <= 0:
        for hb in host_iter:
            yield put_fn(hb), hb
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # a put that gives up once the consumer is gone: a plain put would
        # block forever on a full queue, holding `depth` staged batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for hb in host_iter:
                if stop.is_set():
                    return
                if not _put((put_fn(hb), hb)):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 (re-raised at the consumer)
            _put(e)

    t = threading.Thread(target=worker, daemon=True, name="himan-h2d-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # the consumer is done or gone: stop the worker, then drain so that
        # a put it is blocked in returns
        stop.set()
        if t.is_alive():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

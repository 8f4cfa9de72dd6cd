"""Tracing and throughput: ``--profile_dir`` and the loss line's
``img_per_s_per_chip`` (counterpart of ``train/profiler.py`` in the JAX
package).

``trace(logdir)`` records what runs inside it with ``torch.profiler``
(the CPU, and the card's kernels and copies where there is a card) and
writes a Chrome / TensorBoard trace file under ``logdir``. The meter and
``measure_steps`` synchronize the card before they read the clock, so a
time covers the work queued, not its enqueueing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler over the block, its trace written under ``logdir``
    (``{host}_{pid}.{ms}.pt.trace.json``); a no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
    print(f"[profile] trace written under {logdir}", flush=True)


class ThroughputMeter:
    """Images a second a chip over a window of train steps (JAX
    ``ThroughputMeter``, ``profiler.py:28-50``): ``tick()`` after each step
    returns the last full window's rate of the global batch divided by
    ``n_chips`` (0 before the first window ends)."""

    def __init__(self, batch_size: int, n_chips: int = 1, window: int = 50, device=None):
        self.batch_size = batch_size
        self.n_chips = max(n_chips, 1)
        self.window = max(window, 1)
        self.device = device
        self._t0 = None
        self._count = 0
        self.value = 0.0

    def tick(self) -> float:
        if self._t0 is None:
            _sync(self.device)
            self._t0 = time.perf_counter()
            return self.value
        self._count += 1
        if self._count >= self.window:
            _sync(self.device)
            now = time.perf_counter()
            self.value = self.batch_size * self._count / (now - self._t0) / self.n_chips
            self._t0 = now
            self._count = 0
        return self.value


def measure_steps(step_fn, state, batch, iters: int = 20, device=None):
    """Seconds a step of ``step_fn(state, batch)``, over ``iters`` steps
    after one warm-up, the card synchronized before each clock reading."""
    step_fn(state, batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(state, batch)
    _sync(device)
    return (time.perf_counter() - t0) / iters

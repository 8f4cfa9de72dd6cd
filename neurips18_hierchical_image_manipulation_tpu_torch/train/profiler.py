"""Tracing and throughput: ``--profile_dir`` and the loss line's
``img_per_s_per_chip`` (counterpart of ``train/profiler.py`` in the JAX
package).

``trace(logdir)`` records what runs inside it with ``torch.profiler``
(the CPU, and the card's kernels and copies where there is a card) and
writes a Chrome / TensorBoard trace file under ``logdir``, and beside it
``spans.json``, the spans of the traced block, whose table it prints. The
meter and ``measure_steps`` synchronize the card before they read the
clock, so a time covers the work queued, not its enqueueing.

``span(name, timed=False)`` names a phase of the program: the train step
(``himan.step`` and its phases ``himan.step.sample``, ``.cast``,
``.forward`` with ``.forward.{encode,G,D,VGG}``, ``.backward``,
``.all_reduce``, ``.optimizer``) and the serving forward (``himan.infer``,
``himan.infer.encode``, ``himan.infer.G``). It records only while a
profiler runs; otherwise, under ``torch.export`` and while the current
CUDA stream captures a graph, it is one flag check. Recording, it opens a
``record_function`` range (the span sits in the profiler's trace, on the
device trace's clock) and adds to a table kept by name: ``count``,
``host_s`` (enter to exit on the host's clock), ``device_s`` and
``parent`` (the enclosing span). A ``timed`` span (the roots and the
phases a benchmark metric reads) also records a pair of CUDA events on the
current stream where the card is in use: its ``device_s`` sums their times
when the table is read, after a sync (the stream's time from the work
queued before the span to its last kernel, idle included), and is None for
the others and without a card. ``span_table()`` reads the table,
``reset_spans()`` empties it and ``write_spans(path)`` writes it as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd.profiler import record_function


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
    reset_spans()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
    table = span_table()
    write_spans(os.path.join(logdir, "spans.json"))
    print(f"[profile] trace written under {logdir}", flush=True)
    print(f"[profile] {'span':<26} {'count':>5} {'host ms':>9} {'device ms':>10}  parent",
          flush=True)
    for name, e in table.items():
        dev = "-" if e["device_s"] is None else f"{1e3 * e['device_s']:.3f}"
        print(f"[profile] {name:<26} {e['count']:>5} {1e3 * e['host_s']:>9.3f} {dev:>10}  "
              f"{e['parent'] or '-'}", flush=True)


class _Off:
    """What ``span`` returns when it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, a, b, c):
        return None


_OFF = _Off()
_is_exporting = torch.compiler.is_exporting
_profiler_enabled = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_table = {}     # name -> {count, host_s, device_s, parent, pending: [(start, end) events]}
_open = threading.local()


def span(name: str, timed: bool = False):
    """A context manager naming a phase of the program (module docstring);
    a no-op unless a profiler runs, outside an export and a graph capture.
    ``timed``: also time it on the card."""
    if _is_exporting() or not _profiler_enabled():
        return _OFF
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _OFF
    return _Span(name, timed and torch.cuda.is_initialized())


class _Span:
    __slots__ = ("name", "parent", "range", "events", "t0")

    def __init__(self, name, timed):
        self.name = name
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) if timed else None)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        with _lock:
            _entry(self.name, self.parent)    # the table's order: first entered
        self.range = record_function(self.name)
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter()

    def __exit__(self, a, b, c):
        host_s = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(a, b, c)
        _open.stack.pop()
        with _lock:
            e = _entry(self.name, self.parent)
            e["count"] += 1
            e["host_s"] += host_s
            if self.events is not None:
                e["pending"].append(self.events)


def _entry(name, parent):
    e = _table.get(name)
    if e is None:
        e = _table[name] = {"count": 0, "host_s": 0.0, "device_s": None, "parent": parent,
                            "pending": []}
    return e


def span_table():
    """{name: {count, host_s, device_s, parent}} of the spans recorded since
    the last ``reset_spans``, in the order first entered; ``device_s`` sums
    the CUDA events' times (waiting for the last), None where none was
    recorded."""
    with _lock:
        for e in _table.values():
            for start, end in e["pending"]:
                end.synchronize()
                e["device_s"] = (e["device_s"] or 0.0) + start.elapsed_time(end) / 1e3
            e["pending"] = []
        return {k: {f: e[f] for f in ("count", "host_s", "device_s", "parent")}
                for k, e in _table.items()}


def reset_spans() -> None:
    """Forget every span recorded so far."""
    with _lock:
        _table.clear()


def write_spans(path: str) -> None:
    """``span_table()`` as JSON at ``path``."""
    with open(path, "w") as f:
        json.dump(span_table(), f, indent=1)


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

"""A profiled sub-window and what is read from its trace.

``profiled(fn, n, device)`` runs ``fn`` n times under ``torch.profiler``
(the card synchronized at both ends) and returns a ``Trace``: every device
operation (kernels, copies, sets) with its name, start and length, the
host's operations, and the window's length on the host clock. The kernel
classes are a frozen copy of the port's ``tools/profile_decode.KERNEL_CLASSES``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import torch

KERNEL_CLASSES = (
    ("port kernels", ("in_fwd_", "in_bwd_", "reflect_pad_bwd_", "loss_group_kernel",
                      "encode_kernel", "conv_wgmma_kernel", "conv_mma_kernel",
                      "conv_fma_kernel", "conv_splitk_reduce_kernel",
                      "conv_in_normalize_kernel", "reflect_pad1_kernel")),
    ("layout conversion (cuDNN)", ("nhwctonchw", "nchwtonhwc", "nchwaddpadding",
                                   "converttensor", "transpose_readwrite",
                                   "scalepackedtensor")),
    ("conv weight gradient", ("wgrad",)),
    ("conv data gradient", ("dgrad",)),
    ("conv forward / other conv algorithms", ("fprop", "fft", "winograd", "implicit_convolve",
                                              "implicit_gemm", "conv", "sgemm", "gemv",
                                              "gemm", "xmma", "cutlass", "cudnn",
                                              "pointwise_mult_and_sum_complex")),
    ("Adam (multi-tensor)", ("multi_tensor", "adam")),
    ("aten reflection pad", ("reflection_pad",)),
    ("pools", ("pool",)),
    ("concatenation and copies", ("catarray", "copy", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reductions", ("reduce", "welford", "norm_kernel")),
    ("indexing and scatter", ("index", "gather", "scatter")),
    ("random", ("distribution", "philox")),
)
UNCLASSIFIED = "other"
CONV_CLASSES = ("conv weight gradient", "conv data gradient",
                "conv forward / other conv algorithms")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return kind
    return UNCLASSIFIED


class Trace:
    def __init__(self, events, window_s: float, calls: int):
        self.window_s, self.calls = window_s, calls
        self.device = sorted(((e["name"], e["ts"] / 1e6, e["dur"] / 1e6) for e in events
                              if e.get("cat") in DEVICE_CATS and "dur" in e),
                             key=lambda t: t[1])
        self.host = [(e["name"], e["ts"] / 1e6, e.get("dur", 0) / 1e6) for e in events
                     if e.get("cat") in ("cpu_op", "python_function", "user_annotation")]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device operations' intervals)."""
        busy, end = 0.0, None
        for _, ts, dur in self.device:
            if end is None or ts > end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy

    def seconds_where(self, pred) -> float:
        return sum(dur for name, _, dur in self.device if pred(name))

    def by_class(self):
        out = defaultdict(float)
        for name, _, dur in self.device:
            out[kernel_class(name)] += dur
        return sorted(out.items(), key=lambda kv: -kv[1])

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device operations, each named by the
        host operation running at the gap's middle (the shortest one that
        covers it)."""
        gaps, end = [], None
        for _, ts, dur in self.device:
            if end is not None and ts > end:
                gaps.append((end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            cover = [(dur, name) for name, ts, dur in self.host if ts <= mid <= ts + dur]
            out.append([min(cover)[1] if cover else "host: no operation", b - a])
        return out


def profiled(fn, n: int, device, trace_dir: str) -> Trace:
    """``fn()`` n times under the profiler -> the Trace of that window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    path = os.path.join(trace_dir, "trace.json")
    print(f"port_bench: profiled {n} calls in {window_s:.3f} s", file=sys.stderr, flush=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return Trace(events, window_s, n)

"""Decode a step's CUDA kernel names into classes.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.profile_decode \\
        [TRACE] [--top 40] [--out FILE]

Counterpart of ``tools/profile_decode.py`` in the JAX package, which
decoded XLA fusion names against the compiled HLO. A CUDA step has no HLO:
its device work is named by the kernels themselves (cuDNN's and CUTLASS's
``sm90_*`` convolution families, cuDNN's layout conversions, PyTorch's
multi-tensor Adam and element-wise kernels, the port's own kernels), so
the decoding is a classification of names. ``KERNEL_CLASSES`` is the one
classification of the repository: ``chip_smoke.py``'s profiles and
``tools/trace_attrib.py`` use it.

TRACE is a ``torch.profiler`` Chrome trace (``*.pt.trace.json``, or
``.json.gz``), or a directory searched for the newest one (default
``$TMPDIR/himan_prof``, where ``tools/trace_attrib.py`` writes). The
report gives device ms by class, the top kernels with their classes and
every unclassified kernel by name, as JSON (and to ``--out``).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import tempfile
from collections import defaultdict

DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "himan_prof")

# (class, substrings of the lower-cased kernel name): the first class with
# a matching substring wins, so the specific families come before the
# generic ones
KERNEL_CLASSES = (
    ("port kernels", ("in_fwd_", "in_bwd_", "reflect_pad_fwd_", "reflect_pad_bwd_",
                      "loss_group_kernel", "encode_kernel", "conv_wgmma_kernel",
                      "conv_mma_kernel", "conv_fma_kernel", "conv_splitk_reduce_kernel",
                      "conv_in_normalize_kernel", "reflect_pad1_kernel")),
    ("layout conversion (cuDNN)", ("nhwctonchw", "nchwtonhwc", "nchwaddpadding",
                                   "converttensor", "transpose_readwrite",
                                   "scalepackedtensor")),
    ("conv weight gradient", ("wgrad",)),
    ("conv data gradient", ("dgrad",)),
    ("conv forward / other conv algorithms", ("fprop", "fft", "winograd", "implicit_convolve",
                                              "implicit_gemm", "conv", "sgemm", "gemv",
                                              "gemm", "xmma", "cutlass", "cudnn",
                                              # cuDNN's FFT convolution's product stage
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


def kernel_kind(name: str) -> str:
    """The class of a device kernel's name (``UNCLASSIFIED`` if none)."""
    low = name.lower()
    for kind, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return kind
    return UNCLASSIFIED


def kernel_tag(name: str) -> str:
    """A kernel's function name without its return type, namespace of no
    name, template arguments and arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return base.replace("void ", "").strip()


def is_conv(kind: str) -> bool:
    return kind.startswith("conv ")


def profile_by_kind(fn, n, tag, host_ms_each, results):
    """Device time by kernel over n calls of fn (warmed up by the caller),
    grouped by kind, against the unprofiled host-clock ms of one call; the
    idle share is 1 - device / host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    print(table, flush=True)
    kinds = {}
    for e in avgs:
        if e.device_type == DeviceType.CUDA:  # kernel rows only: no double count
            us = getattr(e, "self_device_time_total", 0) / n
            kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) + us / 1e3
    dev_ms = sum(kinds.values())
    kinds = dict(sorted(kinds.items(), key=lambda kv: -kv[1]))
    idle = max(0.0, 1 - dev_ms / host_ms_each)
    print(f"[{tag}] device ms per call by kind: "
          f"{ {k: round(v, 4) for k, v in kinds.items()} }", flush=True)
    print(f"[{tag}] device busy {dev_ms:.3f} ms per call; unprofiled {host_ms_each:.3f} ms; "
          f"idle share {idle:.3f}", flush=True)
    results[tag.replace(" ", "_")] = dict(table=table, device_ms=dev_ms, by_kind=kinds,
                                          unprofiled_ms=host_ms_each, idle_share=idle)


def newest_trace(path: str) -> str:
    """``path`` itself, or the newest ``*.pt.trace.json[.gz]`` under it."""
    if os.path.isfile(path):
        return path
    found = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not found:
        raise FileNotFoundError(f"no Chrome trace under {path}")
    return max(found, key=os.path.getmtime)


def load_trace(path: str) -> list:
    """The trace events of a Chrome trace file (or the newest under a
    directory)."""
    path = newest_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def kernel_events(events) -> list:
    """The device kernels of a trace (complete events of category
    ``kernel``; memcpy and memset are not kernels)."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]


def decode(events, steps: int = 1, top: int = 40) -> dict:
    """Device ms a step by class, the ``top`` kernels by time, and every
    unclassified kernel by name (ms a step)."""
    by_name = defaultdict(float)
    for e in kernel_events(events):
        by_name[e.get("name", "?")] += float(e.get("dur", 0.0)) / 1e3 / steps
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[kernel_kind(name)] += ms
    total = sum(by_name.values())
    other = {n: ms for n, ms in by_name.items() if kernel_kind(n) == UNCLASSIFIED}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "steps": steps,
        "device_ms_per_step": total,
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "unclassified_pct": 100.0 * by_class.get(UNCLASSIFIED, 0.0) / total if total else 0.0,
        "unclassified_kernels": [{"name": n, "ms_per_step": ms}
                                 for n, ms in sorted(other.items(), key=lambda kv: -kv[1])],
        "top_kernels": [{"name": n, "class": kernel_kind(n), "ms_per_step": ms}
                        for n, ms in ranked[:top]],   # top None: every kernel
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="?", default=DEFAULT_TRACE_DIR,
                   help="a Chrome trace file, or a directory holding one")
    p.add_argument("--steps", type=int, default=1, help="steps the trace holds")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--out", default="", help="also write the report to this JSON file")
    args = p.parse_args(argv)
    report = decode(load_trace(args.trace), args.steps, args.top)
    report["trace"] = newest_trace(args.trace)
    print("== class aggregates (ms a step) ==")
    for k, ms in report["by_class_ms"].items():
        print(f"{ms:10.3f} ms  {k}")
    print(f"unclassified: {report['unclassified_pct']:.2f} % of device time")
    for r in report["unclassified_kernels"]:
        print(f"   {r['ms_per_step']:9.4f} ms  {r['name'][:160]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the CUDA cards the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``port_bench/configs/<name>.json``) and a traffic mix
(``port_bench/traffic/<name>.json``), whose ``kind`` names the code that
drives it (``port_bench/kinds/<kind>.py``); the limits of the cell's
correctness check are ``port_bench/limits/<workload>.json``, each
per-layer metric is read by ``port_bench/metrics/<metric>.py``, and the
configuration's ``model`` is the module of ``port_bench/reference/`` that
declares it (its reference, seeded weights' shapes and counts).

A run makes its scenes and weights from ``--seed``, warms up the cell's
shapes (set-up, ``setup_s``), measures for ``--seconds``, and with
``--trace 1`` profiles a short sub-window after it for the per-layer
metrics. Then it frees the program's state and checks what the timed path
produced against the plain reference. The last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``, each compared number
with its limit (also the last lines of standard error). It refuses, with no
result, where there is no CUDA card or fewer than the cell asks for, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# nothing the port loads may pull in JAX through a library's optional backend
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# build caches at fixed paths inside the checkout (the port's own nvcc
# libraries already live in its _build/)
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      ".port_bench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))

import torch  # noqa: E402

from port_bench import common, faults  # noqa: E402
from port_bench.reference import registry  # noqa: E402
from port_bench.trace import profiled  # noqa: E402


class Refused(RuntimeError):
    """A run that must print no result."""


class Run:
    """One run of one cell: what its kind's code reads and records."""

    def __init__(self, bench, workload, seed, seconds, trace, device, fault="none",
                 files=None):
        cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
        if cell is None:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cell
        files = files or {}

        def find(kind, name):
            if name in files.get(kind, {}):
                return files[kind][name]
            return common.load_json(common.named_file(kind, name))

        self.cfg = find("configs", cell["config"])
        self.model = registry.find(self.cfg["model"], files.get("models", ()))
        self.traffic = find("traffic", cell["traffic"])
        self.limits = find("limits", workload)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.fault = faults.Fault(fault)
        self.cleanup, self.recording = [], False
        self.setup_split, self.metrics, self.device_meta = {}, {}, None
        self.readings, self.layer, self.attempted, self.failed = {}, None, 0, 0
        self.extra, self.check = {}, None

    @staticmethod
    def log(what):
        print(f"port_bench: {time.perf_counter() - T_START:9.3f} s {what}", file=sys.stderr,
              flush=True)

    # ---- set-up
    def timed(self, name, fn):
        t = time.perf_counter()
        out = fn()
        self.setup_split[name] = self.setup_split.get(name, 0.0) + time.perf_counter() - t
        self.log(f"set-up: {name} {time.perf_counter() - t:.3f} s")
        return out

    # ---- the window
    def window(self, fn):
        """Call fn back to back for ``seconds`` -> (calls, seconds), the card
        synchronized before the first and after the last."""
        common.sync(self.device)
        t0 = time.perf_counter()
        self.metrics["setup_s"] = t0 - T_START
        n = 0
        while time.perf_counter() - t0 < self.seconds:
            fn()
            n += 1
        common.sync(self.device)
        elapsed = time.perf_counter() - t0
        self.log(f"window: {n} calls in {elapsed:.3f} s")
        return n, elapsed

    def close_window(self, calls, per_call, seconds):
        self.device_meta = common.device_info(self.device, self.cell["chips"])
        self.extra.update({"window_calls": calls, "window_s": seconds,
                           "launches_per_call": per_call})

    def launch_counter(self):
        try:
            return common.port_module("kernels.calls").read_launches()
        except (ImportError, AttributeError):
            return None

    def launches_since(self, before, n):
        after = self.launch_counter()
        if before is None or after is None or not n:
            return None
        return {k: (after.get(k, 0) - before.get(k, 0)) / n for k in after}

    def profile(self, fn, n):
        root = common.scratch_dir()
        self.cleanup.append(root)
        self.log(f"profile: {n} calls")
        t = profiled(fn, n, self.device, root)
        self.log(f"profile: {len(t.device)} device and {len(t.host)} host operations read")
        return t

    def reading(self, **kw):
        """What the per-layer metrics read."""
        kw["peaks"] = common.load_json(os.path.join(common.HERE, "peaks.json"))
        kw["cfg"], kw["traffic"] = self.cfg, self.traffic
        self.layer = kw


def per_layer(bench, run):
    """{metric: {value, unit}} of the cell's per-layer metrics that their
    readers find something to read."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        path = common.named_file("metrics", m["name"], ".py")
        spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run.layer) if run.layer is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(bench, run):
    out = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        if m["name"] in run.metrics:
            out[m["name"]] = {"value": run.metrics[m["name"]], "unit": m["unit"]}
    return out


def execute(argv=None, bench=None, require_cuda=True, device=None, fault="none", files=None):
    """Run a cell -> (the result dict that ``main`` prints, the ``Run``).
    ``bench``, ``require_cuda``, ``device``, ``fault`` and ``files``
    (configurations, traffic and limits by name, in place of their files;
    under ``models``, more directories to find a model's module in) are the
    seams of the tests and of ``calibrate.py``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if bench is None:
        bench = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if require_cuda:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: the benchmark measures the port on one")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell asks for {chips} cards, {torch.cuda.device_count()} here")
        device = torch.device("cuda", 0)
    if importlib.util.find_spec(common.PORT) is None:
        raise Refused(f"the port ({common.PORT}) is not in this checkout")
    run = Run(bench, args.workload, args.seed, args.seconds, args.trace, device, fault, files)
    kind = importlib.import_module(f"port_bench.kinds.{run.traffic['kind']}")
    try:
        kind.run(run)
    finally:
        for d in run.cleanup:
            shutil.rmtree(d, ignore_errors=True)
    found = common.loaded_forbidden()
    if found:
        raise Refused(f"loaded in this process: {', '.join(found)}")
    correct, check = common.judge(run.readings, run.limits)
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": per_layer(bench, run) if run.trace else end_to_end(bench, run),
              "device": dict(run.device_meta)}
    if run.trace:
        t = run.layer.get("trace")
        result["device"].update({"busy_s": t.busy_s() if t else 0.0,
                                 "window_s": t.window_s if t else 0.0})
        if t is not None:
            result["breakdown"] = {"device_ops": [[k, v] for k, v in t.by_class()[:10]],
                                   "idle_gaps": t.idle_gaps(10)}
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in check.items()}
    return result, run


def main(argv=None):
    out = sys.stdout
    sys.stdout = sys.stderr     # the port's prints go to standard error
    try:
        result, run = execute(argv)
    except Refused as e:
        print(f"port_bench: refused: {e}", file=sys.stderr)
        return 2
    finally:
        gc.collect()
    # the line before the result: peak memory, the port's launches a call,
    # the split of set-up
    print(json.dumps({"memory_peak_bytes": result["device"]["memory_peak_bytes"],
                      "setup_split_s": run.setup_split, **run.extra}), file=out)
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The span metrics' readers (``port_bench/metrics/*``, ``source``
``program_span``) on a synthetic span table and a synthetic ``Trace``: the
numbers a call, and None where a span is missing (a checkout before the
port's spans), where the port has no table, where the root span does not
count the sub-window's calls, and where the spans were not timed on a card."""

import importlib.util
import json
import os
import types

import pytest

from port_bench import common, run, spans
from port_bench.trace import Trace

TRAIN = ("sample_ms.train", "cast_ms.train", "forward_ms.train", "backward_ms.train",
         "optimizer_ms.train")
SERVE = ("g_fwd_ms.serve", "idle_in_infer.serve")


def _entry(count, host_s, device_s, parent):
    return {"count": count, "host_s": host_s, "device_s": device_s, "parent": parent}


def train_table(count=4, device=True):
    d = (lambda v: v) if device else (lambda v: None)
    return {"himan.step": _entry(count, 0.008, d(1.2), None),
            "himan.step.sample": _entry(count, 0.001, d(0.004), "himan.step"),
            "himan.step.cast": _entry(count, 0.001, d(0.008), "himan.step"),
            "himan.step.forward": _entry(count, 0.003, d(0.4), "himan.step"),
            "himan.step.backward": _entry(count, 0.002, d(0.6), "himan.step"),
            "himan.step.optimizer": _entry(count, 0.001, d(0.02), "himan.step")}


def serve_table(count=2):
    return {"himan.infer": _entry(count, 0.010, 0.050, None),
            "himan.infer.encode": _entry(count, 0.001, None, "himan.infer"),     # untimed
            "himan.infer.G": _entry(count, 0.008, 0.044, "himan.infer")}


def _x(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def serve_trace(annotated=True):
    """Two requests in 60 ms: each a 5 ms ``himan.infer`` span on the host
    with 1 ms of the card's idle at either end inside it, then a long
    kernel after the span ends."""
    ev = [_x("kernel", "k", 1000, 3000), _x("kernel", "k", 6000, 22000),
          _x("kernel", "k", 31000, 3000), _x("gpu_memcpy", "Memcpy HtoD", 36000, 22000),
          _x("cpu_op", "aten::copy_", 5000, 30000)]
    if annotated:
        ev += [_x("user_annotation", "himan.infer", 0, 5000),
               _x("user_annotation", "himan.infer", 30000, 5000),
               _x("gpu_user_annotation", "himan.infer", 1000, 27000)]
    return Trace(ev, 0.060, 2)


def reading(kind, trace):
    return {"kind": kind, "trace": trace, "calls": 100, "step_s": 0.3, "tier": "float32",
            "work": {"conv": 1.0, "linear": 0.0, "in_fwd_bytes": 1.0, "in_bwd_bytes": 1.0,
                     "g_forward": 1.0},
            "peaks": common.load_json(os.path.join(common.HERE, "peaks.json"))}


def reader(name):
    path = common.named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def port_table(monkeypatch):
    """Stands a table in for the port's ``span_table()``; ``None`` stands
    for a port without one."""
    box = {}

    def port_module(sub):
        assert sub == "train.profiler"
        if box.get("table") is None:
            return types.SimpleNamespace()      # a port with no spans
        return types.SimpleNamespace(span_table=lambda: box["table"])

    monkeypatch.setattr(common, "port_module", port_module)
    return box


def test_train_readers(port_table):
    port_table["table"] = train_table()
    r = reading("train", Trace([], 1.2, 4))
    got = {m: reader(m)(r) for m in TRAIN}
    assert got == pytest.approx({"sample_ms.train": 1.0, "cast_ms.train": 2.0,
                                 "forward_ms.train": 100.0, "backward_ms.train": 150.0,
                                 "optimizer_ms.train": 5.0})
    # a serving reading: the train readers read nothing
    assert all(reader(m)(reading("serve", serve_trace())) is None for m in TRAIN)


def test_serve_readers(port_table):
    port_table["table"] = serve_table()
    r = reading("serve", serve_trace())
    assert reader("g_fwd_ms.serve")(r) == pytest.approx(22.0)
    # 4 ms of idle inside the spans over 60 ms; the card is idle 10 ms in all
    assert reader("idle_in_infer.serve")(r) == pytest.approx(100 * 0.004 / 0.060)
    assert reader("device_idle.serve")(r) == pytest.approx(100 * 0.010 / 0.060)
    assert all(reader(m)(reading("train", Trace([], 1.2, 2))) is None for m in SERVE)


@pytest.mark.parametrize("case", ["no_table", "span_missing", "count", "cpu"])
def test_readers_return_none(case, port_table):
    """A checkout before the spans (no ``span_table``, no span, no
    ``himan.infer`` range in the trace), a root that does not count the
    sub-window's calls, spans with no device times (no card)."""
    table = {"no_table": None, "span_missing": {}, "count": train_table(count=3),
             "cpu": train_table(device=False)}[case]
    port_table["table"] = table
    assert all(reader(m)(reading("train", Trace([], 1.2, 4))) is None for m in TRAIN)
    port_table["table"] = (None if case == "no_table" else {} if case == "span_missing"
                           else serve_table(count=3 if case == "count" else 2))
    if case == "cpu":
        port_table["table"]["himan.infer"]["device_s"] = None
    before = case in ("no_table", "span_missing")
    srv = reading("serve", serve_trace(annotated=not before))
    assert reader("g_fwd_ms.serve")(srv) is None
    # the idle reads the trace alone: a trace without the ranges reads
    # nothing, and so does one with another count of them
    assert (reader("idle_in_infer.serve")(srv) is None) == before
    srv["trace"].calls = 3
    assert reader("idle_in_infer.serve")(srv) is None


def test_the_cells_report_the_new_metrics(port_table):
    """``run.per_layer`` finds each reader by name and reports it in the
    cells ``BENCHMARK.json`` lists, beside the metrics already there."""
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    port_table["table"] = train_table()
    for cell in ("m2i-train-bf16-b32", "b2m-train-bf16-b128", "m2i-train-fp32-b16"):
        r = types.SimpleNamespace(cell={"name": cell},
                                  layer=reading("train", Trace([], 1.2, 4)))
        got = set(run.per_layer(bench, r))
        want = set(TRAIN) - ({"cast_ms.train"} if "fp32" in cell else set())
        assert want <= got and "step_mfu.train" in got, (cell, got)
    port_table["table"] = serve_table()
    r = types.SimpleNamespace(cell={"name": "m2i-serve-fp32-b1"},
                              layer=reading("serve", serve_trace()))
    got = set(run.per_layer(bench, r))
    assert got == set(SERVE) | {"fwd_mfu.serve", "device_idle.serve"}


def test_the_port_table_is_read_through_the_port():
    """Without a stand-in: the port's own (empty after a reset) table."""
    common.port_module("train.profiler").reset_spans()
    assert spans.table() == {}

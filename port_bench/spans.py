"""What the span metrics share: the port's spans of the profiled sub-window
(``train/profiler.span_table`` of the port), read a call.

The port records its spans only while a profiler runs, so in a run of the
benchmark its table holds the sub-window's calls and nothing else. A reader
returns None where the port has no spans (a checkout before them), where
the spans were not timed on a card (no CUDA events), and where the root
span (``himan.step`` a train step, ``himan.infer`` a served request) does
not count the sub-window's calls."""

from __future__ import annotations

from port_bench import common

ROOTS = {"train": "himan.step", "serve": "himan.infer"}


def table():
    """The port's span table, or None where the port has none."""
    try:
        return common.port_module("train.profiler").span_table()
    except (ImportError, AttributeError):
        return None


def per_call_ms(r, kind: str, name: str):
    """The card's ms a call in span ``name`` in a cell of ``kind``, or None
    (see the module docstring)."""
    t = r.get("trace")
    if r.get("kind") != kind or t is None:
        return None
    spans, root = table(), ROOTS[kind]
    if not spans or root not in spans or name not in spans:
        return None
    n = spans[root]["count"]
    if n != t.calls or spans[root]["device_s"] is None:
        return None
    value = spans[name]["device_s"]
    return None if value is None else 1e3 * value / n

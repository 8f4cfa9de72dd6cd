"""On a machine with a card: a short run of a cell as the benchmark runs it
(``python -m pytest -m cuda port_bench/tests``)."""

import os

import pytest

from port_bench import common, run

CELL = "m2i-serve-fp32-b1"


@pytest.mark.cuda
def test_a_short_serving_run_on_the_card_is_correct(cuda_device):
    res, _ = run.execute(["--workload", CELL, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    # exactly the per-layer metrics that BENCHMARK.json gives the cell
    bench = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
    assert set(res["metrics"]) == {m["name"] for m in bench["per_layer"]
                                   if CELL in m.get("workloads", [CELL])}

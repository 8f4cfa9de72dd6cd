"""On a machine with a card: a short run of a cell as the benchmark runs it
(``python -m pytest -m cuda port_bench/tests``)."""

import pytest

from port_bench import run


@pytest.mark.cuda
def test_a_short_serving_run_on_the_card_is_correct(cuda_device):
    res, _ = run.execute(["--workload", "m2i-serve-fp32-b1", "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {"fwd_mfu.serve", "device_idle.serve"}

"""The committed full-length runs of the port's procedural-world tools on
the card (``reports/torch_r12/``), held to the JAX package's gates.

The two-step edit metrics meet the thresholds of
``tests/test_two_step_metrics.py`` (the JAX artifact's gate, unchanged):
add places the right class inside the box, remove restores the occluded
context, every mode passes through bit for bit outside the box. Every
summary names the card it ran on and logged finite losses. Each test
skips while its file is absent.
"""

import json
import os

import pytest

REPORTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "reports", "torch_r12")
TWO_STEP = os.path.join(REPORTS, "two_step", "summary.json")
SUMMARIES = {
    "dynamics": os.path.join(REPORTS, "dynamics", "summary.json"),
    **{f"dynamics_{run}": os.path.join(REPORTS, f"dynamics_{run}", "summary.json")
       for run in ("seed1", "seed2", "seed3", "seed4", "fp32")},
    "dynamics_b2m": os.path.join(REPORTS, "dynamics_b2m", "summary_b2m.json"),
    "two_step": TWO_STEP,
    "dynamics_1024p": os.path.join(REPORTS, "dynamics_1024p", "summary.json"),
}


def load(path):
    if not os.path.exists(path):
        pytest.skip(f"{os.path.relpath(path, REPORTS)} not generated yet")
    with open(path) as f:
        return json.load(f)


def test_committed_edit_metrics_meet_thresholds():
    rep = load(TWO_STEP)["edit_metrics"]["metrics"]
    assert rep["remove_context_restore_acc"]["mean"] >= 0.80
    assert rep["add_inbox_acc"]["mean"] >= 0.80
    assert rep["add_car_iou"]["mean"] >= 0.70
    for k in ("remove_label_passthrough", "remove_image_passthrough",
              "add_label_passthrough", "add_image_passthrough"):
        assert rep[k]["mean"] == 0.0, f"{k} leaked outside the box"


@pytest.mark.parametrize("run", sorted(SUMMARIES))
def test_committed_summary_names_its_card(run):
    summary = load(SUMMARIES[run])
    assert "H100" in summary["device"] and summary["wall_s"] > 0
    stages = summary.get("stages", {run: summary})
    for stage in stages.values():
        assert stage.get("finite", True) is True

"""The port's ``tools/two_step_metrics.py`` against the JAX package's tool
of the same name on the CPU (i): both over the same JAX-written tiny stage
runs (``tests/test_torch_two_step_cli.py``'s ``write_stage_runs`` at
label_nc 35, so that the add edit's class 26 exists), over the same paired
scenes (``RandomState(7)``).

Every per-scene row equals the JAX tool's printed row (both rounded to 4
places as the tool prints them) and the summary equals the JAX summary:
the accuracies, with no near-tie fill among these scenes, and the four
passthroughs, exactly 0.
"""

import json
import os
import re
import sys

from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu_torch.tools import two_step_metrics
from test_torch_two_step_cli import ARCH, write_stage_runs
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import two_step_metrics as jax_metrics  # noqa: E402  (the JAX tool)

N_SCENES = 3
PASSTHROUGH = ("remove_label_passthrough", "remove_image_passthrough",
               "add_label_passthrough", "add_image_passthrough")


def printed_rows(text):
    return [json.loads(m) for m in re.findall(r"\[metrics\] scene \d+: (\{.*\})", text)]


def test_rows_equal_jax_tool(tmp_path, monkeypatch, capsys,
                             restore_torch_precision):  # noqa: F811
    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setitem(ARCH, "label_nc", 35)
    write_stage_runs(ckpt)
    argv = ["--ckpt", ckpt, "--b2m_name", "b2m_demo", "--m2i_name", "m2i_demo",
            "--n_scenes", str(N_SCENES), "--hw", "64x128"]
    with jnnops.precision_scope():
        jax_metrics.main(argv + ["--out", str(tmp_path / "jax")])
    want_rows = printed_rows(capsys.readouterr().out)
    report = two_step_metrics.main(argv + ["--out", str(tmp_path / "port"), "--gpu_ids", "-1"])
    assert printed_rows(capsys.readouterr().out) == want_rows
    assert len(want_rows) == N_SCENES
    assert [{k: round(v, 4) for k, v in r.items()} for r in report["rows"]] == want_rows
    for row in report["rows"]:
        for k in PASSTHROUGH:
            assert row[k] == 0.0, k
    with open(tmp_path / "jax" / "summary.json") as f:
        want = json.load(f)["edit_metrics"]
    with open(tmp_path / "port" / "summary.json") as f:
        got = json.load(f)["edit_metrics"]
    assert got["metrics"] == want["metrics"] and got["n_scenes"] == want["n_scenes"]


def test_merges_into_existing_summary(tmp_path, monkeypatch, capsys,
                                      restore_torch_precision):  # noqa: F811
    """The gallery's summary.json keeps its keys; edit_metrics is added."""
    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setitem(ARCH, "label_nc", 35)
    write_stage_runs(ckpt)
    out = tmp_path / "out"
    out.mkdir()
    with open(out / "summary.json", "w") as f:
        json.dump({"edits": {"add": {"images": 16}}}, f)
    two_step_metrics.main(["--ckpt", ckpt, "--b2m_name", "b2m_demo", "--m2i_name", "m2i_demo",
                           "--n_scenes", "1", "--hw", "64x128", "--out", str(out),
                           "--gpu_ids", "-1"])
    with open(out / "summary.json") as f:
        merged = json.load(f)
    assert merged["edits"] == {"add": {"images": 16}}
    assert merged["edit_metrics"]["n_scenes"] == 1


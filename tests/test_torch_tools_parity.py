"""The port's ``tools/preprocess_city_bboxes.py`` and
``tools/parity_report.py`` against the JAX package's tools of the same
names on the CPU, and the device rule of every port tool that runs a
model: without a card it raises unless it is given ``--gpu_ids -1``.

  (d) the bbox records JSON equals the JAX tool's on a synthetic dataroot;
  (e) the parity runbook's dry run at the JAX test's sizes
      (``tests/test_parity_runbook.py``): the same report keys and counts,
      FID within 1e-3 relative of the JAX report's, and the same layout
      mIoU stage over a JAX-written box2mask run.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu_torch.tools import (
    export_inference,
    parity_report,
    preprocess_city_bboxes,
    train_dynamics,
    train_dynamics_1024p,
    train_dynamics_b2m,
    two_step_gallery,
    two_step_metrics,
)
from test_parity_runbook import dataroot  # noqa: F401  (the JAX test's fixture)
from test_torch_two_step_cli import write_stage_runs
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import parity_report as jax_parity_report  # noqa: E402  (the JAX tool)
import preprocess_city_bboxes as jax_bboxes  # noqa: E402


def write_inst_maps(root, phase="train", n=3, hw=(40, 72), seed=0):
    """Instance maps with thing objects (class*1000+k) of several sizes,
    stuff ids below 1000, some objects below the minimum box size."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, f"{phase}_inst"), exist_ok=True)
    for i in range(n):
        inst = rng.choice([7, 11, 23], size=hw).astype(np.int32)
        for k in range(4):
            cls = int(rng.choice([24, 26, 33]))
            bh, bw = rng.randint(3, 24), rng.randint(3, 40)
            y0, x0 = rng.randint(0, hw[0] - bh), rng.randint(0, hw[1] - bw)
            inst[y0:y0 + bh, x0:x0 + bw] = cls * 1000 + k
        Image.fromarray(inst, mode="I").save(os.path.join(root, f"{phase}_inst", f"{i:03d}.png"))


@pytest.mark.parametrize("min_box", ["4", "16"])
def test_preprocess_bboxes_json_equals_jax_tool(tmp_path, monkeypatch, capsys, min_box):
    root = str(tmp_path / "city")
    write_inst_maps(root)
    out = os.path.join(root, "train_bboxes.json")
    monkeypatch.setattr(sys, "argv", ["x", "--dataroot", root, "--min_box_size", min_box])
    jax_bboxes.main()
    with open(out) as f:
        want = f.read()
    os.remove(out)
    records = preprocess_city_bboxes.main(["--dataroot", root, "--min_box_size", min_box])
    with open(out) as f:
        got = f.read()
    assert got == want
    assert records == json.loads(want) and len(records) > 0
    outs = capsys.readouterr().out.splitlines()
    assert outs[-1] == outs[-2]    # "wrote N object records to ..." from each tool


def report_args(root, weights, out):
    return ["--weights_dir", weights, "--dataroot", root, "--out", out, "--label_nc", "8",
            "--ngf", "8", "--n_down", "2", "--n_blocks", "2", "--fineSize", "32",
            "--loadSize", "64", "--resize_or_crop", "none", "--how_many", "3", "--make_standins"]


def keys_of(d):
    return {k: keys_of(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_parity_report_dry_run_matches_jax_tool(dataroot, tmp_path,  # noqa: F811
                                                restore_torch_precision):  # noqa: F811
    tmp = str(tmp_path)
    # the mIoU stage over one JAX-written box2mask run (tiny architecture)
    write_stage_runs(os.path.join(tmp, "ckpt"))
    b2m = ["--b2m_name", "b2m_demo", "--b2m_checkpoints_dir", os.path.join(tmp, "ckpt"),
           "--b2m_args", "--label_nc 8 --ngf 8 --n_downsample_global 2 --n_blocks_global 1 "
           "--fineSize 32 --min_box_size 4 --resize_or_crop none"]
    want = jax_parity_report.main(
        report_args(dataroot, os.path.join(tmp, "wj"), os.path.join(tmp, "rj.json")) + b2m)
    got = parity_report.main(
        report_args(dataroot, os.path.join(tmp, "wp"), os.path.join(tmp, "rp.json")) + b2m
        + ["--gpu_ids", "-1"])
    assert keys_of(got) == keys_of(want)
    for stage in ("convert_G", "convert_VGG"):
        assert got["stages"][stage]["arrays"] == want["stages"][stage]["arrays"] > 0
    fid, jfid = got["stages"]["fid"], want["stages"]["fid"]
    assert fid["samples"] == jfid["samples"] == 3
    assert fid["features"] == jfid["features"] == "vgg19-pretrained"
    assert np.isfinite(fid["value"])
    np.testing.assert_allclose(fid["value"], jfid["value"], rtol=1e-3)
    miou, jmiou = got["stages"]["layout_miou"], want["stages"]["layout_miou"]
    assert miou["samples"] == jmiou["samples"] > 0
    np.testing.assert_allclose(miou["value"], jmiou["value"], atol=1e-6)
    with open(os.path.join(tmp, "rp.json")) as f:
        assert json.load(f)["stages"]["fid"]["value"] == fid["value"]
    # the stand-ins were written in the reference formats
    for name in ("latest_net_G.pth", "vgg19.pth"):
        assert os.path.exists(os.path.join(tmp, "wp", name))


# every port tool that runs a model, with the arguments it needs to start
DEVICE_TOOLS = {
    "parity_report": (parity_report, ["--weights_dir", "W", "--dataroot", "D"]),
    "export_inference": (export_inference, ["--stage", "box2mask"]),
    "train_dynamics": (train_dynamics, []),
    "train_dynamics_b2m": (train_dynamics_b2m, []),
    "two_step_gallery": (two_step_gallery, []),
    "two_step_metrics": (two_step_metrics, []),
    "train_dynamics_1024p": (train_dynamics_1024p, []),
}


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOLS))
def test_tool_without_a_card_raises(tmp_path, monkeypatch, tool):
    """No fallback: a tool asked for the card (its default --gpu_ids 0)
    raises where there is none, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module, argv = DEVICE_TOOLS[tool]
    with pytest.raises(RuntimeError, match="asks for a CUDA device"):
        module.main(argv + ["--out", str(tmp_path / "out")])
    assert os.listdir(tmp_path) == []

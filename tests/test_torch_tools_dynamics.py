"""The port's procedural-world tools (``tools/train_dynamics.py``,
``train_dynamics_b2m``, ``two_step_gallery``, ``train_dynamics_1024p``)
against the JAX package's tools of the same names, on the CPU.

  (g) ``synth_scene`` (with and without the paired car), ``make_world``
      (array for array, the PNG files decoded equal) and
      ``parse_loss_log`` equal the JAX tool's;
  (h) each tool passes its CLIs the JAX tool's argv, plus ``--gpu_ids``:
      both packages' CLI mains are captured with monkeypatch (and stand in
      for a run: a loss log, an evaluation, a gallery), then each tool
      writes its report from them.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu.cli import box2mask_train as jax_b2m_train
from neurips18_hierchical_image_manipulation_tpu.cli import evaluate as jax_evaluate
from neurips18_hierchical_image_manipulation_tpu.cli import mask2image_train as jax_m2i_train
from neurips18_hierchical_image_manipulation_tpu.cli import two_step_demo as jax_demo
from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_train, evaluate
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_train, two_step_demo
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (
    train_dynamics,
    train_dynamics_1024p,
    train_dynamics_b2m,
    two_step_gallery,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import train_dynamics as jax_dynamics  # noqa: E402  (the JAX tools)
import train_dynamics_1024p as jax_dynamics_1024p  # noqa: E402
import train_dynamics_b2m as jax_dynamics_b2m  # noqa: E402
import two_step_gallery as jax_gallery  # noqa: E402

LOG = """================ Training Loss (Sun Oct 18) ================
(epoch: 1, iters: 4, time: 0.036) G_GAN: 0.691 G_GAN_Feat: 7.644 D_real: 0.650 D_fake: 0.182
(epoch: 2, iters: 4, time: 0.039) G_GAN: 4.72e-01 G_GAN_Feat: 6.162 D_real: 0.450 D_fake: 0.194 img_per_s_per_chip: 56.090
End of epoch 2 / 2
(epoch: 3, iters: 4, time: 1.5) G_GAN: 0.4 G_GAN_Feat: 5.0 D_real: 0.4 D_fake: 0.2 img_per_s_per_chip: 60.5
"""


@pytest.mark.parametrize("hw,paired", [((64, 128), False), ((128, 256), True),
                                       ((256, 512), True)])
def test_synth_scene_equals_jax_tool(hw, paired):
    for seed in (0, 7):
        a = train_dynamics.synth_scene(np.random.RandomState(seed), *hw, 1, 4, paired_car=paired)
        b = jax_dynamics.synth_scene(np.random.RandomState(seed), *hw, 1, 4, paired_car=paired)
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "car_box":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_make_world_equals_jax_tool(tmp_path):
    train_dynamics.make_world(str(tmp_path / "port"), 3, hw=(64, 128))
    jax_dynamics.make_world(str(tmp_path / "jax"), 3, hw=(64, 128))
    for sub in ("train_label", "train_inst", "train_img"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub)) == [
            f"{i:04d}.png" for i in range(3)]
        for n in names:
            a, b = (Image.open(tmp_path / d / sub / n) for d in ("port", "jax"))
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_parse_loss_log_equals_jax_tool(tmp_path):
    path = str(tmp_path / "loss_log.txt")
    with open(path, "w") as f:
        f.write(LOG)
    rows = train_dynamics.parse_loss_log(path)
    assert rows == jax_dynamics.parse_loss_log(path)
    assert len(rows) == 3 and rows[1]["G_GAN"] == 0.472 and rows[2]["img_per_s_per_chip"] == 60.5


def without_gpu(argv, gpu):
    """argv with its one ``--gpu_ids gpu`` pair taken out."""
    i = argv.index("--gpu_ids")
    assert argv[i + 1] == gpu and "--gpu_ids" not in argv[i + 2:]
    return argv[:i] + argv[i + 2:]


class Captured:
    """Stands in for both packages' CLI mains: records each argv and leaves
    what a run leaves behind for the tool's report."""

    def __init__(self, monkeypatch):
        self.calls = {"jax": [], "port": []}
        for who, mods in (("jax", (jax_m2i_train, jax_b2m_train)),
                          ("port", (mask2image_train, box2mask_train))):
            for mod in mods:
                monkeypatch.setattr(mod, "main", self.train(who))
        monkeypatch.setattr(jax_evaluate, "main", self.evaluate("jax"))
        monkeypatch.setattr(evaluate, "main", self.evaluate("port"))
        monkeypatch.setattr(jax_demo, "main", self.demo("jax"))
        monkeypatch.setattr(two_step_demo, "main", self.demo("port"))

    def train(self, who):
        def main(argv):
            self.calls[who].append(("train", list(argv)))
            run = os.path.join(argv[argv.index("--checkpoints_dir") + 1],
                               argv[argv.index("--name") + 1])
            os.makedirs(run, exist_ok=True)
            with open(os.path.join(run, "loss_log.txt"), "w") as f:
                f.write(LOG)
        return main

    def evaluate(self, who):
        def main(argv):
            self.calls[who].append(("evaluate", list(argv)))
            return {"metric": "layout_miou", "value": 0.5, "segmentation_consistency": 0.75,
                    "samples": 4}
        return main

    def demo(self, who):
        def main(argv):
            self.calls[who].append(("demo", list(argv)))
            images = os.path.join(argv[argv.index("--results_dir") + 1],
                                  argv[argv.index("--name") + 1], "images")
            os.makedirs(images, exist_ok=True)
            Image.new("RGB", (4, 4)).save(os.path.join(images, "0_edited.png"))
            return 1
        return main

    def check(self, gpu="-1"):
        port = [(k, without_gpu(a, gpu)) for k, a in self.calls["port"]]
        assert port == self.calls["jax"] and port


def run_both(monkeypatch, jax_tool, port_tool, jax_argv, port_argv):
    monkeypatch.setattr(sys, "argv", ["x", *jax_argv])
    jax_tool.main()
    return port_tool.main(port_argv)


def test_train_dynamics_argv_equals_jax_tool(tmp_path, monkeypatch):
    cap = Captured(monkeypatch)
    common = ["--steps", "40", "--bs", "2", "--n_images", "8", "--smoke",
              "--extra=--instance_feat", "--dataroot", str(tmp_path / "world")]
    summary = run_both(
        monkeypatch, jax_dynamics, train_dynamics,
        common + ["--ckpt", str(tmp_path / "jck"), "--out", str(tmp_path / "jout")],
        common + ["--ckpt", str(tmp_path / "pck"), "--out", str(tmp_path / "pout"),
                  "--gpu_ids", "-1"])
    for who in ("jax", "port"):
        for i, (_, argv) in enumerate(cap.calls[who]):
            ck = str(tmp_path / ("jck" if who == "jax" else "pck"))
            cap.calls[who][i] = ("train", [a if a != ck else "CKPT" for a in argv])
    cap.check()
    argv = cap.calls["jax"][0][1]
    # 8 images at bs 2: 4 steps an epoch, 10 epochs
    assert argv[argv.index("--niter") + 1] == "5" and argv[argv.index("--niter_decay") + 1] == "5"
    with open(tmp_path / "jout" / "summary.json") as f:
        want = json.load(f)
    assert {k: summary[k] for k in want} == want
    assert summary["device"] == "cpu" and summary["wall_s"] > 0
    assert os.path.exists(tmp_path / "pout" / "loss_curves.png")


def test_train_dynamics_b2m_argv_equals_jax_tool(tmp_path, monkeypatch):
    cap = Captured(monkeypatch)
    world, ckpt = str(tmp_path / "world"), str(tmp_path / "ckpt")
    common = ["--steps", "30", "--bs", "4", "--n_images", "6", "--dataroot", world,
              "--ckpt", ckpt]
    summary = run_both(monkeypatch, jax_dynamics_b2m, train_dynamics_b2m,
                       common + ["--cpu", "--out", str(tmp_path / "jout")],
                       common + ["--gpu_ids", "-1", "--out", str(tmp_path / "pout")])
    cap.check()
    assert [k for k, _ in cap.calls["port"]] == ["train", "evaluate", "evaluate"]
    assert cap.calls["port"][2][1][-2:] == ["--which_epoch", "nonexistent"]
    with open(tmp_path / "jout" / "summary_b2m.json") as f:
        want = json.load(f)
    assert {k: summary[k] for k in want} == want
    assert os.path.exists(tmp_path / "pout" / "loss_curves_b2m.png")


def test_two_step_gallery_argv_equals_jax_tool(tmp_path, monkeypatch):
    cap = Captured(monkeypatch)
    world, ckpt = str(tmp_path / "world"), str(tmp_path / "ckpt")
    # a small world of the tool's scene size (the tool would make 128 scenes)
    train_dynamics.make_world(world, 12, hw=(128, 256))
    common = ["--world", world, "--ckpt", ckpt, "--m2i_steps", "20", "--bs", "4"]
    run_both(monkeypatch, jax_gallery, two_step_gallery,
             common + ["--out", str(tmp_path / "jout")],
             common + ["--gpu_ids", "-1", "--out", str(tmp_path / "pout")])
    cap.check()
    assert [k for k, _ in cap.calls["port"]] == ["train", "demo", "demo", "demo"]
    assert sorted(os.listdir(os.path.join(world, "test_img"))) == [
        f"{i:04d}.png" for i in range(4)]
    with open(tmp_path / "jout" / "summary.json") as f:
        want = json.load(f)
    with open(tmp_path / "pout" / "summary.json") as f:
        got = json.load(f)
    assert got["edits"] == want["edits"] and got["device"] == "cpu"


def test_train_dynamics_1024p_argv_equals_jax_tool(tmp_path, monkeypatch):
    cap = Captured(monkeypatch)
    monkeypatch.chdir(tmp_path)   # one relative --ckpt for both tools
    world = str(tmp_path / "world")
    train_dynamics.make_world(world, 2, hw=(64, 128))   # stands in for the 1024x512 world
    common = ["--n_images", "16", "--global_steps", "12", "--local_steps", "20",
              "--dataroot", world]
    summary = run_both(
        monkeypatch, jax_dynamics_1024p, train_dynamics_1024p,
        common + ["--ckpt", "CKPT", "--out", str(tmp_path / "jout")],
        common + ["--ckpt", "CKPT", "--gpu_ids", "-1", "--out", str(tmp_path / "pout")])
    cap.check()
    local = cap.calls["port"][1][1]
    # 16 images at bs 4: 4 steps an epoch, 5 epochs, the trunk frozen for 2
    assert local[local.index("--niter_fix_global") + 1] == "2"
    with open(tmp_path / "jout" / "summary.json") as f:
        want = json.load(f)
    assert {k: summary[k] for k in want} == want
    assert summary["device"] == "cpu"

"""The port's train CLI on the CPU at a tiny width: exact resume from a
checkpoint (Adam moments, LR schedule, step), the mid-epoch skip of
``iter.txt`` (the JAX package's ``tests/test_resume_and_eval.py``), and
the bf16 tier with the image pool and ``--continue_train`` writing the
HTML visuals, ``loss_log.txt`` and ``iter.txt``."""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_train
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = ["--label_nc", "8", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_layers_D", "2", "--num_D", "1", "--fineSize", "32",
        "--min_box_size", "4", "--no_vgg_loss", "--gpu_ids", "-1", "--nThreads", "1",
        "--serial_batches"]


@pytest.fixture
def dataroot(tmp_path):
    """Two 64x64 scenes with two thing objects each: 4 windows an epoch."""
    root = tmp_path / "city"
    rng = np.random.RandomState(0)
    for sub in ("label", "inst", "img"):
        (root / f"train_{sub}").mkdir(parents=True)
    for i in range(2):
        label = np.full((64, 64), 3, np.uint8)
        inst = np.zeros((64, 64), np.int32)
        for k, (y, x) in enumerate(((8, 6), (36, 30))):
            label[y : y + 20, x : x + 24] = 6
            inst[y : y + 20, x : x + 24] = 6000 + k
        img = rng.randint(0, 255, size=(64, 64, 3), dtype=np.uint8)
        Image.fromarray(label).save(root / "train_label" / f"{i}.png")
        Image.fromarray(inst, mode="I").save(root / "train_inst" / f"{i}.png")
        Image.fromarray(img).save(root / "train_img" / f"{i}.png")
    return str(root)


def run(dataroot, ckpt, name, *flags):
    return mask2image_train.main(["--name", name, "--dataroot", dataroot,
                                  "--checkpoints_dir", ckpt, *ARCH, *flags])


def saved_state(ckpt, name, label="latest"):
    return torch.load(os.path.join(ckpt, name, "ckpt", label, "state.pt"))


def test_resume_is_exact(dataroot, tmp_path, restore_torch_precision):
    """Two epochs straight, against the epoch-1 checkpoint of the same run
    resumed for epoch 2: the same bits in every parameter, Adam moment and
    schedule position (the LR decays in epoch 2)."""
    ckpt = str(tmp_path / "ckpt")
    flags = ["--niter", "0", "--niter_decay", "2", "--save_epoch_freq", "1",
             "--print_freq", "100", "--display_freq", "100"]
    straight = run(dataroot, ckpt, "r", *flags)
    assert straight.step == 8
    want = saved_state(ckpt, "r")
    assert saved_state(ckpt, "r", "1")["step"] == 4
    with open(os.path.join(ckpt, "r", "iter.txt"), "w") as f:
        f.write("2,0")
    resumed = run(dataroot, ckpt, "r", *flags, "--continue_train", "--which_epoch", "1")
    assert resumed.step == 8
    assert resumed.opt_g.param_groups[0]["lr"] == straight.opt_g.param_groups[0]["lr"]
    got = saved_state(ckpt, "r")
    for net in ("G", "D"):
        for k, t in want["params"][net].items():
            assert torch.equal(got["params"][net][k], t), (net, k)
    for opt in ("opt_g", "opt_d"):
        for i, st in want[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(got[opt]["state"][i][k], st[k]), (opt, i, k)
    assert got["sched_g"]["last_epoch"] == want["sched_g"]["last_epoch"] == 8


def test_mid_epoch_resume_skips_seen_batches(dataroot, tmp_path, restore_torch_precision):
    ckpt = str(tmp_path / "ckpt")
    flags = ["--niter", "1", "--niter_decay", "0", "--print_freq", "1",
             "--display_freq", "1000", "--save_epoch_freq", "1"]
    run(dataroot, ckpt, "mid", *flags)
    log_path = os.path.join(ckpt, "mid", "loss_log.txt")
    n_total = len(re.findall(r"\(epoch: 1,", open(log_path).read()))
    assert n_total == 4
    with open(os.path.join(ckpt, "mid", "iter.txt"), "w") as f:
        f.write("1,1")  # stopped after one batch of epoch 1
    run(dataroot, ckpt, "mid", *flags, "--continue_train")
    n_after = len(re.findall(r"\(epoch: 1,", open(log_path).read())) - n_total
    assert n_after == n_total - 1


def test_cli_bf16_pool_continue_writes_visuals(dataroot, tmp_path, capsys,
                                               restore_torch_precision):
    ckpt = str(tmp_path / "ckpt")
    flags = ["--niter_decay", "0", "--print_freq", "2", "--display_freq", "2",
             "--save_epoch_freq", "1", "--dtype", "bfloat16", "--pool_size", "2",
             "--continue_train"]
    first = run(dataroot, ckpt, "bf", "--niter", "1", *flags)
    out = capsys.readouterr().out
    assert "WARNING: --continue_train set but no 'latest' checkpoint found" in out
    assert first.step == 4
    assert all(p.dtype == torch.float32 for g in first.opt_g.param_groups for p in g["params"])
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    assert len(lines) == 2
    for ln in lines:
        vals = dict(re.findall(r"(\w+): (-?[0-9.]+|nan|inf)", ln.split(") ", 1)[1]))
        assert set(vals) - {"img_per_s_per_chip"} == {"G_GAN", "G_GAN_Feat", "G_VGG",
                                                       "D_real", "D_fake"}
        assert all(np.isfinite(float(v)) for v in vals.values()), ln
    run_dir = os.path.join(ckpt, "bf")
    assert open(os.path.join(run_dir, "iter.txt")).read() == "2,0"
    # a second run resumes from `latest` and trains the second epoch
    second = run(dataroot, ckpt, "bf", "--niter", "2", *flags)
    assert "resumed from latest at epoch 2" in capsys.readouterr().out
    assert second.step == 8
    assert open(os.path.join(run_dir, "iter.txt")).read() == "3,0"
    with open(os.path.join(run_dir, "loss_log.txt")) as f:
        assert sum(ln.startswith("(epoch: ") for ln in f) == 4
    web = os.path.join(run_dir, "web")
    html = open(os.path.join(web, "index.html")).read()
    assert "epoch [2]" in html and "epoch [1]" in html
    for epoch in (1, 2):
        for label in ("input_label", "synthesized_image", "real_image"):
            img = Image.open(os.path.join(web, "images", f"epoch{epoch:03d}_{label}.png"))
            assert img.size == (32, 32) and img.mode == "RGB"
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == [
        "1", "1_params.npz", "2", "2_params.npz", "latest", "latest_params.npz"]

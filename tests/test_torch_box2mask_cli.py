"""The port's box2mask_train and box2mask_test CLIs on the CPU at a tiny
width: the loss lines, the checkpoints in the JAX sidecar layout (which the
JAX package's ``load_params_npz`` reads against its own box2mask tree),
the gallery, ``--pool_size`` training the fused step as in the JAX package,
and ``--continue_train``."""

import os
import re

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    BoxToMaskTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_box2mask_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import load_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_test, box2mask_train
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = ["--label_nc", "8", "--ngf", "8", "--n_downsample_global", "2", "--n_blocks_global",
        "1", "--fineSize", "32", "--min_box_size", "4"]
TRAIN = ARCH + ["--ndf", "8", "--n_layers_D", "2", "--gpu_ids", "-1", "--nThreads", "1",
                "--niter_decay", "0", "--save_latest_freq", "1000"]


@pytest.fixture
def dataroot(tmp_path):
    """64x64 scenes with two objects each (4 crops a phase), ids < label_nc 8."""
    root = tmp_path / "city"
    rng = np.random.RandomState(0)
    for phase in ("train", "test"):
        for sub in ("label", "inst", "img"):
            (root / f"{phase}_{sub}").mkdir(parents=True)
        for i in range(2):
            label = np.full((64, 64), 3, np.uint8)
            inst = label.astype(np.int32)
            for k, (y, x) in enumerate(((8, 6), (36, 30))):
                label[y : y + 20, x : x + 24] = 6
                inst[y : y + 20, x : x + 24] = 6000 + k
            img = rng.randint(0, 255, size=(64, 64, 3), dtype=np.uint8)
            Image.fromarray(label).save(root / f"{phase}_label" / f"{i}.png")
            Image.fromarray(inst, mode="I").save(root / f"{phase}_inst" / f"{i}.png")
            Image.fromarray(img).save(root / f"{phase}_img" / f"{i}.png")
    return str(root)


def loss_lines(out):
    """The loss terms of each loss line (its throughput field left out)."""
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    vals = [dict(re.findall(r"(\w+): (-?[0-9.]+|nan|inf)", ln.split(") ", 1)[1]))
            for ln in lines]
    return [{k: v for k, v in d.items() if k != "img_per_s_per_chip"} for d in vals]


def test_train_then_test_cli(dataroot, tmp_path, capsys, monkeypatch, restore_torch_precision):
    """--pool_size 2 trains the fused step (box2mask has no D-only
    objective); background boxes and the negative-class term on; the
    checkpoint loads into the JAX package and into box2mask_test."""
    def refuse(*a, **k):
        raise AssertionError("box2mask took the image-pool split step")

    monkeypatch.setattr(loop, "make_pooled_train_steps", refuse)
    ckpt = os.path.join(str(tmp_path), "ckpt")
    state = box2mask_train.main([
        "--name", "b2m", "--dataroot", dataroot, "--checkpoints_dir", ckpt, "--niter", "2",
        "--print_freq", "1", "--display_freq", "2", "--save_epoch_freq", "1",
        "--pool_size", "2", "--bg_box_prob", "0.5", "--lambda_ctx_neg", "5.0", *TRAIN])
    out = capsys.readouterr().out
    assert "#object crops = 4" in out and state.step == 8
    vals = loss_lines(out)
    assert len(vals) == 8
    for v in vals:
        assert set(v) == {"G_GAN", "G_recon", "G_obj", "D_real", "D_fake", "G_ctxneg"}
        assert all(np.isfinite(float(x)) for x in v.values()), v
    run = os.path.join(ckpt, "b2m")
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "1", "1_params.npz", "2", "2_params.npz", "latest", "latest_params.npz"]
    with open(os.path.join(run, "web", "index.html")) as f:
        html = f.read()
    assert "predicted_layout" in html and "epoch [2]" in html
    with open(os.path.join(run, "iter.txt")) as f:
        assert f.read() == "3,0"

    # the JAX package's loader, against its own box2mask tree
    path = os.path.join(run, "ckpt", "latest_params.npz")
    with jnnops.precision_scope():
        jm = jax_create_model(JaxTrainOptions(label_nc=8, ngf=8, ndf=8, n_downsample_global=2,
                                              n_blocks_global=1, n_layers_D=2, fineSize=32))
        batch = synthetic_box2mask_batch(np.random.RandomState(0), 1, size=32, label_nc=8)
        params = jax.eval_shape(lambda: jm.init_params(
            jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    loaded = load_params_npz(path, params)
    with np.load(path) as f:
        assert set(f.files) == {
            "/".join(str(getattr(k, "key", k)) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
        np.testing.assert_array_equal(
            np.asarray(loaded["G"]["params"]["cls_embed"]["kernel"]),
            f["G/params/cls_embed/kernel"])

    box2mask_test.main([
        "--name", "b2m", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
        "--results_dir", os.path.join(str(tmp_path), "res"), "--gpu_ids", "-1",
        "--how_many", "3", *ARCH])
    out = capsys.readouterr().out
    assert "restored checkpoint 'latest'" in out and "partial load" not in out
    assert "wrote 3 results" in out
    web = os.path.join(str(tmp_path), "res", "b2m", "test_latest")
    with open(os.path.join(web, "index.html")) as f:
        html = f.read()
    for name in ("input_masked", "predicted_layout", "gt_layout"):
        assert name in html
    assert any(n.endswith("_predicted_layout.png") for n in os.listdir(os.path.join(web, "images")))


def test_test_cli_depth_mismatch_loads_in_part(dataroot, tmp_path, capsys,
                                               restore_torch_precision):
    """The test options keep the base depth, as in the JAX package: a run
    trained at another depth restores only the leaves that fit, and says so."""
    ckpt = os.path.join(str(tmp_path), "ckpt")
    box2mask_train.main(["--name", "d", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                         "--niter", "1", "--print_freq", "100", *TRAIN])
    capsys.readouterr()
    box2mask_test.main(["--name", "d", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                        "--results_dir", os.path.join(str(tmp_path), "res"), "--gpu_ids", "-1",
                        "--how_many", "1", "--label_nc", "8", "--ngf", "8", "--fineSize", "32",
                        "--min_box_size", "4"])
    out = capsys.readouterr().out
    assert "checkpoint partial load" in out and "wrote 1 results" in out


def test_continue_train_resumes_exactly(dataroot, tmp_path, capsys, restore_torch_precision):
    """One epoch, then --continue_train for a second, equals two epochs
    straight, bit for bit, under --serial_batches."""
    common = ["--dataroot", dataroot, "--serial_batches", "--print_freq", "100",
              "--save_epoch_freq", "100", "--lambda_ctx_neg", "5.0", *TRAIN]
    straight = os.path.join(str(tmp_path), "a")
    resumed = os.path.join(str(tmp_path), "b")
    box2mask_train.main(["--name", "r", "--checkpoints_dir", straight, "--niter", "2", *common])
    box2mask_train.main(["--name", "r", "--checkpoints_dir", resumed, "--niter", "1", *common])
    state = box2mask_train.main(["--name", "r", "--checkpoints_dir", resumed, "--niter", "2",
                                 "--continue_train", *common])
    assert "resumed from latest at epoch 2" in capsys.readouterr().out
    assert state.step == 8
    files = [os.path.join(d, "r", "ckpt", "latest_params.npz") for d in (straight, resumed)]
    with np.load(files[0]) as a, np.load(files[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""The port's mask2image_train CLI on the CPU at a tiny width: it prints the
loss lines, writes ``latest`` and per-epoch params in the JAX sidecar
layout, and the JAX package's ``load_params_npz`` and the port's serving
CLI both load them."""

import os
import re

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import load_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_test, mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
    check_train_options,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = ["--label_nc", "8", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_layers_D", "2", "--fineSize", "32",
        "--min_box_size", "4"]
LOSSES = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")


@pytest.fixture
def dataroot(tmp_path):
    """64x64 scenes with two thing objects each, for both phases."""
    root = tmp_path / "city"
    rng = np.random.RandomState(0)
    for phase in ("train", "test"):
        for sub in ("label", "inst", "img"):
            (root / f"{phase}_{sub}").mkdir(parents=True)
        for i in range(2):
            label = np.full((64, 64), 3, np.uint8)
            inst = np.zeros((64, 64), np.int32)
            for k, (y, x) in enumerate(((8, 6), (36, 30))):
                label[y : y + 20, x : x + 24] = 6
                inst[y : y + 20, x : x + 24] = 6000 + k
            img = rng.randint(0, 255, size=(64, 64, 3), dtype=np.uint8)
            Image.fromarray(label).save(root / f"{phase}_label" / f"{i}.png")
            Image.fromarray(inst, mode="I").save(root / f"{phase}_inst" / f"{i}.png")
            Image.fromarray(img).save(root / f"{phase}_img" / f"{i}.png")
    return str(root)


def test_train_cli_writes_params_jax_and_serving_load(
    dataroot, tmp_path, capsys, restore_torch_precision
):
    ckpt = os.path.join(str(tmp_path), "ckpt")
    argv = ["--name", "m2i", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
            "--gpu_ids", "-1", "--niter", "2", "--niter_decay", "0", "--print_freq", "2",
            "--save_epoch_freq", "1", "--save_latest_freq", "1000", "--nThreads", "1", *ARCH]
    state = mask2image_train.main(argv)
    out = capsys.readouterr().out
    assert "#training samples = 4" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    assert len(lines) == 4  # 4 windows an epoch at bs 1, a line every 2 steps
    for ln in lines:
        assert re.match(r"\(epoch: \d+, iters: \d+, time: [0-9.]+\) ", ln), ln
        vals = dict(re.findall(r"(\w+): (-?[0-9.]+|nan|inf)", ln.split(") ", 1)[1]))
        assert set(vals) == set(LOSSES)
        assert all(np.isfinite(float(v)) for v in vals.values()), ln
    assert state.step == 8
    with open(os.path.join(ckpt, "m2i", "loss_log.txt")) as f:
        assert sum(ln.startswith("(epoch: ") for ln in f) == 4
    files = sorted(os.listdir(os.path.join(ckpt, "m2i", "ckpt")))
    assert files == ["1", "1_params.npz", "2", "2_params.npz", "latest", "latest_params.npz"]
    path = os.path.join(ckpt, "m2i", "ckpt", "latest_params.npz")

    # the JAX package's loader, against the JAX tree of the same architecture
    with jnnops.precision_scope():
        jopt = JaxTrainOptions(label_nc=8, ngf=8, ndf=8, n_downsample_global=2,
                               n_blocks_global=1, n_layers_D=2, no_vgg_loss=True)
        jmodel = jax_create_model(jopt)
        batch = synthetic_batch(np.random.RandomState(0), 1, hw=(32, 32), label_nc=8)
        params = jmodel.init_params(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    loaded = load_params_npz(path, params)
    with np.load(path) as f:
        assert set(f.files) == {
            "/".join(str(getattr(k, "key", k)) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]
        }
        conv_in = f["G/params/conv_in/kernel"]
    np.testing.assert_array_equal(np.asarray(loaded["G"]["params"]["conv_in"]["kernel"]), conv_in)

    # the port's serving CLI restores every generator leaf from it
    mask2image_test.main([
        "--name", "m2i", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
        "--results_dir", os.path.join(str(tmp_path), "res"), "--gpu_ids", "-1",
        "--how_many", "2", *ARCH,
    ])
    out = capsys.readouterr().out
    assert "restored checkpoint 'latest'" in out and "partial load" not in out
    assert "wrote 2 results" in out


def test_unported_train_flags_raise():
    check_train_options(MaskToImageTrainOptions())
    check_train_options(MaskToImageTrainOptions(dtype="bfloat16", pool_size=50,
                                                continue_train=True))
    # ported: the 1024p hand-off and the instance features
    check_train_options(MaskToImageTrainOptions(netG="local", load_pretrain="x",
                                                niter_fix_global=1, instance_feat=True))
    for kw in (dict(mesh_devices=4), dict(device_resident_data=True), dict(use_dropout=True)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            check_train_options(MaskToImageTrainOptions(**kw))

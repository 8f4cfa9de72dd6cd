"""Both mask2image_test CLIs on one synthetic PNG dataroot and one
JAX-written checkpoint: the port (on the CPU) writes the same gallery."""

import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.cli import mask2image_test as jax_cli
from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTestOptions as JaxOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_test as port_cli
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = ["--label_nc", "8", "--ngf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1"]


@pytest.fixture
def dataroot(tmp_path):
    """tests/test_cli.py's dataroot: 64x64 scenes, one thing object each."""
    root = tmp_path / "city"
    for sub in ("test_label", "test_inst", "test_img"):
        (root / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(2):
        h, w = 64, 64
        label = np.full((h, w), 3, np.uint8)
        inst = np.zeros((h, w), np.int32)
        label[20:44, 16:48] = 6
        inst[20:44, 16:48] = 6000 + i
        img = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(label).save(root / "test_label" / f"{i}.png")
        Image.fromarray(inst, mode="I").save(root / "test_inst" / f"{i}.png")
        Image.fromarray(img).save(root / "test_img" / f"{i}.png")
    return str(root)


def flags(dataroot, tmp_path, results):
    return [
        "--name", "m2i", "--dataroot", dataroot,
        "--checkpoints_dir", os.path.join(str(tmp_path), "ckpt"),
        "--results_dir", os.path.join(str(tmp_path), results),
        "--resize_or_crop", "none", "--no_flip", "--fineSize", "64",
        "--how_many", "2", *ARCH,
    ]


def test_port_cli_matches_jax_cli(dataroot, tmp_path, capsys, restore_torch_precision):
    with jnnops.precision_scope():
        opt = JaxOptions(name="m2i", label_nc=8, ngf=8, n_downsample_global=2,
                         n_blocks_global=1, fineSize=64)
        model = jax_create_model(opt)
        b = synthetic_batch(np.random.RandomState(1), 1, hw=(64, 64), label_nc=8)
        params = model.init_params(
            jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in b.items()}
        )
        ckpt = os.path.join(str(tmp_path), "ckpt", "m2i", "ckpt")
        os.makedirs(ckpt)
        save_params_npz(os.path.join(ckpt, "latest_params.npz"), {"G": params["G"]})

        jax_cli.main(flags(dataroot, tmp_path, "res_jax"))
    jax_out = capsys.readouterr().out
    port_cli.main(flags(dataroot, tmp_path, "res_port") + ["--gpu_ids", "-1"])
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert "restored checkpoint 'latest'" in out and "partial load" not in out

    dirs = [os.path.join(str(tmp_path), r, "m2i", "test_latest") for r in ("res_jax", "res_port")]
    for d in dirs:
        assert os.path.exists(os.path.join(d, "index.html"))
    names = sorted(os.listdir(os.path.join(dirs[0], "images")))
    assert names == sorted(os.listdir(os.path.join(dirs[1], "images")))
    assert len([n for n in names if n.endswith("_synthesized_image.png")]) == 2
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d, "images", n)), np.int16) for d in dirs)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, n

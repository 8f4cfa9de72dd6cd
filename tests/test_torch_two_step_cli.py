"""Both packages' two_step_demo CLIs on one tiny dataroot, from the same
JAX-written ``config.json`` and ``latest_params.npz`` sidecars of each
stage (the demo arguments of tests/test_resume_and_eval.py, and
``--gpu_ids -1`` for the port): the same gallery, the completed-label PNGs
equal and the edited PNGs within one uint8 level."""

import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.cli import two_step_demo as jax_demo
from neurips18_hierchical_image_manipulation_tpu.configs import options as jopts
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import (
    synthetic_batch,
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.cli import two_step_demo as port_demo
from test_cli import dataroot  # noqa: F401  (fixture)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, n_downsample_global=2, n_blocks_global=1, fineSize=32)


def write_stage_runs(ckpt):
    """The two trained runs the demo reads: each stage's config.json (its
    options' own parse) and its G at a JAX init, as ``latest_params.npz``."""
    with jnnops.precision_scope():
        for cls_, name, key, batch in (
            (jopts.BoxToMaskTestOptions, "b2m_demo", 0,
             synthetic_box2mask_batch(np.random.RandomState(0), 1, size=32, label_nc=8)),
            (jopts.MaskToImageTestOptions, "m2i_demo", 1,
             synthetic_batch(np.random.RandomState(1), 1, hw=(32, 32), label_nc=8)),
        ):
            opt = cls_(name=name, checkpoints_dir=ckpt, **ARCH).parse()
            model = jax_create_model(opt)
            params = model.init_params(jax.random.PRNGKey(key),
                                       {k: jnp.asarray(v) for k, v in batch.items()})
            os.makedirs(os.path.join(ckpt, name, "ckpt"))
            save_params_npz(os.path.join(ckpt, name, "ckpt", "latest_params.npz"),
                            {"G": params["G"]})


def demo_args(dataroot, tmp, results, edit):  # noqa: F811
    return ["--name", "demo", "--b2m_name", "b2m_demo", "--m2i_name", "m2i_demo",
            "--checkpoints_dir", os.path.join(tmp, "ckpt"),
            "--results_dir", os.path.join(tmp, results), "--dataroot", dataroot,
            "--edit", edit, "--cls", "6", "--label_nc", "8",
            "--fineSize_b2m", "32", "--fineSize_m2i", "32", "--loadSize", "64",
            "--how_many", "2"]


@pytest.mark.parametrize("edit", ["add", "swap"])
def test_port_demo_matches_jax_demo(dataroot, tmp_path, capsys, restore_torch_precision,  # noqa: F811
                                    edit):
    tmp = str(tmp_path)
    write_stage_runs(os.path.join(tmp, "ckpt"))
    with jnnops.precision_scope():
        jax_demo.main(demo_args(dataroot, tmp, "res_jax", edit))
    jax_out = capsys.readouterr().out
    assert port_demo.main(demo_args(dataroot, tmp, "res_port", edit) + ["--gpu_ids", "-1"]) == 2
    port_out = capsys.readouterr().out
    for out in (jax_out, port_out):
        assert out.count("adopted architecture") == 2 and "wrote 2 edits" in out
    assert port_out.count("restored checkpoint 'latest'") == 2 and "partial load" not in port_out

    dirs = [os.path.join(tmp, r, "demo") for r in ("res_jax", "res_port")]
    pages = []
    for d in dirs:
        with open(os.path.join(d, "index.html")) as f:
            pages.append(f.read())
    assert pages[0] == pages[1]
    names = sorted(os.listdir(os.path.join(dirs[0], "images")))
    assert names == sorted(os.listdir(os.path.join(dirs[1], "images")))
    assert len(names) == 8
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d, "images", n)), np.int16) for d in dirs)
        assert a.shape == b.shape
        if n.endswith("_edited.png"):
            assert np.abs(a - b).max() <= 1, n
            assert not np.array_equal(b, np.asarray(Image.open(os.path.join(
                dirs[1], "images", n.replace("_edited", "_original"))), np.int16))
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)

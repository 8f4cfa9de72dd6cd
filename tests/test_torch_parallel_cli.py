"""The train CLIs on a data-parallel mesh of 2 gloo CPU ranks that they
start themselves (``--gpu_ids -1 --mesh_devices 2``, the JAX tests'
virtual devices' counterpart): mask2image one epoch on the fused resident
step (JAX ``tests/test_cli.py:285``) and box2mask on the streamed one,
each rank training its rows and only rank 0 writing; ``--pool_size`` with a
mesh refused as in the JAX loop; and the serving CLI's ``--spatial_shards
2`` against its unsharded gallery."""

import os
import re

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu_torch.cli import (
    box2mask_train,
    mask2image_test,
    mask2image_train,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.parallel import DataMesh
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop
from test_torch_box2mask_cli import ARCH, TRAIN, dataroot  # noqa: F401  (fixture)
from test_torch_profiler import M2I
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

MESH = ["--mesh_devices", "2", "--batchSize", "2", "--niter", "1", "--print_freq", "1"]


def _written(ckpt, name):
    run = os.path.join(ckpt, name)
    with open(os.path.join(run, "loss_log.txt")) as f:
        log = f.read()
    with open(os.path.join(run, "iter.txt")) as f:
        it = f.read()
    return log, it, sorted(os.listdir(os.path.join(run, "ckpt")))


def _loss_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]


def test_mask2image_dp_resident_cli(dataroot, tmp_path, capfd,  # noqa: F811
                                    restore_torch_precision):
    ckpt = str(tmp_path / "ck")
    assert mask2image_train.main(["--name", "dp", "--dataroot", dataroot, "--checkpoints_dir",
                                  ckpt, "--device_resident_data", *M2I, *MESH]) is None
    out = capfd.readouterr().out
    assert out.count("data-parallel mesh over 2 devices") >= 1
    lines = _loss_lines(out)
    assert len(lines) == 2          # 4 windows, global batch 2: one line a step, rank 0's
    assert all("img_per_s_per_chip" in ln for ln in lines[1:])
    log, it, saved = _written(ckpt, "dp")
    assert log.count("Training Loss") == 1 and log.count("(epoch: ") == 2
    assert it == "2,0" and saved == ["latest", "latest_params.npz"]
    with np.load(os.path.join(ckpt, "dp", "ckpt", "latest_params.npz")) as f:
        assert all(np.isfinite(f[k]).all() for k in f.files)


def test_box2mask_dp_cli(dataroot, tmp_path, capfd, restore_torch_precision):  # noqa: F811
    ckpt = str(tmp_path / "ck")
    box2mask_train.main(["--name", "b", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                         *TRAIN, *MESH])
    lines = _loss_lines(capfd.readouterr().out)
    assert len(lines) == 2
    for ln in lines:
        assert all(np.isfinite(float(v)) for v in re.findall(r": (-?[0-9.]+|nan|inf)", ln)[1:])
    log, it, saved = _written(ckpt, "b")
    assert log.count("Training Loss") == 1 and it == "2,0" and "latest" in saved


def test_pool_size_with_a_mesh_refused(tmp_path):
    opt = MaskToImageTrainOptions(gpu_ids="-1", checkpoints_dir=str(tmp_path), pool_size=2,
                                  label_nc=8, ngf=8, ndf=8, n_downsample_global=2,
                                  n_blocks_global=1)
    with pytest.raises(ValueError, match="incompatible with multi-chip training"):
        loop.train(opt, create_model(opt), loader=None, mesh=DataMesh((2,), ("data",), rank=0))


def test_spatial_serving_cli_matches_unsharded(dataroot, tmp_path,  # noqa: F811
                                               restore_torch_precision):
    """A checkpoint served whole and W-sharded over 2 ranks writes the same
    gallery (8-bit PNGs), the conditioning built per slab."""
    ckpt = str(tmp_path / "ck")
    mask2image_train.main(["--name", "s", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                           *M2I, "--niter", "1"])
    res = {}
    for shards in (0, 2):
        out = str(tmp_path / f"res{shards}")
        mask2image_test.main(["--name", "s", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                              "--results_dir", out, "--how_many", "3", "--spatial_shards",
                              str(shards), *ARCH, "--gpu_ids", "-1", "--nThreads", "1"])
        img_dir = os.path.join(out, "s", "test_latest", "images")
        res[shards] = {f: np.asarray(Image.open(os.path.join(img_dir, f)))
                       for f in sorted(os.listdir(img_dir)) if "synthesized" in f}
    assert res[0].keys() == res[2].keys() and len(res[0]) >= 2
    for f, a in res[0].items():
        assert np.abs(a.astype(int) - res[2][f]).max() <= 1, f

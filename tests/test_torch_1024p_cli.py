"""The port's 1024p and instance-feature entry points on the CPU at a tiny
depth: the coarse-to-fine hand-off (a GlobalGenerator run, then
``--netG local --load_pretrain --niter_fix_global`` from it, then the
serving CLI from its ``latest``), and the feature flow (``--instance_feat``
training, ``tools/encode_features`` to a clusters npy, the serving CLI
with ``--cluster_path``, ``tools/precompute_feature_maps`` and a
``--load_features`` run)."""

import os

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu_torch.cli import (
    mask2image_test,
    mask2image_train,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (
    encode_features,
    precompute_feature_maps,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

DEPTH = ["--label_nc", "8", "--n_downsample_global", "2", "--n_blocks_global", "1",
         "--fineSize", "32", "--min_box_size", "4", "--gpu_ids", "-1", "--nThreads", "1"]
TRAIN = ["--ndf", "8", "--n_layers_D", "2", "--no_vgg_loss", "--serial_batches",
         "--print_freq", "1", "--display_freq", "100", "--save_epoch_freq", "1"]
LOCAL = ["--netG", "local", "--ngf", "8", "--n_local_enhancers", "1", "--n_blocks_local", "1"]
FEAT = ["--ngf", "8", "--instance_feat", "--feat_num", "3", "--nef", "4",
        "--n_downsample_E", "2"]


@pytest.fixture
def dataroot(tmp_path):
    """Two 64x64 train scenes (and the same two as test scenes) with two
    thing objects each: 4 windows an epoch."""
    root = tmp_path / "city"
    rng = np.random.RandomState(0)
    for phase in ("train", "test"):
        for sub in ("label", "inst", "img"):
            (root / f"{phase}_{sub}").mkdir(parents=True)
    for i in range(2):
        label = np.full((64, 64), 3, np.uint8)
        inst = np.full((64, 64), 3, np.int32)
        for k, (y, x) in enumerate(((8, 6), (36, 30))):
            label[y:y + 20, x:x + 24] = 6
            inst[y:y + 20, x:x + 24] = 6000 + k
        img = rng.randint(0, 255, size=(64, 64, 3), dtype=np.uint8)
        for phase in ("train", "test"):
            Image.fromarray(label).save(root / f"{phase}_label" / f"{i}.png")
            Image.fromarray(inst, mode="I").save(root / f"{phase}_inst" / f"{i}.png")
            Image.fromarray(img).save(root / f"{phase}_img" / f"{i}.png")
    return str(root)


def _npz(ckpt, name, label):
    with np.load(os.path.join(ckpt, name, "ckpt", f"{label}_params.npz")) as f:
        return {k: f[k] for k in f.files}


def _serve(dataroot, ckpt, tmp_path, name, *flags):
    mask2image_test.main(["--name", name, "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                          "--results_dir", str(tmp_path / "res"), "--how_many", "2",
                          *DEPTH, *flags])


def test_local_enhancer_hand_off_cli(dataroot, tmp_path, capsys, restore_torch_precision):
    """--load_pretrain from a GlobalGenerator run at ngf 16 into the
    LocalEnhancer at ngf 8 (its trunk at 16); --niter_fix_global 1 holds
    the trunk through epoch 1 and lets it move in epoch 2; the serving CLI
    restores every leaf of the result."""
    ckpt = str(tmp_path / "ckpt")
    mask2image_train.main(["--name", "glob", "--dataroot", dataroot, "--checkpoints_dir", ckpt,
                           "--ngf", "16", "--niter", "1", "--niter_decay", "0",
                           *DEPTH, *TRAIN])
    capsys.readouterr()
    state = mask2image_train.main([
        "--name", "loc", "--dataroot", dataroot, "--checkpoints_dir", ckpt, *LOCAL,
        "--load_pretrain", os.path.join(ckpt, "glob"), "--niter_fix_global", "1",
        "--niter", "1", "--niter_decay", "1", *DEPTH, *TRAIN])
    out = capsys.readouterr().out
    assert state.step == 8
    # G: the trunk's 14 leaves and conv_out's bias; D (2 scales, 4 layers): 16
    assert "load_pretrain: 31 leaves loaded, 11 kept at init" in out
    pre, ep1, last = (_npz(ckpt, "glob", "latest"), _npz(ckpt, "loc", "1"),
                      _npz(ckpt, "loc", "latest"))
    trunk = [k for k in ep1 if k.startswith("G/params/global/")]
    assert len(trunk) == 14
    for k in trunk:
        np.testing.assert_array_equal(ep1[k], pre[k.replace("/global/", "/", 1)], err_msg=k)
    moved = [k for k in trunk if k.endswith("kernel") and not np.array_equal(last[k], ep1[k])]
    assert len(moved) == 7
    assert not np.array_equal(ep1["G/params/local1_down/kernel"],
                              last["G/params/local1_down/kernel"])
    _serve(dataroot, ckpt, tmp_path, "loc", *LOCAL)
    out = capsys.readouterr().out
    assert "restored checkpoint 'latest'" in out and "partial load" not in out
    assert "wrote 2 results" in out


def test_instance_feature_flow_cli(dataroot, tmp_path, capsys, restore_torch_precision):
    """--instance_feat training, the clusters npy from its Encoder, serving
    from the clusters, then the precomputed maps and a --load_features run."""
    ckpt = str(tmp_path / "ckpt")
    state = mask2image_train.main(["--name", "feat", "--dataroot", dataroot,
                                   "--checkpoints_dir", ckpt, *FEAT, "--niter", "1",
                                   "--niter_decay", "0", *DEPTH, *TRAIN])
    assert state.step == 4
    saved = _npz(ckpt, "feat", "latest")
    assert any(k.startswith("E/params/") for k in saved)
    assert saved["G/params/conv_in/kernel"].shape[2] == 8 + 1 + 3 + 3
    clusters_path = str(tmp_path / "clusters.npy")
    clusters = encode_features.main(["--name", "feat", "--dataroot", dataroot,
                                     "--checkpoints_dir", ckpt, *FEAT, *DEPTH,
                                     "--out", clusters_path])
    assert clusters.shape == (8, 10, 3) and np.abs(clusters[6]).max() > 0
    np.testing.assert_array_equal(np.load(clusters_path), clusters)
    capsys.readouterr()
    _serve(dataroot, ckpt, tmp_path, "feat", *FEAT, "--cluster_path", clusters_path)
    out = capsys.readouterr().out
    assert "loaded feature clusters (8, 10, 3)" in out
    assert "restored checkpoint 'latest'" in out and "partial load" not in out
    assert "wrote 2 results" in out

    feat_dir = precompute_feature_maps.main(["--name", "feat", "--dataroot", dataroot,
                                             "--checkpoints_dir", ckpt, *FEAT, *DEPTH])
    maps = sorted(os.listdir(feat_dir))
    assert maps == ["0.npy", "1.npy"]
    m = np.load(os.path.join(feat_dir, "0.npy"))
    assert m.shape == (64, 64, 3) and m.dtype == np.float32
    state = mask2image_train.main([
        "--name", "loadf", "--dataroot", dataroot, "--checkpoints_dir", ckpt, *FEAT,
        "--load_features", "--no-use_bbox_dataset", "--no-use_masked_image",
        "--resize_or_crop", "none", "--niter", "1", "--niter_decay", "0", *DEPTH, *TRAIN])
    assert state.step == 2
    out = capsys.readouterr().out
    assert "G_GAN" in out


def test_load_features_refusals(dataroot):
    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
        MaskToImageTrainOptions,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import CreateDataLoader

    for kw in (dict(device_resident_data=True), dict(use_bbox_dataset=True)):
        with pytest.raises(ValueError, match="load_features"):
            CreateDataLoader(MaskToImageTrainOptions(dataroot=dataroot, load_features=True,
                                                     **kw))
    with pytest.raises(FileNotFoundError, match="train_feat"):
        CreateDataLoader(MaskToImageTrainOptions(dataroot=dataroot, load_features=True,
                                                 use_bbox_dataset=False))

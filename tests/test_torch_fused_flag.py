"""``--fused_resident_step`` as the JAX loop reads it (``train/loop.py:116-120``):
with resident data the default trains the fused sample+step, and
``--no-fused_resident_step`` trains the resident loader's own batches
through the streamed step. Those batches come in the order of the host
permutation of each epoch, ``np.random.RandomState(--seed)``'s shuffle, so
the port's unfused epochs take exactly the JAX iterator's rows."""

import numpy as np
import pytest

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data import device_resident as jdr
from neurips18_hierchical_image_manipulation_tpu.data.loader import (
    CreateDataLoader as JaxCreateDataLoader,
)
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.data import device_resident as pdr
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop
from test_torch_parallel import _stripes, _write_scenes
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = ["--label_nc", "8", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_layers_D", "2", "--num_D", "1", "--no_vgg_loss",
        "--gpu_ids", "-1", "--nThreads", "1", "--niter", "2", "--niter_decay", "0",
        "--print_freq", "100", "--save_epoch_freq", "100", "--seed", "7"]
KINDS = {   # the loader: (port class, the method a batch goes through, flags, JAX options);
    # 2 and 3 batches an epoch (4 scenes, 12 records)
    "aligned": (pdr.DeviceResidentLoader, "_sample",
                ["--no-use_bbox_dataset", "--no-use_masked_image", "--loadSize", "64",
                 "--fineSize", "32", "--resize_or_crop", "scale_width_and_crop",
                 "--batchSize", "2"],
                dict(use_bbox_dataset=False, use_masked_image=False, loadSize=64, fineSize=32,
                     resize_or_crop="scale_width_and_crop", batchSize=2)),
    "bbox": (pdr.DeviceResidentBboxLoader, "_draw",
             ["--fineSize", "32", "--min_box_size", "4", "--batchSize", "4"],
             dict(fineSize=32, min_box_size=4, batchSize=4)),
}


@pytest.fixture
def dataroot(tmp_path):
    return _write_scenes(tmp_path / "city", 4, (64, 128), _stripes)


def _jax_rows(dataroot, tmp_path, kind, epochs):
    """The rows of each batch the JAX resident iterator yields."""
    opt = JaxTrainOptions(name="j", checkpoints_dir=str(tmp_path / "jck"), dataroot=dataroot,
                          label_nc=8, device_resident_data=True, seed=7, **KINDS[kind][3])
    jl = JaxCreateDataLoader(opt)
    assert isinstance(jl, (jdr.DeviceResidentLoader, jdr.DeviceResidentBboxLoader))
    rows = []
    jl._draw = lambda idx, *key: rows.append(np.asarray(idx).tolist())
    for _ in range(epochs):
        for _ in jl:
            pass
    return rows


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("fused", [True, False])
def test_fused_flag_selects_the_step(dataroot, tmp_path, monkeypatch, kind, fused,
                                     restore_torch_precision):
    cls, method, extra, _ = KINDS[kind]
    taken, rows = [], []
    orig_resident, orig_step = loop.make_resident_train_step, loop.make_train_step
    monkeypatch.setattr(loop, "make_resident_train_step",
                        lambda *a, **k: taken.append("fused") or orig_resident(*a, **k))
    monkeypatch.setattr(loop, "make_train_step",
                        lambda *a, **k: taken.append("streamed") or orig_step(*a, **k))
    orig_draw = getattr(cls, method)

    def spy(self, *a):
        idx = a[1] if method == "_sample" else a[0]
        rows.append(np.asarray(idx).tolist())
        return orig_draw(self, *a)

    monkeypatch.setattr(cls, method, spy)
    argv = ["--name", "f", "--dataroot", dataroot, "--checkpoints_dir", str(tmp_path / "ck"),
            "--device_resident_data", *ARCH, *extra]
    state = mask2image_train.main(argv + ([] if fused else ["--no-fused_resident_step"]))
    assert taken == (["fused"] if fused else ["streamed"])
    steps_per_epoch = state.step // 2
    assert steps_per_epoch >= 2
    if fused:
        return   # the fused stream's permutation is the card's own (seed, epoch) draw
    assert len(rows) == 2 * steps_per_epoch
    want = _jax_rows(dataroot, tmp_path, kind, 2)
    assert rows == want
    assert rows[:steps_per_epoch] != rows[steps_per_epoch:]   # each epoch shuffles anew

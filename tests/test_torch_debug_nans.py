"""``--debug_nans`` (the JAX loop's ``jax_debug_nans``): a step whose loss,
metrics or gradients hold a non-finite value raises FloatingPointError
naming it, before any optimizer steps; a clean step, and a poisoned one
without the flag, do not raise."""

import numpy as np
import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from test_torch_profiler import M2I
from test_torch_box2mask_cli import dataroot  # noqa: F401  (fixture)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(gpu_ids="-1", label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            n_layers_D=2, num_D=1, no_vgg_loss=True, batchSize=2)


def _setup(pool=False):
    model = create_model(MaskToImageTrainOptions(**ARCH))
    state = make_optimizers(model.opt, model, 4)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(np.random.RandomState(0), 2, hw=(32, 32), label_nc=8).items()}
    return model, state, batch


def _poisoned(batch):
    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    bad["image"][0, 3, 5, 1] = float("nan")
    return bad


def test_debug_nans_raises_on_a_poisoned_step(restore_torch_precision):
    model, state, batch = _setup()
    before = {n: p.detach().clone() for n, p in model.netG.named_parameters()}
    step = steps.make_train_step(model, debug_nans=True)
    with pytest.raises(FloatingPointError, match="non-finite (loss|metric|gradient)"):
        step(state, _poisoned(batch))
    assert state.step == 0   # raised before the optimizers stepped
    assert all(torch.equal(p, before[n]) for n, p in model.netG.named_parameters())


def test_debug_nans_pooled_steps_raise(restore_torch_precision):
    model, state, batch = _setup()
    g_step, _ = steps.make_pooled_train_steps(model, debug_nans=True)
    with pytest.raises(FloatingPointError, match="non-finite"):
        g_step(state, _poisoned(batch))


def test_clean_step_and_flag_off_do_not_raise(restore_torch_precision):
    model, state, batch = _setup()
    metrics, _ = steps.make_train_step(model, debug_nans=True)(state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    metrics, _ = steps.make_train_step(model)(state, _poisoned(batch))
    assert not all(np.isfinite(float(v)) for v in metrics.values())


def test_debug_nans_cli_trains(dataroot, tmp_path, restore_torch_precision):  # noqa: F811
    state = mask2image_train.main(["--name", "n", "--dataroot", dataroot, "--checkpoints_dir",
                                   str(tmp_path / "ck"), "--niter", "1", "--debug_nans", *M2I])
    assert state.step == 4

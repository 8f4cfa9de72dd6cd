"""The port's mask2image GAN train step against the JAX package's, on the
CPU, from the same weights (a JAX init carried over through the npz
sidecar): every loss term, every G and D gradient leaf, the parameters
after 3 Adam steps, and the LR schedule."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.train.schedule import (
    linear_decay_schedule as jax_schedule,
)
from neurips18_hierchical_image_manipulation_tpu.train.state import (
    GANTrainState,
    make_optimizers as jax_make_optimizers,
)
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train.schedule import (
    linear_decay_schedule,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import make_train_step
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            batchSize=2, conv_precision="highest")
STEPS_PER_EPOCH = 10
N_ADAM = 3
# fp32, full-fp32 convolutions on both sides: the same math summed in
# another order through G (7 conv layers), 2 D applies and VGG19.
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3    # of each leaf's max |g|
# Adam's first steps are near-sign updates (m/sqrt(v) ~ ±1), so a gradient
# element within fp32 noise of 0 may flip its update; all else agrees to
# fp32 rounding. No element can move more than lr per step on either side.
PARAM_ATOL = 1e-6
PARAM_SHARE = 0.999


def _flat(tree):
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        out[key] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX side, once per module: init, losses, gradients at the init,
    and the params after N_ADAM steps of its make_train_step."""
    tmp = str(tmp_path_factory.mktemp("jax_step"))
    with jnnops.precision_scope():
        opt = JaxTrainOptions(name="s", checkpoints_dir=tmp, **ARCH)
        model = jax_create_model(opt)
        batch = synthetic_batch(np.random.RandomState(0), 2, hw=(32, 64), label_nc=8)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = model.init_params(jax.random.PRNGKey(0), jb)
        path = os.path.join(tmp, "p.npz")
        save_params_npz(path, params)
        with np.load(path) as f:
            flat = {k: f[k] for k in f.files}
        vgg = params.pop("VGG")
        loss_fn = jax_steps._make_loss_fn(model, vgg, None)
        grad_fn = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jb), has_aux=True))
        (_, (metrics, _)), grads = grad_fn(params)
        d_fake = np.random.RandomState(1).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
        d_loss, d_metrics = model.d_losses(params, jb, jnp.asarray(d_fake))
        tx_g, tx_d = jax_make_optimizers(opt, STEPS_PER_EPOCH)
        state = GANTrainState.create(params, tx_g, tx_d, jax.random.PRNGKey(1))
        step = jax_steps.make_train_step(model, vgg_params=vgg, donate=False)
        for _ in range(N_ADAM):
            state, _, _ = step(state, jb)
        return dict(
            batch=batch, flat=flat,
            metrics={k: float(v) for k, v in metrics.items()},
            grads=_flat(grads), params=_flat(state.params), d_fake=d_fake,
            d_loss=float(d_loss), d_metrics={k: float(v) for k, v in d_metrics.items()},
        )


def port_model(flat):
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH))
    sds = state_dicts_from_jax(flat)
    assert set(sds) == {"G", "D", "VGG"}
    for net, mod in (("G", model.netG), ("D", model.netD), ("VGG", model.vgg)):
        mod.load_state_dict(sds[net])
    return model


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_grads(model):
    """Every G/D parameter's gradient, keyed like the JAX tree (an unused
    parameter, e.g. a dead bias, has gradient 0 there and None here)."""
    sds = {
        net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in mod.named_parameters()}
        for net, mod in (("G", model.netG), ("D", model.netD))
    }
    return state_dicts_to_jax(sds)


def test_step_losses_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"])
    total, metrics, fake = model.losses(tbatch(jax_run["batch"]))
    assert fake.shape == (2, 32, 64, 3)
    assert set(metrics) == set(jax_run["metrics"])
    for k, want in jax_run["metrics"].items():
        got = float(metrics[k])
        assert want > 0 and abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)


def test_d_losses_match_jax(jax_run, restore_torch_precision):
    """The D-only objective against a given fake (the image-pool split step)."""
    model = port_model(jax_run["flat"])
    loss, metrics = model.d_losses(tbatch(jax_run["batch"]), torch.from_numpy(jax_run["d_fake"]))
    assert set(metrics) == set(jax_run["d_metrics"]) == {"D_real", "D_fake"}
    for got, want in [(float(loss), jax_run["d_loss"])] + [
            (float(metrics[k]), v) for k, v in jax_run["d_metrics"].items()]:
        assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_step_gradients_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"])
    total, _, _ = model.losses(tbatch(jax_run["batch"]))
    total.backward()
    got = port_grads(model)
    want = jax_run["grads"]
    assert set(got) == set(want)
    assert any(k.startswith("D/") for k in want) and any(k.startswith("G/") for k in want)
    live = 0
    for k, w in want.items():
        g = got[k].astype(np.float32)
        scale = np.abs(w).max()
        assert g.shape == w.shape, k
        if scale == 0:
            assert np.abs(g).max() == 0, k  # dead biases: 0 on both sides
            continue
        live += 1
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (k, np.abs(g - w).max(), scale)
    # G: 8 conv kernels + conv_out's bias; D: per scale 5 kernels + 2 live biases
    assert live == 9 + 2 * 7
    # VGG is a fixed feature extractor: it takes no gradient
    assert all(p.grad is None for p in model.vgg.parameters())


def test_adam_steps_match_jax(jax_run, restore_torch_precision):
    opt = MaskToImageTrainOptions(gpu_ids="-1", **ARCH)
    model = port_model(jax_run["flat"])
    state = make_optimizers(opt, model, STEPS_PER_EPOCH)
    step = make_train_step(model)
    batch = tbatch(jax_run["batch"])
    for _ in range(N_ADAM):
        metrics, fake = step(state, batch)
    assert state.step == N_ADAM and all(np.isfinite(float(v)) for v in metrics.values())
    got = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    want = jax_run["params"]
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    moved = np.concatenate(
        [np.abs(want[k] - jax_run["flat"][k]).ravel() for k in want]
    )
    assert moved.max() > 0.5 * N_ADAM * opt.lr  # the steps did move the params
    assert (diffs <= PARAM_ATOL).mean() >= PARAM_SHARE, (diffs > PARAM_ATOL).mean()
    assert diffs.max() <= 2 * N_ADAM * opt.lr, diffs.max()


@pytest.mark.parametrize(
    "niter,niter_decay,spe", [(2, 3, 4), (0, 1, 1), (5, 0, 2), (1, 2, 3)]
)
def test_schedule_matches_jax(niter, niter_decay, spe):
    want = jax_schedule(2e-4, niter, niter_decay, spe)
    got = linear_decay_schedule(2e-4, niter, niter_decay, spe)
    for s in range(0, (niter + niter_decay + 2) * spe):
        assert got(s) == pytest.approx(float(want(jnp.asarray(s))), rel=1e-6, abs=1e-12)


def test_lambda_lr_follows_schedule():
    """The optimizers' LR at each step is the schedule's value at it."""
    opt = MaskToImageTrainOptions(gpu_ids="-1", niter=1, niter_decay=2, **ARCH)
    model = create_model(opt)
    state = make_optimizers(opt, model, 2)
    sched = linear_decay_schedule(opt.lr, 1, 2, 2)
    for s in range(8):
        for o in (state.opt_g, state.opt_d):
            assert o.param_groups[0]["lr"] == pytest.approx(sched(s), rel=1e-6, abs=1e-12)
        state.sched_g.step()
        state.sched_d.step()

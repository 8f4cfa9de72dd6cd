"""``--use_dropout`` on the CPU: the port's G+D step against the JAX
package's with the keep masks the JAX forward drew (recovered from
``capture_intermediates``; where the dropout's input is 0 any mask gives
the same output), the per-step generator, the law of the masks, and
dropout off at inference, also of a model built for training."""

import os

import numpy as np
import pytest
import torch

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
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTrainOptions,
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=2, n_layers_D=2,
            num_D=1, no_vgg_loss=True, batchSize=2, conv_precision="highest", use_dropout=True)
LOSS_RTOL = 1e-4   # the bars of test_torch_train_step.py
GRAD_TOL = 1e-3    # of each leaf's max |g|


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX dropout step's losses and gradients, and the dropout
    layers' inputs and outputs of its G forward under the same rng."""
    tmp = str(tmp_path_factory.mktemp("jax_dropout"))
    with jnnops.precision_scope():
        jm = jax_create_model(JaxTrainOptions(name="d", checkpoints_dir=tmp, **ARCH))
        assert jm.wants_rng()
        batch = synthetic_batch(np.random.RandomState(0), 2, hw=(32, 64), label_nc=8)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jm.init_params(jax.random.PRNGKey(0), jb)
        path = os.path.join(tmp, "p.npz")
        save_params_npz(path, params)
        params.pop("VGG", None)
        loss_fn = jax_steps._make_loss_fn(jm, None, None)
        # the draw: under PRNGKey(5) this step's objective sits on a kink,
        # where two exact backward passes may return the gradients of
        # different pieces (test_dropout_kink_at_prngkey5 shows it);
        # PRNGKey(1), (2) and (3) give smooth points
        rng = jax.random.PRNGKey(1)
        (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, jb, rng), has_aux=True))(params)
        g_input, _, _ = jm.encode_input(jb, params=params)
        _, inter = jm.netG.apply(params["G"], *g_input, train=True, rngs={"dropout": rng},
                                 capture_intermediates=True, mutable=["intermediates"])
    layers = {}
    for name, sub in inter["intermediates"].items():
        if name.startswith("res") and "Dropout_0" in sub:
            layers[name] = (np.asarray(sub["norm1"]["__call__"][0]),
                            np.asarray(sub["Dropout_0"]["__call__"][0]))
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return dict(batch=batch, flat=flat, layers=layers,
                metrics={k: float(v) for k, v in metrics.items()},
                grads={"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                       for kp, v in jax.tree_util.tree_flatten_with_path(grads)[0]})


def port_model(flat):
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH))
    sds = state_dicts_from_jax(flat)
    model.netG.load_state_dict(sds["G"])
    model.netD.load_state_dict(sds["D"])
    return model


def test_jax_masks_recovered(jax_run):
    """Each JAX dropout layer keeps its input x2 or drops it to 0; its keep
    mask is readable wherever the input is not 0."""
    assert sorted(jax_run["layers"]) == ["res0", "res1"]
    for x, y in jax_run["layers"].values():
        kept = y != 0
        np.testing.assert_array_equal(y[kept], 2 * x[kept])
        live = x != 0
        share = kept[live].mean()
        assert 0.4 < share < 0.6 and live.mean() > 0.2


def test_dropout_step_matches_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"])
    masks = {getattr(model.netG, name): torch.from_numpy(y != 0)
             for name, (x, y) in jax_run["layers"].items()}
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    total, metrics, _ = model.losses(batch, rng=masks)
    total.backward()
    for k, want in jax_run["metrics"].items():
        got = float(metrics[k])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
    got = state_dicts_to_jax({net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                    for n, p in m.named_parameters()}
                              for net, m in (("G", model.netG), ("D", model.netD))})
    assert set(got) == set(jax_run["grads"])
    for k, w in jax_run["grads"].items():
        scale = np.abs(w).max()
        diff = np.abs(got[k] - w).max()
        assert diff <= GRAD_TOL * scale if scale else diff == 0, (k, diff, scale)


def test_mask_at_zero_inputs_is_free(jax_run):
    """Where the dropout's input is 0 the output is 0 whatever the mask."""
    x, y = jax_run["layers"]["res0"]
    keep = torch.from_numpy(y != 0)
    flipped = torch.where(torch.from_numpy(x == 0), ~keep, keep)
    a = networks.dropout(torch.from_numpy(x), keep)
    b = networks.dropout(torch.from_numpy(x), flipped)
    assert torch.equal(a, b) and torch.equal(a, torch.from_numpy(y))


def test_step_generator_is_a_function_of_seed_and_step():
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH))
    shape = (4, 16, 16, 32)

    def mask(step):
        return networks.dropout_keep_mask(shape, "cpu", steps.dropout_generator(model, step))

    assert torch.equal(mask(3), mask(3)) and not torch.equal(mask(3), mask(4))
    m = mask(7)
    assert abs(float(m.float().mean()) - 0.5) < 5 * 0.5 / np.sqrt(m.numel())
    model.opt.use_dropout = False
    assert steps.dropout_generator(model, 0) is None


def test_dropout_needs_a_generator_and_is_off_at_inference(jax_run):
    model = port_model(jax_run["flat"])
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    with pytest.raises(ValueError, match="per-step generator"):
        model.losses(batch)
    serve = create_model(MaskToImageTestOptions(gpu_ids="-1", **{
        k: v for k, v in ARCH.items() if k not in ("ndf", "n_layers_D", "num_D",
                                                   "no_vgg_loss", "batchSize")}))
    serve.netG.load_state_dict(model.netG.state_dict())
    assert serve.netG.res0.use_dropout and not serve.netG.training
    assert torch.equal(serve.inference(batch), serve.inference(batch))
    with pytest.raises(ValueError, match="not supported for netG=twostream"):
        create_model(BoxToMaskTrainOptions(gpu_ids="-1", label_nc=8, ngf=8, use_dropout=True))


def test_inference_of_a_training_model_has_no_dropout(jax_run):
    """``inference`` of a ``--use_dropout`` model built for training (netG in
    train mode) equals the same weights with dropout off (the JAX inference
    applies G deterministically)."""
    model = port_model(jax_run["flat"])
    assert model.netG.training and model.netG.res0.use_dropout
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    plain = create_model(MaskToImageTrainOptions(gpu_ids="-1", **{**ARCH, "use_dropout": False}))
    plain.netG.load_state_dict(model.netG.state_dict())
    assert not plain.netG.res0.use_dropout
    assert torch.equal(model.inference(batch), plain.inference(batch))
    with networks.dropout_masks(torch.Generator().manual_seed(0)):   # the scope is the switch
        assert not torch.equal(model.netG(model.encode_input(batch)), plain.inference(batch))


# ROADMAP C.10: the draw of PRNGKey(5) puts the step on a kink of its
# objective. Along d = g_port - g_jax the objective's one-sided derivatives
# differ by about |d|^2 (a V), the port's backward returns the right-hand
# piece's gradient and the JAX one the left-hand piece's; a step of
# KINK_STEP * d off the kink, on either side, the two agree within
# GRAD_TOL of each leaf's max. (Closer than about 1e-6 the two frameworks'
# roundings place the kink a few ulps apart; further than about 1e-5 the
# next kinks along d begin.)
KINK_KEY = 5
KINK_STEP = 3e-6
SLOPE_TOL = 0.05   # of |d|^2, the jump of the one-sided derivatives


def _key(kp):
    return "/".join(str(getattr(k, "key", k)) for k in kp)


@pytest.fixture(scope="module")
def kink(tmp_path_factory):
    """At PRNGKey(5): the JAX gradient, the masks its forward drew, the
    weights; and the JAX gradients a step either side along d."""
    tmp = str(tmp_path_factory.mktemp("jax_kink"))
    with jnnops.precision_scope():
        jm = jax_create_model(JaxTrainOptions(name="k", checkpoints_dir=tmp, **ARCH))
        batch = synthetic_batch(np.random.RandomState(0), 2, hw=(32, 64), label_nc=8)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jm.init_params(jax.random.PRNGKey(0), jb)
        path = os.path.join(tmp, "p.npz")
        save_params_npz(path, params)
        params.pop("VGG", None)
        loss_fn = jax_steps._make_loss_fn(jm, None, None)
        rng = jax.random.PRNGKey(KINK_KEY)
        grad_fn = jax.jit(jax.grad(lambda p: loss_fn(p, jb, rng)[0]))
        g_inp, _, _ = jm.encode_input(jb, params=params)
        _, inter = jm.netG.apply(params["G"], *g_inp, train=True, rngs={"dropout": rng},
                                 capture_intermediates=True, mutable=["intermediates"])
        masks = {n: np.asarray(s["Dropout_0"]["__call__"][0]) != 0
                 for n, s in inter["intermediates"].items()
                 if n.startswith("res") and "Dropout_0" in s}
        with np.load(path) as f:
            flat = {k: f[k] for k in f.files}
        g_jax = {_key(kp): np.asarray(v)
                 for kp, v in jax.tree_util.tree_flatten_with_path(grad_fn(params))[0]}
        g_port = _port_grads(flat, masks, batch)
        d = {k: g_port[k] - g_jax[k] for k in g_jax}
        off = {}
        for side in (1, -1):
            shifted = jax.tree_util.tree_map_with_path(
                lambda kp, v: v + side * KINK_STEP * jnp.asarray(d[_key(kp)]), params)
            off[side] = {_key(kp): np.asarray(v) for kp, v in
                         jax.tree_util.tree_flatten_with_path(grad_fn(shifted))[0]}
    return dict(flat=flat, masks=masks, batch=batch, g_jax=g_jax, g_port=g_port, d=d,
                jax_off=off)


def _port_grads(flat, masks, batch, shift=None):
    """The port's gradient of the step's objective under the JAX masks, at
    the weights ``flat`` (+ ``shift``)."""
    if shift is not None:
        flat = {k: v + shift[k] if k in shift else v for k, v in flat.items()}
    model = port_model(flat)
    keep = {getattr(model.netG, n): torch.from_numpy(m) for n, m in masks.items()}
    total, _, _ = model.losses({k: torch.from_numpy(v) for k, v in batch.items()}, rng=keep)
    total.backward()
    return state_dicts_to_jax({net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                     for n, p in m.named_parameters()}
                               for net, m in (("G", model.netG), ("D", model.netD))})


def _dot(a, b):
    return sum(float((a[k].astype(np.float64) * b[k]).sum()) for k in b)


def _worst(got, want):
    return max(np.abs(got[k] - w).max() / np.abs(w).max() for k, w in want.items()
               if np.abs(w).max())


def test_dropout_kink_at_prngkey5(kink, restore_torch_precision):
    """Both gradients at PRNGKey(5) are valid one-sided derivatives of the
    step's objective along their difference d: the port's is the right
    derivative, JAX's the left one (each read from the gradients a small
    step off the kink on its side), and off the kink the two agree."""
    d, g_port, g_jax = kink["d"], kink["g_port"], kink["g_jax"]
    assert _worst(g_port, g_jax) > GRAD_TOL   # at the kink itself they differ
    jump = _dot(d, d)
    slopes = {}
    for side in (1, -1):
        shift = {k: side * KINK_STEP * v for k, v in d.items()}
        port_off = _port_grads(kink["flat"], kink["masks"], kink["batch"], shift)
        jax_off = kink["jax_off"][side]
        assert _worst(port_off, jax_off) <= GRAD_TOL, side   # off the kink: the same gradient
        slopes[side] = _dot(port_off, d)
        assert abs(_dot(jax_off, d) - slopes[side]) <= SLOPE_TOL * jump, side
    # the one-sided derivatives along d jump by about |d|^2 across the kink
    assert slopes[1] - slopes[-1] >= (1 - 2 * SLOPE_TOL) * jump
    # the port's gradient gives the right derivative, JAX's the left one
    assert abs(_dot(g_port, d) - slopes[1]) <= SLOPE_TOL * jump
    assert abs(_dot(g_jax, d) - slopes[-1]) <= SLOPE_TOL * jump

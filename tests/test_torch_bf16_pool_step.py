"""The port's bf16 training tier and its image-pool split step against the
JAX package's, on the CPU, from the same weights (a JAX init carried over
through the npz sidecar).

bf16: the JAX tier is a different computation from its fp32 tier (bf16
convolutions at the default precision, one-pass IN statistics, loss terms
rounded to bf16, bf16 roundings in other places than the port's), so the
port is held to it relative to JAX's own bf16-vs-fp32 gap on the same
inputs: per loss term and per gradient leaf (max |diff|), the
port-vs-JAX-bf16 difference is at most ``BF16_GAP_FACTOR`` times the
JAX-bf16-vs-JAX-fp32 one. Measured on these inputs: at most 2.2 times (the
D_fake term and one D kernel), 1.6 or less elsewhere."""

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
from neurips18_hierchical_image_manipulation_tpu.train.state import (
    GANTrainState,
    make_optimizers as jax_make_optimizers,
)
from neurips18_hierchical_image_manipulation_tpu.utils.image_pool import (
    ImagePool as JaxImagePool,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.image_pool import ImagePool
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            batchSize=2)
STEPS_PER_EPOCH = 10
BF16_GAP_FACTOR = 3.0
LOSS_RTOL = 1e-4     # fp32 pooled steps: the same math in another order
PARAM_ATOL, PARAM_SHARE = 1e-6, 0.999   # one Adam step (test_torch_train_step)


def _flat(tree):
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _jax_tree(flat, template):
    """The JAX param tree of ``template``'s structure from a flat npz dict."""
    def leaf(keypath, t):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        assert flat[key].shape == t.shape, key
        return jnp.asarray(flat[key], t.dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


@pytest.fixture(scope="module")
def jax_side():
    """Once per module: weights (the port's init from --seed 0, carried
    into the JAX tree), the JAX fp32 and bf16 losses and gradients at them,
    and one pooled (passthrough) G step + D step in fp32."""
    batch = synthetic_batch(np.random.RandomState(0), 2, hw=(32, 64), label_nc=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH))
    flat = state_dicts_to_jax({net: m.state_dict() for net, m in init.nets().items()})
    out = dict(batch=batch, flat=flat)
    for dtype, prec in (("float32", "highest"), ("bfloat16", "auto")):
        with jnnops.precision_scope():
            opt = JaxTrainOptions(name="s", dtype=dtype, conv_precision=prec, **ARCH)
            model = jax_create_model(opt)
            params = _jax_tree(flat, jax.eval_shape(
                lambda: model.init_params(jax.random.PRNGKey(0), jb)))
            vgg = params.pop("VGG")
            compute = jnp.bfloat16 if dtype == "bfloat16" else None
            loss_fn = jax_steps._make_loss_fn(model, vgg, compute)
            (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(p, jb), has_aux=True))(params)
            out[dtype] = dict(metrics=_floats(metrics), grads=_flat(grads))
            if dtype == "float32":
                tx_g, tx_d = jax_make_optimizers(opt, STEPS_PER_EPOCH)
                state = GANTrainState.create(params, tx_g, tx_d, jax.random.PRNGKey(1))
                g_step, d_step = jax_steps.make_pooled_train_steps(model, vgg_params=vgg)
                state, m_g, fake = g_step(state, jb)
                state, m_d = d_step(state, jb, fake)
                out["pooled"] = dict(metrics=_floats({**m_g, **m_d}),
                                     fake=np.asarray(fake), params=_flat(state.params))
    return out


def port_model(flat, **kw):
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH, **kw))
    sds = state_dicts_from_jax(flat)
    for net, mod in (("G", model.netG), ("D", model.netD), ("VGG", model.vgg)):
        mod.load_state_dict(sds[net])
    return model


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_grads(model):
    return state_dicts_to_jax({
        net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in mod.named_parameters()}
        for net, mod in (("G", model.netG), ("D", model.netD))})


def test_cast_keeps_boxes_fp32_and_masters(jax_side):
    model = port_model(jax_side["flat"], dtype="bfloat16")
    batch = tbatch(jax_side["batch"])
    params, b = steps._loss_inputs(model, batch, torch.bfloat16)
    assert b["boxes"].dtype == torch.float32 and torch.equal(b["boxes"], batch["boxes"])
    assert b["image"].dtype == torch.bfloat16
    assert b["label"].dtype == batch["label"].dtype and b["inst"].dtype == batch["inst"].dtype
    assert set(params) == {"G", "D", "VGG"}
    assert all(t.dtype == torch.bfloat16 for sd in params.values() for t in sd.values())
    assert all(p.dtype == torch.float32 for p in model.netG.parameters())
    # the cast is differentiable: the fp32 master takes the gradient
    params["G"]["conv_out.bias"].float().sum().backward()
    assert model.netG.conv_out.bias.grad.dtype == torch.float32


def test_bf16_step_matches_jax_bf16(jax_side, restore_torch_precision):
    model = port_model(jax_side["flat"], dtype="bfloat16")
    params, b = steps._loss_inputs(model, tbatch(jax_side["batch"]), torch.bfloat16)
    total, metrics, fake = model.losses(b, params)
    assert fake.dtype == torch.bfloat16 and total.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in metrics.values())
    total.backward()
    want, ref = jax_side["bfloat16"], jax_side["float32"]
    rows = []
    for k, w in want["metrics"].items():
        rows.append((k, abs(float(metrics[k]) - w), abs(w - ref["metrics"][k])))
    got = port_grads(model)
    assert set(got) == set(want["grads"])
    live = 0
    for k, w in want["grads"].items():
        if np.abs(w).max() == 0:
            assert np.abs(got[k]).max() == 0, k  # dead biases
            continue
        live += 1
        rows.append((k, np.abs(got[k] - w).max(), np.abs(w - ref["grads"][k]).max()))
    bad = [r for r in rows if r[1] > BF16_GAP_FACTOR * r[2]]
    assert not bad, bad  # (term or leaf, port vs JAX bf16, JAX bf16 vs JAX fp32)
    assert live == 9 + 2 * 7


def test_pooled_steps_match_jax(jax_side, restore_torch_precision):
    """One passthrough-pooled G step and D step, fp32, Adam: the metrics,
    the fake and the parameters after both."""
    model = port_model(jax_side["flat"], conv_precision="highest")
    opt = model.opt
    state = make_optimizers(opt, model, STEPS_PER_EPOCH)
    g_step, d_step = steps.make_pooled_train_steps(model)
    batch = tbatch(jax_side["batch"])
    m_g, fake = g_step(state, batch)
    assert set(m_g) == {"G_GAN", "G_GAN_Feat", "G_VGG"} and state.step == 1
    m_d = d_step(state, batch, fake)
    want = jax_side["pooled"]
    for k, w in want["metrics"].items():
        assert abs(float({**m_g, **m_d}[k]) - w) <= LOSS_RTOL * abs(w), k
    # the generator's tanh output, fp32 (the port's CPU parity bound)
    np.testing.assert_allclose(fake.numpy(), want["fake"], atol=1e-4, rtol=0)
    got = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    diffs = np.concatenate([np.abs(got[k] - want["params"][k]).ravel() for k in want["params"]])
    assert (diffs <= PARAM_ATOL).mean() >= PARAM_SHARE, (diffs > PARAM_ATOL).mean()
    assert diffs.max() <= 2 * opt.lr


def test_passthrough_pool_equals_fused_step(jax_side, restore_torch_precision):
    """The JAX package's own check (tests/test_pooled_step.py), on the port."""
    batch = tbatch(jax_side["batch"])
    fused = port_model(jax_side["flat"], conv_precision="highest")
    s_fused = make_optimizers(fused.opt, fused, STEPS_PER_EPOCH)
    m_fused, fake_fused = steps.make_train_step(fused)(s_fused, batch)
    split = port_model(jax_side["flat"], conv_precision="highest")
    s_split = make_optimizers(split.opt, split, STEPS_PER_EPOCH)
    g_step, d_step = steps.make_pooled_train_steps(split)
    m_g, fake = g_step(s_split, batch)
    m_d = d_step(s_split, batch, fake)
    for k, v in {**m_g, **m_d}.items():
        assert abs(float(v) - float(m_fused[k])) <= 1e-5 * abs(float(m_fused[k])), k
    assert torch.equal(fake, fake_fused)
    for net in ("netG", "netD"):
        for (k, a), b in zip(getattr(fused, net).state_dict().items(),
                             getattr(split, net).state_dict().values()):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("pool_size,seed", [(0, 0), (3, 0), (4, 7)])
def test_image_pool_replays_like_jax(pool_size, seed):
    rng = np.random.RandomState(9)
    ours, theirs = ImagePool(pool_size, seed), JaxImagePool(pool_size, seed)
    for _ in range(6):
        fakes = rng.randn(2, 4, 5, 3).astype(np.float32)
        np.testing.assert_array_equal(ours.query(fakes), theirs.query(fakes))

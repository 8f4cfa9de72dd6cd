"""The port's multiscale PatchGAN discriminator, VGG19 feature taps and
pools against the JAX package's, with the JAX weights carried over through
the npz sidecar (``state_dicts_from_jax``)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.models import networks as jnet
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.ops import onehot_edges as jedges
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks as pnet
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops as pnnops
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
    state_dicts_to_jax,
)

# fp32, full-fp32 convolutions on both sides: the same math in another
# summation order through at most 5 conv layers (D) or 13 (VGG).
ATOL = 1e-4


@pytest.fixture
def highest():
    with jnnops.precision_scope("highest"):
        yield


def flat_of(tmp_path, tree):
    path = os.path.join(str(tmp_path), "p.npz")
    save_params_npz(path, tree)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def d_inputs(seed, b=2, hw=(32, 64), nc=8):
    batch = synthetic_batch(np.random.RandomState(seed), b, hw=hw, label_nc=nc)
    cond = np.array(jedges.encode_input(jnp.asarray(batch["label"]),
                                          jnp.asarray(batch["inst"]), nc))
    return cond, batch["image"]


def live_biases(flat, seed):
    """Non-zero values for every bias and norm scale, so each live one shows."""
    rng = np.random.RandomState(seed)
    return {k: (v + 0.3 * rng.randn(*v.shape)).astype(v.dtype)
            if k.rsplit("/", 1)[-1] in ("bias", "scale") else v for k, v in flat.items()}


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("paired", [False, True])
def test_multiscale_discriminator_matches_jax(highest, tmp_path, norm, paired):
    opt = JaxTrainOptions(label_nc=8, ndf=8, num_D=2, n_layers_D=3, norm=norm)
    cond, img = d_inputs(0)
    jd = jnet.define_D(opt)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(cond), jnp.asarray(img))
    flat = live_biases(flat_of(tmp_path, {"D": params}), 1)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, _unflat(flat, "D/params/"))}
    if paired:  # the batched [real; fake] apply: cond once, images stacked
        img = np.concatenate([img, img[::-1] * 0.5], 0)
    want = jd.apply(params, jnp.asarray(cond), jnp.asarray(img))
    pd = pnet.define_D(MaskToImageTrainOptions(label_nc=8, ndf=8, norm=norm),
                       torch.Generator().manual_seed(0))
    pd.load_state_dict(state_dicts_from_jax(flat)["D"])
    got = pd(torch.from_numpy(cond), torch.from_numpy(img))
    assert len(got) == len(want) == 2
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 5  # 4 layers' features, logits last
        for g, w in zip(gs, ws):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=0)


def _unflat(flat, prefix):
    """Flat npz keys under ``prefix`` -> the nested flax param dict."""
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_discriminator_logits_only_without_feature_matching(tmp_path):
    pd = pnet.define_D(MaskToImageTrainOptions(label_nc=8, ndf=8, no_ganFeat_loss=True),
                       torch.Generator().manual_seed(0))
    cond, img = d_inputs(2)
    out = pd(torch.from_numpy(cond), torch.from_numpy(img))
    assert [len(s) for s in out] == [1, 1] and out[0][0].shape[-1] == 1


def test_vgg19_taps_match_jax(highest, tmp_path):
    rng = np.random.RandomState(3)
    img = rng.uniform(-1, 1, size=(2, 32, 64, 3)).astype(np.float32)
    jv = jnet.Vgg19Features()
    params = jv.init(jax.random.PRNGKey(0), jnp.asarray(img))
    flat = flat_of(tmp_path, {"VGG": params})
    # He-scaled kernels so the deep taps stay O(1) (the N(0, 0.02) init
    # shrinks them ~100x per block) and every tap is a real comparison
    for k, v in flat.items():
        if k.endswith("kernel"):
            fan_in = v.shape[0] * v.shape[1] * v.shape[2]
            flat[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    flat = live_biases(flat, 4)
    want = jv.apply({"params": _unflat(flat, "VGG/params/")}, jnp.asarray(img))
    pv = pnet.Vgg19Features()
    pv.load_state_dict(state_dicts_from_jax(flat)["VGG"])
    got = pv(torch.from_numpy(img))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0.1
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL * np.abs(w).max(), rtol=0)


def test_state_dicts_round_trip_bit_exact(tmp_path):
    opt = MaskToImageTrainOptions(label_nc=8, ndf=8, norm="batch")
    vgg = pnet.Vgg19Features()
    vgg.reset_parameters(torch.Generator().manual_seed(2))
    nets = {
        "D": pnet.define_D(opt, torch.Generator().manual_seed(1)).state_dict(),
        "VGG": vgg.state_dict(),
    }
    flat = state_dicts_to_jax(nets)
    assert "D/params/scale1/layer0/kernel" in flat and "D/params/scale0/norm1/scale" in flat
    assert "VGG/params/conv5_4/kernel" in flat
    back = state_dicts_from_jax(flat)
    for net, sd in nets.items():
        assert set(back[net]) == set(sd)
        for k, t in sd.items():
            assert torch.equal(back[net][k], t), (net, k)


@pytest.mark.parametrize("shape", [(2, 32, 64, 5), (1, 17, 33, 3)])
def test_avg_pool_3x3s2_matches_jax(shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(jnnops.avg_pool_3x3s2(jnp.asarray(x)))
    got = pnnops.avg_pool_3x3s2(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_max_pool_2x2_matches_jax_with_ties():
    """Forward and backward; the relu'd input has many tied zeros, whose
    gradient goes to the first maximum of the window on both sides."""
    rng = np.random.RandomState(6)
    x = np.maximum(rng.randn(2, 8, 12, 4), 0).astype(np.float32)
    g = rng.randn(2, 4, 6, 4).astype(np.float32)
    y, vjp = jax.vjp(jnnops.max_pool_2x2, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pnnops.max_pool_2x2(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))

"""The training kernels' plain versions (what a CPU tensor takes) against
the JAX package's Pallas kernels in interpret mode: the InstanceNorm
backward, the loss reductions and the reflect-pad backward."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import instance_norm as pin
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import losses as plosses
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import reflect_pad as prp
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops as pnnops

# fp32: the same closed forms, summed in another order. dx is O(1) here.
IN_BWD_ATOL = 1e-5
LOSS_RTOL = 1e-6
PAD_ATOL = 1e-6


@pytest.fixture
def interpret():
    olds = (pin.INTERPRET, plosses.INTERPRET, prp.INTERPRET)
    pin.INTERPRET = plosses.INTERPRET = prp.INTERPRET = True
    yield
    pin.INTERPRET, plosses.INTERPRET, prp.INTERPRET = olds


# ---------------------------------------------------------------- IN backward

def jax_in_vjp(x, r, g, act):
    """jax.vjp of the JAX package's IN as ``networks.norm_act`` composes it
    with the Pallas tier on: fused_instance_norm (relu fused), lrelu after."""
    def f(x, r):
        y = pin.fused_instance_norm(x, relu=act == "relu", residual=r)
        return jnnops.leaky_relu(y, 0.2) if act == "lrelu" else y

    r = None if r is None else jnp.asarray(r)
    y, vjp = jax.vjp(f, jnp.asarray(x), r)
    dx, dr = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), None if r is None else np.asarray(dr)


def in_inputs(shape, seed, residual):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if residual else None
    g = rng.randn(*shape).astype(np.float32)
    return x, r, g


# (2, 17, 33, 128): an odd discriminator-site H x W
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (2, 17, 33, 128)])
@pytest.mark.parametrize("act,residual", [("none", False), ("relu", False), ("none", True),
                                          ("relu", True), ("lrelu", False)])
def test_in_backward_matches_jax_vjp(interpret, shape, act, residual):
    x, r, g = in_inputs(shape, 0, residual)
    want_y, want_dx, want_dr = jax_in_vjp(x, r, g, act)
    xt = torch.from_numpy(x)
    rt = None if r is None else torch.from_numpy(r)
    y, mean, rstd = kin.instance_norm(xt, act, rt)
    np.testing.assert_allclose(y.numpy(), want_y, atol=IN_BWD_ATOL, rtol=0)
    # the backward kernel's plain version
    dx, dres = kin.instance_norm_bwd(xt, y, torch.from_numpy(g), mean, rstd, act,
                                     want_dres=residual)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=IN_BWD_ATOL, rtol=0)
    if residual:
        np.testing.assert_allclose(dres.numpy(), want_dr, atol=IN_BWD_ATOL, rtol=0)
    # the autograd.Function networks.norm_act uses, and plain autograd
    for fn in (kin.instance_norm_act, kin.instance_norm_act_plain):
        xg = xt.clone().requires_grad_(True)
        rg = None if rt is None else rt.clone().requires_grad_(True)
        fn(xg, act, rg).backward(torch.from_numpy(g))
        np.testing.assert_allclose(xg.grad.numpy(), want_dx, atol=IN_BWD_ATOL, rtol=0)
        if residual:
            np.testing.assert_allclose(rg.grad.numpy(), want_dr, atol=IN_BWD_ATOL, rtol=0)


def test_in_backward_residual_only():
    """Only the residual needs a gradient: it is the masked cotangent."""
    x, r, g = in_inputs((1, 5, 7, 16), 1, True)
    rg = torch.from_numpy(r).requires_grad_(True)
    y = kin.instance_norm_act(torch.from_numpy(x), "relu", rg)
    y.backward(torch.from_numpy(g))
    want = np.where(y.detach().numpy() > 0, g, 0.0)
    np.testing.assert_array_equal(rg.grad.numpy(), want)


def test_in_backward_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 8)
    stats = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        kin.instance_norm_bwd(x, x, torch.zeros(1, 4, 4, 4), stats, stats, "relu")
    with pytest.raises(ValueError):
        kin.instance_norm_bwd(x, None, x, stats, stats, "relu")
    with pytest.raises(ValueError):
        kin.instance_norm_bwd(x, x, x, torch.zeros(8), stats, "none")


# ---------------------------------------------------------------- losses

# 3 * 100 * 100 * 10 = 300000 >= the Pallas chunk (262144), not a multiple
LOSS_SHAPE = (3, 100, 100, 10)


def close(got, want, rtol):
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_mse_to_scalar_matches_pallas(interpret, target):
    rng = np.random.RandomState(2)
    pred = (rng.randn(*LOSS_SHAPE) * 0.7 + 0.4).astype(np.float32)
    assert pred.size >= plosses._CHUNK
    want, want_g = jax.value_and_grad(lambda p: plosses.mse_to_scalar(p - target))(
        jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = klosses.mse_to_scalar(pt, target)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    close(float(got.detach()), float(want), LOSS_RTOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g), rtol=LOSS_RTOL, atol=0)


def test_l1_to_scalar_matches_pallas(interpret):
    rng = np.random.RandomState(3)
    a = rng.randn(*LOSS_SHAPE).astype(np.float32)
    b = rng.randn(*LOSS_SHAPE).astype(np.float32)
    want, (ga, gb) = jax.value_and_grad(
        lambda a, b: plosses.l1_to_scalar(a - b), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    got = klosses.l1_to_scalar(at, bt)
    got.backward()
    close(float(got.detach()), float(want), LOSS_RTOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=LOSS_RTOL, atol=0)


def test_small_losses_and_plain_versions():
    """Below the Pallas chunk the JAX package takes jnp.mean; the port's
    entry points and plain versions agree with it there too."""
    rng = np.random.RandomState(4)
    a = rng.randn(2, 7, 11, 1).astype(np.float32)
    b = rng.randn(2, 7, 11, 1).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    close(float(klosses.mse_to_scalar(at, 1.0)), float(jnp.mean(jnp.square(a - 1.0))), 1e-6)
    close(float(klosses.mse_to_scalar_plain(at, 1.0)), float(jnp.mean(jnp.square(a - 1.0))), 1e-6)
    close(float(klosses.l1_to_scalar(at, bt)), float(jnp.mean(jnp.abs(a - b))), 1e-6)
    close(float(klosses.l1_to_scalar_plain(at, bt)), float(jnp.mean(jnp.abs(a - b))), 1e-6)
    with pytest.raises(ValueError):
        klosses.l1_to_scalar(at, bt[:1])
    with pytest.raises(ValueError):
        klosses.mse_to_scalar(at.double(), 0.0)


# ---------------------------------------------------------------- reflect pad

def jax_pad_vjp(x, g, p, fused):
    def f(x):
        if fused:
            return prp.reflect_pad_fused_bwd(x, p)
        return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")

    y, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("n,h,w,c,p", [(2, 8, 16, 32, 1), (1, 12, 20, 8, 3), (2, 9, 11, 16, 3)])
def test_reflect_pad_backward_matches_pallas(interpret, n, h, w, c, p):
    rng = np.random.RandomState(5)
    x = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, h + 2 * p, w + 2 * p, c).astype(np.float32)
    want_y, want_dx = jax_pad_vjp(x, g, p, fused=True)
    dx = krp.reflect_pad_bwd(torch.from_numpy(g), p)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=PAD_ATOL, rtol=0)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pnnops.reflect_pad(xt, p)
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=PAD_ATOL, rtol=0)


# mirrors that overlap (h <= 2p + 1): the TPU kernel refused these; held
# against the VJP of jnp.pad, the JAX package's plain pad
@pytest.mark.parametrize("h,w,p", [(2, 3, 1), (4, 5, 3), (3, 7, 2)])
def test_reflect_pad_backward_overlapping_mirrors(h, w, p):
    rng = np.random.RandomState(6)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    g = rng.randn(2, h + 2 * p, w + 2 * p, 4).astype(np.float32)
    _, want_dx = jax_pad_vjp(x, g, p, fused=False)
    dx = krp.reflect_pad_bwd(torch.from_numpy(g), p)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=PAD_ATOL, rtol=0)


def test_reflect_pad_backward_rejects_bad_inputs():
    with pytest.raises(ValueError):
        krp.reflect_pad_bwd(torch.zeros(1, 4, 6, 2), 2)  # H = 0
    with pytest.raises(ValueError):
        krp.reflect_pad_bwd(torch.zeros(1, 6, 6, 2).permute(0, 2, 1, 3), 1)

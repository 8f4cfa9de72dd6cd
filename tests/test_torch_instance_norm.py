"""The port's fused InstanceNorm (kernels/instance_norm.py) against the JAX
package's ``fused_instance_norm`` (Pallas interpret mode at C = 128, its
lax path at C = 64, where the c % 128 gate sends it)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import instance_norm as pin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops as pnnops

# fp32: both sides take fp32 statistics of the same values; only the
# summation order differs (XLA vs torch reductions) -> a few ulps of |y| <= 6.
FP32_ATOL = 1e-5
# bf16: the JAX composition rounds IN(x) to bf16 and then rounds again after
# the residual add; the port's kernel (and its plain version) adds in fp32
# and rounds once. Two roundings vs one differ by at most one bf16 ulp
# (2^-8 relative) of the result plus half an ulp of the pre-add IN value.
BF16_RTOL = 2.0**-7
BF16_ATOL = 2.0**-6


@pytest.fixture
def interpret():
    old = pin.INTERPRET
    pin.INTERPRET = True
    yield
    pin.INTERPRET = old


def inputs(shape, seed, residual):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32) if residual else None
    return x, r


def jax_in(x, r, relu, dt=jnp.float32):
    return np.asarray(
        pin.fused_instance_norm(
            jnp.asarray(x).astype(dt), relu=relu,
            residual=None if r is None else jnp.asarray(r).astype(dt),
        ).astype(jnp.float32)
    )


def port_in(x, r, act, dt=torch.float32):
    y, mean, rstd = kin.instance_norm(
        torch.from_numpy(x).to(dt), act, None if r is None else torch.from_numpy(r).to(dt)
    )
    return y, mean, rstd


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (1, 8, 8, 64)])
def test_in_matches_fused_instance_norm_fp32(interpret, shape, act, residual):
    x, r = inputs(shape, 0, residual)
    want = jax_in(x, r, act == "relu")
    got, _, _ = port_in(x, r, act)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_in_matches_fused_instance_norm_bf16(interpret, act):
    x, r = inputs((2, 8, 16, 128), 1, True)
    want = jax_in(x, r, act == "relu", jnp.bfloat16)
    got, _, _ = port_in(x, r, act, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
def test_in_act_matches_instance_norm_act(act):
    """The wrapper (lrelu included, which fused_instance_norm lacks) and the
    port's nnops.instance_norm_act against the JAX nnops.instance_norm_act."""
    x, _ = inputs((2, 6, 10, 32), 2, False)
    want = np.asarray(jnnops.instance_norm_act(jnp.asarray(x), act))
    got, _, _ = port_in(x, None, act)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    got = pnnops.instance_norm_act(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


def test_plain_instance_norm_matches_jax():
    x, _ = inputs((2, 9, 11, 24), 4, False)
    want = np.asarray(jnnops.instance_norm(jnp.asarray(x)))
    got = pnnops.instance_norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


def test_batch_norm_matches_jax():
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 5, 7, 16) * 3 - 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    want = np.asarray(jnnops.batch_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = pnnops.batch_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


def test_in_stats_match_float64():
    x, _ = inputs((2, 7, 9, 48), 3, False)
    _, mean, rstd = port_in(x, None, "none")
    x64 = x.astype(np.float64)
    m = x64.mean(axis=(1, 2))
    v = ((x64 - m[:, None, None]) ** 2).mean(axis=(1, 2))
    np.testing.assert_allclose(mean.numpy(), m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(v + 1e-5), rtol=1e-5)
    assert mean.shape == rstd.shape == (2, 48)


@pytest.mark.parametrize(
    "n,hw,c",
    [(1, 131072, 64), (1, 32768, 128), (1, 512, 1024), (8, 512, 1024), (3, 7, 16),
     (8, 131072, 64)],
)
def test_in_splits_cover_hw(n, hw, c):
    """The forward plan's blocks cover the HW rows once: no block empty, no
    row left; a split block takes whole passes of its 32 row lanes."""
    plan = kin._fwd_plan(n, 1, hw, c, torch.float32)
    s, chunk = plan["splits"], plan["chunk"]
    assert s >= 1
    assert (s - 1) * chunk < hw <= s * chunk
    if plan["variant"] == "split":
        assert chunk % 32 == 0
    else:
        assert plan["cluster"] == s <= 16


def test_in_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        kin.instance_norm(x, "gelu")
    with pytest.raises(ValueError):
        kin.instance_norm(x.permute(0, 2, 1, 3), "none")
    with pytest.raises(ValueError):
        kin.instance_norm(x, "none", residual=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError):
        kin.instance_norm(x.double(), "none")

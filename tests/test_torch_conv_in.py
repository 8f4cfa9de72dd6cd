"""The port's fused conv3x3 + IN (+ residual) (+ ReLU) against the JAX
package's ``conv3x3_in_act``, on the CPU: the plain version against the
Pallas kernel in interpret mode and against its ``_reference``, and the
differentiable op's gradient against ``jax.grad`` of the JAX function. On
the CPU the op takes its plain forward; its backward, the recomputed plain
composition, is the one the kernel path uses on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.ops.pallas import conv_in as pconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv

# fp32 on both sides: the same conv and two-pass IN statistics, summed in
# another order (the JAX Pallas test's own tolerance)
ATOL, RTOL = 3e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4


@pytest.fixture(autouse=True)
def interpret_conv():
    old = pconv.INTERPRET
    pconv.INTERPRET = True
    yield
    pconv.INTERPRET = old


def inputs(rng, n, h, w, cin, cout, with_res):
    x = rng.randn(n, h, w, cin).astype(np.float32) * 0.5
    w3 = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05
    b = rng.randn(cout).astype(np.float32)
    res = rng.randn(n, h, w, cout).astype(np.float32) if with_res else None
    return x, w3, b, res


def t(a):
    return None if a is None else torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


# the Pallas test's cases (tests/test_pallas_kernels.py), plus its fallback
# shape (Cout 24, 4x4) and an odd one
CASES = [((2, 8, 16, 128, 128), True, False), ((2, 8, 16, 128, 128), False, True),
         ((2, 8, 16, 128, 128), False, False), ((1, 4, 4, 8, 24), True, False),
         ((2, 9, 17, 12, 40), True, True)]


@pytest.mark.parametrize("shape,relu,with_res", CASES)
def test_plain_matches_jax(rng, shape, relu, with_res):
    x, w3, b, res = inputs(rng, *shape, with_res)
    got = kconv.conv3x3_in_act(t(x), t(w3), t(b), relu=relu, residual=t(res)).numpy()
    assert got.shape == shape[:3] + (shape[4],)
    for want in (pconv.conv3x3_in_act(j(x), j(w3), j(b), relu=relu, residual=j(res)),
                 pconv._reference(j(x), j(w3), j(b), j(res), relu)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_res", [False, True])
def test_gradient_matches_jax(rng, with_res):
    n, h, w, c = 1, 8, 8, 128
    x, w3, b, res = inputs(rng, n, h, w, c, c, with_res)
    g = rng.randn(n, h, w, c).astype(np.float32)

    def f(x_, w_, b_, *r):
        return jnp.sum(pconv.conv3x3_in_act(x_, w_, b_, relu=True,
                                            residual=r[0] if r else None) * g)

    args = [j(x), j(w3), j(b)] + ([j(res)] if with_res else [])
    want = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    leaves = [t(x).requires_grad_(), t(w3).requires_grad_(), t(b).requires_grad_()]
    r = t(res).requires_grad_() if with_res else None
    y = kconv.conv3x3_in_act(*leaves, relu=True, residual=r)
    (y * t(g)).sum().backward()
    got = [p.grad for p in leaves] + ([r.grad] if with_res else [])
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_reflect_edges():
    """Row and column -1 read 1, H and W read H-2, W-2: a one-hot x at an
    edge pixel lands on the mirrored taps (the conv before IN)."""
    x = torch.zeros(1, 3, 4, 1)
    x[0, 1, 1, 0] = 1.0
    w3 = torch.arange(9, dtype=torch.float32).reshape(3, 3, 1, 1) + 1
    pre = kconv.nnops.conv2d(kconv.nnops.reflect_pad(x, 1), w3.permute(3, 2, 0, 1))
    # output (1, 1) sees x[1, 1] through the centre tap only; the corner
    # outputs (0, 0) and (2, 0) see it through the four corner taps (row
    # and column -1 and H read row and column 1)
    assert pre[0, 1, 1, 0] == 5.0
    assert pre[0, 0, 0, 0] == pre[0, 2, 0, 0] == 1.0 + 3.0 + 7.0 + 9.0


def test_wrapper_checks():
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="H, W > 1"):
        kconv.conv3x3_in_act(x, torch.zeros(3, 3, 8, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="HWIO"):
        kconv.conv3x3_in_act(torch.zeros(1, 4, 4, 8), torch.zeros(8, 8, 3, 3), torch.zeros(8))

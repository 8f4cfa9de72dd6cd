"""The loss kernel's groups (``kernels/losses.reduce_group``: up to 16 terms
in one launch) on the CPU, where a group takes its plain version: each term
against the JAX package's Pallas ``mse_to_scalar`` / ``l1_to_scalar``
(interpret mode) and its VJP, the four losses against the JAX losses on
the same numpy inputs, and the group table's validation. The kernel itself
is held to the plain version on the card (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu import losses as jlosses
from neurips18_hierchical_image_manipulation_tpu.ops.pallas import losses as plosses
from neurips18_hierchical_image_manipulation_tpu_torch import losses as tlosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses

LOSS_RTOL = 1e-6       # fp32: one sum in another order (test_torch_train_kernels.py)
SUM_RTOL = 1e-5        # the fp32 values of bf16 inputs: a sum of 300k terms in
                       # another order (chip_smoke.LOSS_RTOL)
BF16_RTOL = 2.0**-7    # one bf16 rounding: of a gradient, or of the diff the
                       # JAX package takes in bf16 before its fp32 sum


@pytest.fixture
def interpret():
    old = plosses.INTERPRET
    plosses.INTERPRET = True
    yield
    plosses.INTERPRET = old


# sizes: one element, a D logit, the Pallas chunk and more (not a multiple
# of 8: 300_001), a small odd one; modes alternate, targets scalar or tensor
SIZES = (1, 2345, 300_001, 77)


def numpy_terms(seed):
    rng = np.random.RandomState(seed)
    out = []
    for k, n in enumerate(SIZES):
        a = (rng.randn(n) * 0.7 + 0.4).astype(np.float32)
        b = rng.randn(n).astype(np.float32)
        out.append(("mse", a, float(k % 2)))
        out.append(("l1", a, b))
        out.append(("mse", b, a))
    return out


def jax_term(mode, a, t):
    d = a - t
    return plosses.mse_to_scalar(d) if mode == "mse" else plosses.l1_to_scalar(d)


def as_torch(terms, dt):
    return [(m, torch.from_numpy(a).to(dt).requires_grad_(True),
             torch.from_numpy(t).to(dt).requires_grad_(True) if isinstance(t, np.ndarray) else t)
            for m, a, t in terms]


def upcast(x):
    """bf16 numpy values as fp32 (bf16 -> fp32 is exact)."""
    return x.detach().float().numpy() if torch.is_tensor(x) else x


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_group_matches_pallas_and_its_vjp(interpret, dt):
    """Each term of a mixed group against the Pallas reduction of the same
    values (bf16: their fp32 values, as the kernel takes the difference in
    fp32), and the gradient of a weighted sum of the terms against the JAX
    VJP."""
    terms = as_torch(numpy_terms(1), dt)
    weights = np.random.RandomState(2).rand(len(terms)).astype(np.float32)
    got = klosses.reduce_group(terms)
    assert got.shape == (len(terms),) and got.dtype == torch.float32
    (got * torch.from_numpy(weights)).sum().backward()
    leaves = [(upcast(a), upcast(t)) for _, a, t in terms]

    def weighted(leaves):
        vals = [jax_term(m, a, t) for (m, _, _), (a, t) in zip(terms, leaves)]
        return jnp.stack(vals), sum(w * v for w, v in zip(weights, vals))

    (want, _), vjp = jax.vjp(weighted, leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOSS_RTOL if dt == torch.float32 else SUM_RTOL, atol=0)
    (grads,) = vjp((jnp.zeros(len(terms)), jnp.float32(1.0)))
    for (_, a, t), (ga, gt) in zip(terms, grads):
        # bf16: the kernel's fp32 gradient, rounded once to bf16
        want_a = torch.from_numpy(np.asarray(ga)).to(dt).float().numpy()
        np.testing.assert_allclose(a.grad.float().numpy(), want_a,
                                   rtol=LOSS_RTOL if dt == torch.float32 else BF16_RTOL, atol=0)
        if torch.is_tensor(t):
            np.testing.assert_allclose(t.grad.float().numpy(), -a.grad.float().numpy())
    if dt == torch.bfloat16:
        # against the JAX package's own bf16 path: the diff rounded to bf16
        for (m, a, t), v in zip(terms, got.detach().numpy()):
            ja = jnp.asarray(upcast(a)).astype(jnp.bfloat16)
            jt = jnp.asarray(upcast(t)).astype(jnp.bfloat16) if torch.is_tensor(t) else t
            np.testing.assert_allclose(v, float(jax_term(m, ja, jt)), rtol=BF16_RTOL, atol=0)


def test_group_equals_terms_alone_and_plain():
    terms = as_torch(numpy_terms(3), torch.float32)
    grouped = klosses.reduce_group(terms)
    alone = torch.cat([klosses.reduce_group([t]) for t in terms])
    plain = klosses.reduce_group_plain(terms)
    assert torch.equal(grouped, alone) and torch.equal(grouped, plain)
    for k, (m, a, t) in enumerate(terms):
        if m == "mse" and not torch.is_tensor(t):
            assert torch.equal(klosses.mse_to_scalar(a, t), grouped[k])
        if m == "l1":
            assert torch.equal(klosses.l1_to_scalar(a, t), grouped[k])


def test_reduce_terms_splits_at_16(monkeypatch):
    rng = np.random.RandomState(4)
    terms = [("l1", torch.from_numpy(rng.randn(5 + k).astype(np.float32)),
              torch.from_numpy(rng.randn(5 + k).astype(np.float32))) for k in range(20)]
    terms += [("mse", torch.from_numpy(rng.randn(9).astype(np.float32)), 1.0)]
    sizes = []
    group = klosses.reduce_group

    def counted(t):
        sizes.append(len(t))
        return group(t)

    monkeypatch.setattr(klosses, "reduce_group", counted)
    got = klosses.reduce_terms(terms)
    assert sizes == [16, 5]
    want = torch.cat([klosses.reduce_group_plain(terms[:16]),
                      klosses.reduce_group_plain(terms[16:])])
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["mixed dtype", "17 terms", "empty term", "no term",
                                  "unknown mode", "shape mismatch"])
def test_group_table_validation(case):
    a = torch.randn(6)
    terms = {
        "mixed dtype": [("l1", a, a), ("l1", a.bfloat16(), a.bfloat16())],
        "17 terms": [("mse", a, 0.0)] * 17,
        "empty term": [("mse", a, 0.0), ("l1", a[:0], a[:0])],
        "no term": [],
        "unknown mode": [("huber", a, 0.0)],
        "shape mismatch": [("l1", a, a[:3])],
    }[case]
    with pytest.raises(ValueError):
        klosses.reduce_group(terms)
    with pytest.raises(ValueError):
        klosses.reduce_group_plain(terms)


# ---------------------------------------------------------------- the losses

def d_outputs(rng, n_layers=2, num_d=2, c=4):
    """A multiscale D output: per scale n_layers features, then logits."""
    out = []
    for s in range(num_d):
        h = 12 >> s
        out.append([rng.randn(2, h + k, h + 2 * k, c * (k + 1)).astype(np.float32)
                    for k in range(n_layers)] + [rng.randn(2, h, h + 1, 1).astype(np.float32)])
    return out


def torch_tree(tree):
    return [[torch.from_numpy(f).requires_grad_(True) for f in scale] for scale in tree]


def jax_tree(tree):
    return [[jnp.asarray(f) for f in scale] for scale in tree]


@pytest.mark.parametrize("use_lsgan", [True, False])
def test_gan_and_discriminator_losses_match_jax(use_lsgan):
    rng = np.random.RandomState(5)
    real, fake = d_outputs(rng), d_outputs(rng)
    for target in (True, False):
        tf = torch_tree(fake)
        got = tlosses.gan_loss(tf, target, use_lsgan)
        want, grads = jax.value_and_grad(lambda t: jlosses.gan_loss(t, target, use_lsgan))(
            jax_tree(fake))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        got.backward()
        for s in range(len(fake)):
            np.testing.assert_allclose(tf[s][-1].grad.numpy(), np.asarray(grads[s][-1]),
                                       rtol=LOSS_RTOL, atol=1e-12)
    got = tlosses.discriminator_loss(torch_tree(real), torch_tree(fake), use_lsgan)
    want = jlosses.discriminator_loss(jax_tree(real), jax_tree(fake), use_lsgan)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
    # a single logits tensor and a single list take the same terms
    x = real[0][-1]
    np.testing.assert_allclose(float(tlosses.gan_loss(torch.from_numpy(x), True, use_lsgan)),
                               float(jlosses.gan_loss(jnp.asarray(x), True, use_lsgan)),
                               rtol=LOSS_RTOL)


def test_feature_matching_loss_matches_jax():
    rng = np.random.RandomState(6)
    real, fake = d_outputs(rng, n_layers=3), d_outputs(rng, n_layers=3)
    tf, tr = torch_tree(fake), torch_tree(real)
    got = tlosses.feature_matching_loss(tf, tr, n_layers_D=3, num_D=2, lambda_feat=10.0)
    want, grads = jax.value_and_grad(lambda f: jlosses.feature_matching_loss(
        f, jax_tree(real), n_layers_D=3, num_D=2, lambda_feat=10.0))(jax_tree(fake))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    got.backward()
    for s in range(2):
        for k in range(3):
            np.testing.assert_allclose(tf[s][k].grad.numpy(), np.asarray(grads[s][k]),
                                       rtol=LOSS_RTOL, atol=1e-12)
            assert tr[s][k].grad is None  # the real branch is detached


def test_vgg_loss_matches_jax():
    """A stand-in feature extractor of 5 taps, the same on both sides."""
    rng = np.random.RandomState(7)
    fake = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)

    def taps(x, ops):
        return [ops.tanh(x[:, ::1 << k, ::1 << k] * (k + 1)) + 0.1 * k for k in range(5)]

    tfake = torch.from_numpy(fake).requires_grad_(True)
    got = tlosses.vgg_loss(lambda x: taps(x, torch), tfake, torch.from_numpy(real))
    want, grad = jax.value_and_grad(
        lambda f: jlosses.vgg_loss(lambda p, x: taps(x, jnp), None, f, jnp.asarray(real)))(
        jnp.asarray(fake))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    got.backward()
    # five taps' gradients summed through tanh in another order
    np.testing.assert_allclose(tfake.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-7)

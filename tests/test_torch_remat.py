"""``--remat`` / ``--remat_policy`` on the CPU: each policy's train step
(losses and every gradient, fp32 and bf16, with and without dropout)
equals the plain step's bit for bit; ``conv_out`` recomputes no
convolution in backward, ``block`` both of each block's; the remat
generator equals the JAX package's ``remat=True`` one within its own test's
1e-6 / 1e-5; the policy rules and the refused combinations."""

import os
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models import networks as jnet
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
    check_train_options,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    params_from_jax,
    params_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(gpu_ids="-1", label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=2,
            n_layers_D=2, num_D=1, no_vgg_loss=True, batchSize=2, conv_precision="highest")


class ConvCount(TorchDispatchMode):
    """Counts the forward convolutions dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _step(policy, dtype, dropout):
    """(metrics, fake, {net: {name: grad}}, forward convs recomputed in
    backward) of one G+D objective under ``policy``. oneDNN is off: its CPU
    convolutions did not give the same bits on every call (one run in
    about ten of this file), which a bit-for-bit comparison cannot take."""
    with torch.backends.mkldnn.flags(enabled=False):
        return _step_on(policy, dtype, dropout)


def _step_on(policy, dtype, dropout):
    model = create_model(MaskToImageTrainOptions(remat_policy=policy, use_dropout=dropout,
                                                 **ARCH))
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(np.random.RandomState(0), 2, hw=(32, 64), label_nc=8).items()}
    params, b = steps._loss_inputs(model, batch, dtype)
    kw = {"rng": steps.seeded_generator("cpu", 0, steps._DROPOUT_TAG, 0)} if dropout else {}
    total, metrics, fake = model.losses(b, params, **kw)
    with ConvCount() as count:
        total.backward()
    grads = {net: {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
             for net, m in model.nets().items()}
    return {k: v.detach() for k, v in metrics.items()}, fake.detach(), grads, count.n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("policy", ["block", "conv_out"])
def test_remat_step_bit_exact(policy, dtype, restore_torch_precision):
    m0, f0, g0, _ = _step("none", dtype, False)
    m1, f1, g1, _ = _step(policy, dtype, False)
    assert torch.equal(f0, f1)
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert g0.keys() == g1.keys()
    for net in g0:
        assert g0[net].keys() == g1[net].keys() and g0[net]
        for n in g0[net]:
            assert torch.equal(g0[net][n], g1[net][n]), (policy, net, n)


@pytest.mark.parametrize("policy", ["block", "conv_out"])
def test_remat_dropout_step_bit_exact(policy, restore_torch_precision):
    """The keep masks drawn before the checkpointed region: the recompute
    reads them, and the step equals the plain dropout step."""
    m0, f0, g0, _ = _step("none", None, True)
    m1, f1, g1, _ = _step(policy, None, True)
    assert torch.equal(f0, f1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    for net in g0:
        for n in g0[net]:
            assert torch.equal(g0[net][n], g1[net][n]), (policy, net, n)


def test_conv_out_recomputes_no_convolution(restore_torch_precision):
    counts = {p: _step(p, None, False)[3] for p in networks.REMAT_POLICIES}
    assert counts == {"none": 0, "block": 2 * ARCH["n_blocks_global"], "conv_out": 0}


def test_remat_generator_matches_jax():
    """``tests/test_schedule_and_freeze.py::test_remat_generator_matches``'s
    generator: the port's under ``block`` against the JAX ``remat=True``
    one, the output within 1e-6 and the gradients of sum(y^2) within 1e-5
    of each leaf's largest entry (that test's 1e-5 compares two JAX runs;
    across the two frameworks fp32 sums differ in order, and these
    gradients reach 6)."""
    x = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    with jnnops.precision_scope():
        jnnops.set_default_precision("highest")
        g1 = jnet.GlobalGenerator(output_nc=2, ngf=4, n_downsampling=1, n_blocks=2, remat=True)
        params = g1.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y_jax = np.asarray(g1.apply(params, jnp.asarray(x)))
        d_jax = jax.grad(lambda p: jnp.sum(g1.apply(p, jnp.asarray(x)) ** 2))(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.npz")
        save_params_npz(path, {"G": params})
        with np.load(path) as f:
            flat = {k: f[k] for k in f.files}
    g = networks.GlobalGenerator(4, output_nc=2, ngf=4, n_downsampling=1, n_blocks=2,
                                 remat_policy=networks.remat_policy(True))
    g.load_state_dict(params_from_jax(flat))
    y = g(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), y_jax, atol=1e-6)
    (y ** 2).sum().backward()
    got = params_to_jax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in g.named_parameters()})
    want = {"G/params/" + "/".join(str(getattr(k, "key", k)) for k in kp[1:]): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(d_jax)[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=k)


def test_remat_policy_rules():
    assert networks.remat_policy(False) == "none"
    assert networks.remat_policy(True) == "block"      # remat alone means block
    assert networks.remat_policy(True, "conv_out") == "conv_out"
    for remat in (False, True):      # checked before remat is read
        with pytest.raises(ValueError, match="unknown remat_policy"):
            networks.remat_policy(remat, "blocks")
    g = networks.define_G(MaskToImageTrainOptions(remat=True, **ARCH), 12,
                          torch.Generator().manual_seed(0))
    assert {b.remat_policy for b in g.modules() if isinstance(b, networks.ResnetBlock)} == {"block"}


@pytest.mark.parametrize("netG", ["local", "twostream"])
def test_remat_of_other_generators_refused(netG):
    """The JAX package takes remat on the GlobalGenerator only and ignores
    it elsewhere without a word; the port refuses (ROADMAP §C.11)."""
    opt = MaskToImageTrainOptions(netG=netG, remat_policy="conv_out", **ARCH)
    with pytest.raises(ValueError, match="§C.11"):
        check_train_options(opt)
    with pytest.raises(ValueError, match="§C.11"):
        networks.define_G(opt, 12, torch.Generator().manual_seed(0))

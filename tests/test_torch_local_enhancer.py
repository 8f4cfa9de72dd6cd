"""The port's 1024p coarse-to-fine generator against the JAX package's, on
the CPU at a tiny width, from the same JAX-initialized weights carried over
through the npz sidecar: the LocalEnhancer forward (1 and 2 enhancers), the
fp32 train step's losses and G/D gradients, ``--load_pretrain``'s hand-off
of a GlobalGenerator run, ``--niter_fix_global`` over 3 Adam steps (and
across a resume at its threshold), and the weight bridge's transposed-conv
names (``local{n}_up``)."""

import os
import re

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
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
    save_params_npz,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.utils import checkpoint
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import make_train_step
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_pretrain_into,
    params_from_jax,
    params_to_jax,
    restore_params,
    save_params,
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

# the recipe's flags at a tiny width; VGG19 is held elsewhere
# (test_torch_train_step.py) and left out of these steps
ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            n_blocks_local=1, batchSize=2, conv_precision="highest", netG="local",
            no_vgg_loss=True)
TEST_ARCH = {k: v for k, v in ARCH.items() if k not in ("ndf", "no_vgg_loss")}
HW = (32, 64)
# fp32, full-fp32 convolutions on both sides: the same math summed in
# another order (test_torch_train_step.py's tolerances)
ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3     # of each leaf's max |g|
PARAM_ATOL = 1e-6
PARAM_SHARE = 0.999
STEPS_PER_EPOCH = 2  # --niter_fix_global 1: the trunk frozen for steps 0 and 1
N_ADAM = 3


def _flat(tree):
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        out[key] = np.asarray(leaf)
    return out


def _npz_flat(tmp, params, name="p.npz"):
    path = os.path.join(tmp, name)
    save_params_npz(path, params)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _perturb_biases(flat, seed):
    """Non-zero biases, so that every live one shows (conv_out's)."""
    rng = np.random.RandomState(seed)
    return {k: (v + rng.randn(*v.shape) * 0.3).astype(v.dtype) if k.endswith("/bias") else v
            for k, v in flat.items()}


def _jax_init(tmp, n_local, **kw):
    """A JAX LocalEnhancer + 2-scale D model, a seeded batch and its init
    as a flat npz dict (biases perturbed) and as a param tree."""
    opt = JaxTrainOptions(name="s", checkpoints_dir=tmp, n_local_enhancers=n_local,
                          **dict(ARCH, **kw))
    model = jax_create_model(opt)
    batch = synthetic_batch(np.random.RandomState(n_local), 2, hw=HW, label_nc=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = model.init_params(jax.random.PRNGKey(n_local), jb)
    flat = _perturb_biases(_npz_flat(tmp, init), n_local)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(init), [jnp.asarray(flat[k]) for k in _flat(init)])
    return opt, model, batch, jb, flat, params


@pytest.fixture(scope="module", params=[1, 2], ids=["1enh", "2enh"])
def jax_run(request, tmp_path_factory):
    """The JAX side, once per enhancer count: the init, its inference, and
    the losses and gradients at the init."""
    n_local = request.param
    with jnnops.precision_scope():
        _, model, batch, jb, flat, params = _jax_init(
            str(tmp_path_factory.mktemp(f"jax_local{n_local}")), n_local)
        out = dict(n_local=n_local, batch=batch, flat=flat)
        out["fake"] = np.asarray(jax.jit(model.inference)(params, jb))
        loss_fn = jax_steps._make_loss_fn(model, None, None)
        grad_fn = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jb), has_aux=True))
        (_, (metrics, _)), grads = grad_fn(params)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["grads"] = _flat(grads)
        return out


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    """N_ADAM JAX train steps (one enhancer) under --niter_fix_global 1 at
    STEPS_PER_EPOCH: the params after each."""
    with jnnops.precision_scope():
        opt, model, batch, jb, flat, params = _jax_init(
            str(tmp_path_factory.mktemp("jax_chain")), 1, niter_fix_global=1)
        tx_g, tx_d = jax_make_optimizers(opt, STEPS_PER_EPOCH)
        state = GANTrainState.create(params, tx_g, tx_d, jax.random.PRNGKey(1))
        step = jax_steps.make_train_step(model, vgg_params=None, donate=False)
        chain = []
        for _ in range(N_ADAM):
            state, _, _ = step(state, jb)
            chain.append(_flat(state.params))
        return dict(batch=batch, flat=flat, chain=chain)


def port_model(flat, n_local, **kw):
    opts = dict(ARCH, n_local_enhancers=n_local, **kw)
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **opts))
    sds = state_dicts_from_jax(flat)
    assert set(sds) == {"G", "D"}
    model.netG.load_state_dict(sds["G"], strict=True)
    model.netD.load_state_dict(sds["D"], strict=True)
    return model


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_local_enhancer_forward_matches_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"], jax_run["n_local"])
    assert isinstance(model.netG, networks.LocalEnhancer)
    g_in = model.encode_input(tbatch(jax_run["batch"]))
    # the unpadded input: the pyramid pools it before any pad
    assert torch.is_tensor(g_in) and tuple(g_in.shape) == (2, *HW, 8 + 1 + 3)
    with torch.no_grad():
        got = model.netG(g_in).numpy()
    want = jax_run["fake"]
    assert got.shape == want.shape == (2, *HW, 3)
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()


def test_local_step_losses_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"], jax_run["n_local"])
    _, metrics, _ = model.losses(tbatch(jax_run["batch"]))
    assert set(metrics) == set(jax_run["metrics"])
    for k, want in jax_run["metrics"].items():
        got = float(metrics[k])
        if want == 0:   # the VGG term, off here
            assert got == 0, k
            continue
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)


def test_local_step_gradients_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"], jax_run["n_local"])
    total, _, _ = model.losses(tbatch(jax_run["batch"]))
    total.backward()
    got = state_dicts_to_jax({
        net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in mod.named_parameters()}
        for net, mod in (("G", model.netG), ("D", model.netD))})
    want = jax_run["grads"]
    assert set(got) == set(want)
    live = 0
    for k, w in want.items():
        g = got[k]
        scale = np.abs(w).max()
        assert g.shape == w.shape, k
        if scale == 0:
            assert np.abs(g).max() == 0, k    # dead biases: 0 on both sides
            continue
        live += 1
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (k, np.abs(g - w).max(), scale)
    # every kernel takes a gradient: the trunk's 7 convs, 5 a branch, the
    # head's (and its bias); D: per scale 5 kernels + 2 live biases
    n_local = jax_run["n_local"]
    assert live == 7 + 5 * n_local + 2 + 2 * 7
    assert any(k.startswith("G/params/global/") for k in want)


def _trunk(sd):
    return {k: t.clone() for k, t in sd.items() if k.startswith("global.")}


def test_niter_fix_global_matches_jax(jax_chain, restore_torch_precision, tmp_path):
    """3 Adam steps with the trunk frozen for 2: the trunk bit-exact through
    the freeze (its moments accumulating), then the JAX chain after the
    thaw; and a resume at the threshold continues the same bits."""
    jax_run = jax_chain
    flat = jax_run["flat"]
    ckpt_opt = MaskToImageTrainOptions(gpu_ids="-1", name="fix",
                                       checkpoints_dir=str(tmp_path), **ARCH)
    model = port_model(flat, 1, niter_fix_global=1)
    state = make_optimizers(model.opt, model, STEPS_PER_EPOCH)
    assert [len(g["params"]) for g in state.opt_g.param_groups] == [10 + 2, 14]
    step = make_train_step(model)
    batch = tbatch(jax_run["batch"])
    init = _trunk(model.netG.state_dict())
    for i in range(N_ADAM):
        metrics, _ = step(state, batch)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        trunk = _trunk(model.netG.state_dict())
        frozen = all(torch.equal(trunk[k], init[k]) for k in init)
        assert frozen == (i + 1 < N_ADAM), i
        if i == 1:
            # the JAX chain holds its trunk too, and the branch moved
            for k in flat:
                if k.startswith("G/params/global/"):
                    np.testing.assert_array_equal(jax_run["chain"][i][k], flat[k])
            CheckpointManager(ckpt_opt).save("latest", model, state, 2, 0)
    # the trunk's Adam moments accumulated while it was frozen (its dead
    # biases take no gradient, and no state)
    trunk_state = [state.opt_g.state[p] for p in state.opt_g.param_groups[1]["params"]
                   if p.grad is not None]
    assert len(trunk_state) == 7 and all(int(s["step"]) == N_ADAM for s in trunk_state)
    got = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    want = jax_run["chain"][-1]
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diffs <= PARAM_ATOL).mean() >= PARAM_SHARE, (diffs > PARAM_ATOL).mean()
    assert diffs.max() <= 2 * N_ADAM * model.opt.lr, diffs.max()
    trunk_moved = max(np.abs(want[k] - flat[k]).max() for k in want
                      if k.startswith("G/params/global/"))
    assert trunk_moved > 0.5 * model.opt.lr

    # resumed at the threshold: the third step gives the same bits
    resumed = port_model(flat, 1, niter_fix_global=1)
    rstate = make_optimizers(resumed.opt, resumed, STEPS_PER_EPOCH)
    CheckpointManager(ckpt_opt).restore("latest", resumed, rstate)
    assert rstate.step == 2 and rstate.sched_g.last_epoch == 2
    make_train_step(resumed)(rstate, batch)
    for net in ("netG", "netD"):
        for (k, a), b in zip(getattr(resumed, net).state_dict().items(),
                             getattr(model, net).state_dict().values()):
            assert torch.equal(a, b), (net, k)


def test_load_pretrain_matches_jax(restore_torch_precision, tmp_path, capsys):
    """A GlobalGenerator run (2-scale D) into a LocalEnhancer with a 3-scale
    D: the JAX function's counts and tensors, on one npz."""
    tmp = str(tmp_path)
    batch = synthetic_batch(np.random.RandomState(3), 2, hw=HW, label_nc=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jnnops.precision_scope():
        glob = dict(ARCH, netG="global", ngf=16)
        pre = jax_create_model(JaxTrainOptions(name="pre", checkpoints_dir=tmp, **glob))
        pre_params = pre.init_params(jax.random.PRNGKey(5), jb)
        pre_params.pop("VGG", None)
        os.makedirs(os.path.join(tmp, "pre", "ckpt"))
        save_params_npz(os.path.join(tmp, "pre", "ckpt", "latest_params.npz"), pre_params)
        loc = jax_create_model(JaxTrainOptions(name="loc", checkpoints_dir=tmp, num_D=3,
                                               n_local_enhancers=1, **ARCH))
        init = loc.init_params(jax.random.PRNGKey(6), jb)
        init.pop("VGG", None)
        flat = _npz_flat(tmp, init, "loc.npz")
        capsys.readouterr()
        want = _flat(JaxCheckpointManager.load_pretrain_into(
            init, os.path.join(tmp, "pre"), "latest"))
        want_line = capsys.readouterr().out.strip().splitlines()[-1]
    model = port_model(flat, 1, num_D=3)
    counts = load_pretrain_into(model, os.path.join(tmp, "pre"))
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line
    # trunk 14 and conv_out's bias; D scales 0 and 1, 10 each. At init: the
    # branch's 10, conv_out's kernel (8 -> 3 against 16 -> 3), scale 2's 10
    assert counts == (14 + 1 + 20, 10 + 1 + 10)
    assert want_line == "load_pretrain: 35 leaves loaded, 21 kept at init"
    got = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pre_flat = _npz_flat(tmp, pre_params, "pre.npz")
    np.testing.assert_array_equal(got["G/params/global/res0/conv1/kernel"],
                                  pre_flat["G/params/res0/conv1/kernel"])


def _local_flat(tmp, n_local):
    with jnnops.precision_scope():
        opt = JaxTrainOptions(name="b", checkpoints_dir=tmp, n_local_enhancers=n_local, **ARCH)
        jm = jax_create_model(opt)
        batch = synthetic_batch(np.random.RandomState(0), 1, hw=HW, label_nc=8)
        params = jm.init_params(jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
        return _npz_flat(tmp, {"G": params["G"]})


@pytest.mark.parametrize("n_local", [1, 2])
def test_bridge_maps_local_up_as_transposed_conv(restore_torch_precision, tmp_path, n_local):
    """ROADMAP §C.7: ``local{n}_up`` is a transposed conv. Its HWIO kernel
    maps to (Cin, Cout, 3, 3) by transpose(2, 3, 0, 1), the port's
    LocalEnhancer loads the JAX tree strictly, the round trip is bit-exact
    with the same keys, and a saved run restores with no partial load."""
    flat = _local_flat(str(tmp_path), n_local)
    sd = params_from_jax(flat)
    for n in range(1, n_local + 1):
        k = flat[f"G/params/local{n}_up/kernel"]
        np.testing.assert_array_equal(sd[f"local{n}_up.weight"].numpy(),
                                      k.transpose(2, 3, 0, 1))
    model = create_model(MaskToImageTestOptions(gpu_ids="-1", n_local_enhancers=n_local,
                                                name="b", checkpoints_dir=str(tmp_path),
                                                **TEST_ARCH))
    model.netG.load_state_dict(sd, strict=True)
    back = params_to_jax(model.netG.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])
    save_params(model.opt, "latest", model)
    fresh = create_model(model.opt)
    assert restore_params(model.opt, fresh)
    for (k, a), b in zip(fresh.netG.state_dict().items(), model.netG.state_dict().values()):
        assert torch.equal(a, b), k


def test_bridge_repair_c7_before_and_after(jax_run, restore_torch_precision, tmp_path, capsys,
                                           monkeypatch):
    """ROADMAP §C.7, before and after: with the bridge's former pattern
    ``(^|_)up\\d+$`` each ``local{n}_up`` kernel took the conv permutation,
    so its shape differed and the serving restore kept it at init ("partial
    load"), and the forward left the JAX one; with the repaired pattern
    every leaf loads and the forward agrees within ATOL."""
    n = jax_run["n_local"]
    opt = MaskToImageTestOptions(gpu_ids="-1", name="c7", checkpoints_dir=str(tmp_path),
                                 n_local_enhancers=n, **TEST_ARCH)
    os.makedirs(os.path.join(str(tmp_path), "c7", "ckpt"))
    np.savez(os.path.join(str(tmp_path), "c7", "ckpt", "latest_params.npz"), **jax_run["flat"])
    seen = {}
    for label, pattern in (("before", re.compile(r"(^|_)up\d+$")), ("after", checkpoint._UP)):
        monkeypatch.setattr(checkpoint, "_UP", pattern)
        model = create_model(opt)
        capsys.readouterr()
        assert restore_params(opt, model)
        printed = capsys.readouterr().out
        got = model.inference(tbatch(jax_run["batch"])).numpy()
        seen[label] = (printed, float(np.abs(got - jax_run["fake"]).max()))
    assert f"checkpoint partial load: {n} leaves kept at init" in seen["before"][0]
    assert "partial load" not in seen["after"][0]
    assert seen["before"][1] > 100 * ATOL and seen["after"][1] <= ATOL
    with capsys.disabled():
        print(f"\nC.7, {n} enhancer(s): max |port - JAX| of the forward, before "
              f"{seen['before'][1]:.6g}, after {seen['after'][1]:.6g}")

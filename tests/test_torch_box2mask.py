"""The port's box2mask stage against the JAX package's, on the CPU, from the
same weights (a JAX init carried over through the npz sidecar): the
structure generator's outputs, every loss term, every G and D gradient
leaf, the parameters after 3 Adam steps, one bf16-tier step, and the bbox
crop dataset with background boxes. Also the three faults of shared port
modules that box2mask's path exposed: ``Conv``'s split form tiling one
side only, the weight bridge's transposed-conv and dense kernels, and
``_reset_convs`` leaving a ``Linear`` at zero."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs import options as jopts
from neurips18_hierchical_image_manipulation_tpu.data import loader as jloader
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import (
    synthetic_box2mask_batch as jax_synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.train.state import (
    GANTrainState,
    make_optimizers as jax_make_optimizers,
)
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.data import loader as ploader
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    params_from_jax,
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            n_layers_D=2, fineSize=32, batchSize=2)
STEPS_PER_EPOCH = 10
N_ADAM = 3
LAM_NEG = 5.0
# fp32, full-fp32 convolutions on both sides: the same math summed in
# another order through G (13 conv layers) and 2 D applies.
OUT_ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3                        # of each leaf's max |g|
# the parameters after N_ADAM steps: tests/test_torch_train_step.py's
# PARAM_ATOL, and a share of 0.998 where it holds 0.999. Measured 0.99880
# (69 of 57 498 elements, all in enc_in, enc_down0, enc_down1, at most
# 1.08e-5): the JAX package's CPU IN mean is summed less accurately (its
# first IN's output is 3.9e-5 off an fp64 evaluation, the port's 2.0e-6),
# and at the third step one pre-ReLU value at enc_norm_down1 lies within
# that spread and takes the other side of the ReLU. The gradients at the
# first two steps agree within 4e-5 of each leaf's max.
PARAM_ATOL, PARAM_SHARE = 1e-6, 0.998
BF16_GAP_FACTOR = 3.0                  # as tests/test_torch_bf16_pool_step.py


def _flat(tree):
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _jax_tree(flat, template):
    def leaf(keypath, t):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        return jnp.asarray(flat[key], t.dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


def jax_opt(**kw):
    return jopts.BoxToMaskTrainOptions(name="b", **{**ARCH, "conv_precision": "highest", **kw})


def port_opt(**kw):
    return popts.BoxToMaskTrainOptions(gpu_ids="-1", **{**ARCH, "conv_precision": "highest", **kw})


def tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def make_batch(seed=0):
    return synthetic_box2mask_batch(np.random.RandomState(seed), 2, size=32, label_nc=8)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX side, once per module, from its init with every bias made
    live: G's outputs, the losses at λ_ctx_neg 0 and 5, the gradients at 5,
    the params after N_ADAM steps, and the bf16-tier losses."""
    tmp = str(tmp_path_factory.mktemp("b2m"))
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = dict(batch=batch)
    with jnnops.precision_scope():
        model = jax_create_model(jax_opt(checkpoints_dir=tmp, lambda_ctx_neg=LAM_NEG))
        init = model.init_params(jax.random.PRNGKey(0), jb)
        path = os.path.join(tmp, "p.npz")
        save_params_npz(path, init)
        with np.load(path) as f:
            out["init_flat"] = {k: f[k] for k in f.files}
        rng = np.random.RandomState(1)
        flat = {k: (v + 0.3 * rng.randn(*v.shape)).astype(v.dtype)
                if k.endswith("/bias") else v for k, v in out["init_flat"].items()}
        params = _jax_tree(flat, init)
        out["flat"] = flat
        g_in = model.encode_input(jb)
        out["g_out"] = [np.asarray(t) for t in jax.jit(model.netG.apply)(params["G"], *g_in)]
        out["infer"] = [np.asarray(t) for t in jax.jit(
            lambda p, b: model.inference(p, b, return_ctx=True))(params, jb)]
        loss_fn = jax_steps._make_loss_fn(model, None, None)
        (_, (metrics, merged)), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, jb), has_aux=True))(params)
        out["metrics"] = {LAM_NEG: {k: float(v) for k, v in metrics.items()}}
        out["merged"], out["grads"] = np.asarray(merged), _flat(grads)
        model0 = jax_create_model(jax_opt(checkpoints_dir=tmp))
        _, (m0, _) = jax.jit(jax_steps._make_loss_fn(model0, None, None))(params, jb)
        out["metrics"][0.0] = {k: float(v) for k, v in m0.items()}
        tx_g, tx_d = jax_make_optimizers(model.opt, STEPS_PER_EPOCH)
        state = GANTrainState.create(params, tx_g, tx_d, jax.random.PRNGKey(1))
        step = jax_steps.make_train_step(model, donate=False)
        for _ in range(N_ADAM):
            state, _, _ = step(state, jb)
        out["params"] = _flat(state.params)
    with jnnops.precision_scope():
        mbf = jax_create_model(jax_opt(checkpoints_dir=tmp, lambda_ctx_neg=LAM_NEG,
                                       dtype="bfloat16", conv_precision="auto"))
        _, (mb, _) = jax.jit(jax_steps._make_loss_fn(mbf, None, jnp.bfloat16))(params, jb)
        out["metrics_bf16"] = {k: float(v) for k, v in mb.items()}
    return out


def port_model(flat, **kw):
    model = create_model(port_opt(**kw))
    sds = state_dicts_from_jax(flat)
    assert set(sds) == {"G", "D"}
    model.netG.load_state_dict(sds["G"], strict=True)
    model.netD.load_state_dict(sds["D"], strict=True)
    return model


def port_grads(model):
    return state_dicts_to_jax({
        net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in mod.named_parameters()}
        for net, mod in (("G", model.netG), ("D", model.netD))})


# ---------------------------------------------------------------- the repairs

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("stacked", ["x", "x2"])
def test_conv_split_form_tiles_the_smaller_side(b, stacked):
    """``Conv(x, x2)`` is the conv over x ⊕ x2 when either side stacks k
    times the other's batch (the layout discriminator stacks x)."""
    gen = torch.Generator().manual_seed(b)
    conv = networks.Conv(5 + 3, 6, 4, stride=2, padding=2)
    conv.weight.data.normal_(0, 0.3, generator=gen)
    conv.bias.data.normal_(0, 0.3, generator=gen)
    nx, nx2 = (2 * b, b) if stacked == "x" else (b, 2 * b)
    x = torch.randn((nx, 9, 10, 5), generator=gen)
    x2 = torch.randn((nx2, 9, 10, 3), generator=gen)
    got = conv(x, x2)
    n = max(nx, nx2)
    want = conv(torch.cat([x.repeat(n // nx, 1, 1, 1), x2.repeat(n // nx2, 1, 1, 1)], -1))
    assert got.shape == want.shape == (n, 5, 6, 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_conv_split_form_refuses_unrelated_batches():
    conv = networks.Conv(4, 2, 1)
    with pytest.raises(ValueError, match="neither divides"):
        conv(torch.zeros(2, 3, 3, 2), torch.zeros(3, 3, 3, 2))


def test_bridge_maps_decoder_ups_and_dense_kernels():
    """``{tag}_up{i}`` kernels are transposed convs and a 2-D kernel is a
    ``Linear`` weight (out, in), both ways."""
    rng = np.random.RandomState(0)
    flat = {"G/params/ctx_up0/kernel": rng.randn(3, 3, 16, 8).astype(np.float32),
            "G/params/cls_embed/kernel": rng.randn(8, 16).astype(np.float32),
            "G/params/enc_down0/kernel": rng.randn(3, 3, 8, 16).astype(np.float32)}
    sd = params_from_jax(flat)
    assert tuple(sd["ctx_up0.weight"].shape) == (16, 8, 3, 3)
    assert tuple(sd["cls_embed.weight"].shape) == (16, 8)
    assert tuple(sd["enc_down0.weight"].shape) == (16, 8, 3, 3)
    np.testing.assert_array_equal(sd["cls_embed.weight"].numpy(),
                                  flat["G/params/cls_embed/kernel"].T)
    back = state_dicts_to_jax({"G": sd})
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_bridge_round_trip_is_bit_exact(jax_run):
    """A JAX ``BoxToMaskModel.init_params`` tree through the npz sidecar into
    the port's G and D (strict) and back: the same keys, the same bits."""
    flat = jax_run["init_flat"]
    model = port_model(flat)
    back = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    assert set(back) == set(flat)
    assert any(k.startswith("D/params/d/layer0/") for k in back)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reset_draws_linear_weights():
    """``_reset_convs`` draws a Linear's weight from N(0, 0.02) like a
    conv's (the JAX ``conv_init`` of the Dense ``cls_embed``)."""
    m = torch.nn.Sequential(networks.Conv(4, 8, 3), torch.nn.Linear(64, 256))
    torch.nn.init.zeros_(m[1].weight)
    networks._reset_convs(m, torch.Generator().manual_seed(0))
    w = m[1].weight
    assert w.abs().max() > 0 and abs(w.std().item() - 0.02) <= 0.002
    assert torch.equal(m[1].bias, torch.zeros_like(m[1].bias))


def test_box2mask_init_has_no_zero_weights():
    model = create_model(popts.BoxToMaskTrainOptions(gpu_ids="-1"))   # full width
    for net in (model.netG, model.netD):
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                assert p.abs().max() > 0, name
    w = model.netG.cls_embed.weight
    assert tuple(w.shape) == (512, 35)
    assert abs(w.std().item() - 0.02) <= 0.1 * 0.02
    n = sum(p.numel() for p in model.netG.parameters())
    assert 23.9e6 < n < 24.2e6


# ---------------------------------------------------------------- the slice

def test_synthetic_batch_matches_jax():
    for seed in (0, 3):
        a = synthetic_box2mask_batch(np.random.RandomState(seed), 3, size=32, label_nc=8)
        b = jax_synthetic_box2mask_batch(np.random.RandomState(seed), 3, size=32, label_nc=8)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_generator_matches_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"])
    batch = tbatch(jax_run["batch"])
    with torch.no_grad():
        got = model.netG(*model.encode_input(batch))
    for g, w, name in zip(got, jax_run["g_out"], ("layout_logits", "mask_logit", "merged")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=OUT_ATOL, rtol=0, err_msg=name)
    got = model.inference(batch, return_ctx=True)
    assert len(got) == 3
    for g, w in zip(got, jax_run["infer"]):
        np.testing.assert_allclose(g.numpy(), w, atol=OUT_ATOL, rtol=0)


def test_null_class_gives_zero_shift(jax_run, restore_torch_precision):
    """cls = -1 (a background box) one-hots to zeros: no class map, a zero
    class shift; G's outputs equal the JAX generator's on the same input."""
    batch = dict(jax_run["batch"], cls=np.array([-1, jax_run["batch"]["cls"][1]], np.int32))
    model = port_model(jax_run["flat"])
    masked_oh, boxmask, cls_oh = model.encode_input(tbatch(batch))
    assert torch.equal(cls_oh[0], torch.zeros(8)) and cls_oh[1].sum() == 1
    with torch.no_grad():
        assert torch.equal(model.netG.cls_embed(cls_oh)[0], torch.zeros(32))
        got = model.netG(masked_oh, boxmask, cls_oh)
    with jnnops.precision_scope():
        jm = jax_create_model(jax_opt())
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = _jax_tree(jax_run["flat"], jax.eval_shape(
            lambda: jm.init_params(jax.random.PRNGKey(0), jb)))
        want = jax.jit(jm.netG.apply)(params["G"], *jm.encode_input(jb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL, rtol=0)


def test_fine_size_off_the_bottleneck_raises_on_both_sides():
    """The box mask's reshape-max: fineSize 30 does not pool onto 2 downs."""
    batch = synthetic_box2mask_batch(np.random.RandomState(0), 1, size=30, label_nc=8)
    model = create_model(port_opt(fineSize=30))
    with pytest.raises(ValueError, match="divisible"):
        model.losses(tbatch(batch))
    with jnnops.precision_scope():
        jm = jax_create_model(jax_opt(fineSize=30))
        with pytest.raises(TypeError):
            jm.init_params(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("lam", [0.0, LAM_NEG])
def test_losses_match_jax(jax_run, restore_torch_precision, lam):
    model = port_model(jax_run["flat"], lambda_ctx_neg=lam)
    total, metrics, merged = model.losses(tbatch(jax_run["batch"]))
    want = jax_run["metrics"][lam]
    assert set(metrics) == set(want)
    assert ("G_ctxneg" in metrics) == bool(lam)
    for k, w in want.items():
        got = float(metrics[k])
        assert w > 0 and abs(got - w) <= LOSS_RTOL * abs(w), (k, got, w)
    d_loss = 0.5 * (float(metrics["D_real"]) + float(metrics["D_fake"]))
    g_terms = sum(float(v) for k, v in metrics.items() if k.startswith("G_"))
    assert abs(total.item() - g_terms - d_loss) <= 1e-5 * total.item()
    if lam:
        np.testing.assert_allclose(merged.detach().numpy(), jax_run["merged"], atol=OUT_ATOL)


def test_gradients_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"], lambda_ctx_neg=LAM_NEG)
    total, _, _ = model.losses(tbatch(jax_run["batch"]))
    total.backward()
    got, want = port_grads(model), jax_run["grads"]
    assert set(got) == set(want)
    live = 0
    for k, w in want.items():
        g = got[k].astype(np.float32)
        scale = np.abs(w).max()
        assert g.shape == w.shape, k
        if scale == 0:
            assert np.abs(g).max() == 0, k   # dead biases: 0 on both sides
            continue
        live += 1
        assert np.abs(g - w).max() <= GRAD_TOL * scale, (k, np.abs(g - w).max(), scale)
    # G: 13 kernels (cls_embed among them) + the two heads' biases;
    # D: 4 kernels + layer0's and the last layer's biases
    assert live == 15 + 6


def test_adam_steps_match_jax(jax_run, restore_torch_precision):
    model = port_model(jax_run["flat"], lambda_ctx_neg=LAM_NEG)
    state = make_optimizers(model.opt, model, STEPS_PER_EPOCH)
    step = steps.make_train_step(model)
    batch = tbatch(jax_run["batch"])
    for _ in range(N_ADAM):
        metrics, merged = step(state, batch)
    assert state.step == N_ADAM and all(np.isfinite(float(v)) for v in metrics.values())
    assert tuple(merged.shape) == (2, 32, 32, 8)
    got = state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})
    want = jax_run["params"]
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    moved = np.concatenate([np.abs(want[k] - jax_run["flat"][k]).ravel() for k in want])
    assert moved.max() > 0.5 * N_ADAM * model.opt.lr
    assert (diffs <= PARAM_ATOL).mean() >= PARAM_SHARE, (diffs > PARAM_ATOL).mean()
    assert diffs.max() <= 2 * N_ADAM * model.opt.lr, diffs.max()


def test_bf16_step_losses_match_jax_bf16(jax_run, restore_torch_precision):
    """Each loss term of the bf16 tier within BF16_GAP_FACTOR times the JAX
    package's own bf16-vs-fp32 gap (tests/test_torch_bf16_pool_step.py)."""
    model = port_model(jax_run["flat"], lambda_ctx_neg=LAM_NEG, dtype="bfloat16",
                       conv_precision="auto")
    params, b = steps._loss_inputs(model, tbatch(jax_run["batch"]), torch.bfloat16)
    assert set(params) == {"G", "D"} and b["boxmask"].dtype == torch.bfloat16
    total, metrics, merged = model.losses(b, params)
    assert merged.dtype == torch.bfloat16
    total.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.netG.parameters() if p.grad is not None)
    want, ref = jax_run["metrics_bf16"], jax_run["metrics"][LAM_NEG]
    assert set(metrics) == set(want)
    bad = [(k, float(metrics[k]), w, ref[k]) for k, w in want.items()
           if abs(float(metrics[k]) - w) > BF16_GAP_FACTOR * abs(w - ref[k])]
    assert not bad, bad   # (term, port bf16, JAX bf16, JAX fp32)


# ---------------------------------------------------------------- the data

def write_dataroot(root, h=64, w=128):
    """Scenes with thing objects (26000 + k) on stuff (inst = class id), and
    one crowded scene, a thing over all of it, where no background box fits
    and the sample falls back to its object."""
    rng = np.random.RandomState(0)
    for sub in ("train_label", "train_inst", "train_img"):
        (root / sub).mkdir(parents=True)
    for i in range(3):
        label = np.full((h, w), 7, np.uint8)
        inst = label.astype(np.int32)
        if i == 2:
            label[:], inst[:] = 26, 26000
        for k in range(2):
            y0, x0 = rng.randint(0, h - 24), rng.randint(0, w - 40)
            label[y0 : y0 + 24, x0 : x0 + 40] = 26
            inst[y0 : y0 + 24, x0 : x0 + 40] = 26001 + k
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(label).save(root / "train_label" / f"{i}.png")
        Image.fromarray(inst, mode="I").save(root / "train_inst" / f"{i}.png")
        Image.fromarray(img).save(root / "train_img" / f"{i}.png")


def test_bbox_dataset_background_boxes_match_jax(tmp_path):
    """--bg_box_prob 0.5 over two epochs: every batch bit-exact with the JAX
    dataset's (each side reads its own copy of the dataroot), background
    boxes (cls -1, empty object mask) among them, and the fallback."""
    write_dataroot(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    batches = []
    for side, opts, loader in (("jax", jopts, jloader), ("port", popts, ploader)):
        opt = opts.BoxToMaskTrainOptions(
            dataroot=str(tmp_path / side), fineSize=32, min_box_size=4, bg_box_prob=0.5,
            batchSize=2, nThreads=1, name="d", checkpoints_dir=str(tmp_path / "ck"))
        ld = loader.CreateDataLoader(opt)
        batches.append([b for _ in range(2) for b in ld])
    assert len(batches[0]) == len(batches[1]) >= 4
    cls = np.concatenate([b["cls"] for b in batches[1]])
    assert (cls == -1).any() and (cls >= 0).any()
    for a, b in zip(*batches):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], list):
                assert [os.path.basename(p) for p in a[k]] == [os.path.basename(p) for p in b[k]]
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        bg = b["cls"] == -1
        assert not b["gt_objmask"][bg].any()

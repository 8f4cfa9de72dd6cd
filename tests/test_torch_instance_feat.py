"""The port's instance-feature path against the JAX package's, on the CPU
at a tiny width: the Encoder (more than 64 instances of one class, where
the id remap collides; ``--label_feat``), ``segment_mean_2d`` in fp32 and
bf16 and its gradient, the ``--instance_feat`` train step (losses and G, D
and E gradients, from the same JAX-initialized weights), and the feature
clustering module against the JAX module's numpy."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTestOptions as JaxTestOptions,
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.eval import features as jfeatures
from neurips18_hierchical_image_manipulation_tpu.models import networks as jnetworks
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.eval import features
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    params_from_jax,
    params_to_jax,
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

ENC = dict(feat_num=3, nef=4, n_downsample_E=2)
ARCH = dict(label_nc=8, ngf=8, n_downsample_global=2, n_blocks_global=1,
            conv_precision="highest", **ENC)
HW = (32, 64)
ATOL = 1e-4          # fp32, full-fp32 convolutions, another summation order
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3      # of each leaf's max |g|


@pytest.fixture
def jax_tier():
    with jnnops.precision_scope():
        yield


def _npz_flat(tmp, params):
    path = os.path.join(tmp, "p.npz")
    save_params_npz(path, params)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def crowded_inst(b, seed):
    """(b, 32, 64) instance ids: 70 things of class 5 (ids 5000..5069, so
    k and k + 64 share a segment), 3 of class 6, stuff ids below 1000."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((b,) + HW, np.int32)
    label = np.zeros((b,) + HW, np.int32)
    for i in range(b):
        cells = rng.permutation(8 * 16)
        stuff = rng.randint(0, 4, size=(8, 16))
        for c in range(8 * 16):
            y, x = divmod(int(cells[c]), 16)
            if c < 70:
                ids, cls = 5000 + c, 5
            elif c < 73:
                ids, cls = 6000 + c - 70, 6
            else:
                ids = cls = int(stuff[y, x])
            inst[i, 4 * y:4 * y + 4, 4 * x:4 * x + 4] = ids
            label[i, 4 * y:4 * y + 4, 4 * x:4 * x + 4] = cls
    return label, inst


def _jax_encoder(seed):
    enc = jnetworks.Encoder(feat_num=3, nef=4, n_downsampling=2, label_nc=8)
    img = np.random.RandomState(seed).uniform(-1, 1, (2,) + HW + (3,)).astype(np.float32)
    label, inst = crowded_inst(2, seed)
    params = enc.init(jax.random.PRNGKey(seed), jnp.asarray(img), jnp.asarray(inst))
    return enc, params, img, label, inst


def _port_encoder(tmp, params):
    flat = _npz_flat(tmp, {"E": params})
    e = networks.Encoder(3, feat_num=3, nef=4, n_downsampling=2, label_nc=8)
    e.load_state_dict(params_from_jax(flat, "E/params/"), strict=True)
    back = params_to_jax(e.state_dict(), "E/params/")
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    return e


@pytest.mark.parametrize("seg_of", ["inst", "label"])
def test_encoder_matches_jax(jax_tier, restore_torch_precision, tmp_path, seg_of):
    """--instance_feat pools over inst (70 things of one class: segments
    shared by k and k + 64, as the JAX id remap has it), --label_feat over
    label."""
    enc, params, img, label, inst = _jax_encoder(0)
    seg = inst if seg_of == "inst" else label
    with jnnops.precision_scope("highest"):
        want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(img), jnp.asarray(seg)))
    e = _port_encoder(str(tmp_path), params)
    with torch.no_grad():
        got = e(torch.from_numpy(img), torch.from_numpy(seg)).numpy()
    assert got.shape == want.shape == (2,) + HW + (3,)
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()
    if seg_of == "inst":
        # instance 5000 and 5064 share one mean: their pixels are equal
        for b in range(2):
            a, c = got[b][inst[b] == 5000], got[b][inst[b] == 5064]
            np.testing.assert_array_equal(a[0], c[0])
            assert not np.array_equal(got[b][inst[b] == 5001][0], a[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_mean_2d_matches_jax(dtype):
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 16, 24, 5).astype(np.float32)
    seg = rng.randint(0, 7, size=(2, 16, 24)).astype(np.int32)
    seg[1, :12] = 3        # one large segment: a bf16 running sum would stall
    w = rng.randn(2, 16, 24, 5).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    # the port sums each segment's gradient in fp32 and rounds it once (the
    # JAX function sums it in feat's dtype, ROADMAP C.13): its gradient is
    # the JAX function's in fp32 at the same rounded input and cotangent
    # (the output's cast back rounds w to dtype), rounded to dtype
    wq = jnp.asarray(w).astype(jdt).astype(jnp.float32)

    def jfn(f):
        return jnp.sum(jnnops.segment_mean_2d(f, jnp.asarray(seg), 9) * wq)

    jf = jnp.asarray(feat).astype(jdt)
    want = np.asarray(jnnops.segment_mean_2d(jf, jnp.asarray(seg), 9).astype(jnp.float32))
    want_g = np.asarray(jax.grad(jfn)(jf.astype(jnp.float32)).astype(jdt).astype(jnp.float32))
    tf = torch.from_numpy(feat).to(tdt).requires_grad_(True)
    out = nnops.segment_mean_2d(tf, torch.from_numpy(seg), 9)
    assert out.dtype == tdt
    (out.to(torch.float32) * torch.from_numpy(w)).sum().backward()
    got, got_g = out.detach().to(torch.float32).numpy(), tf.grad.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-6)
    else:   # the same fp32 mean and gradient, one bf16 rounding: one ulp apart at most
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0)
        np.testing.assert_allclose(got_g, want_g, rtol=2.0**-7, atol=1e-6)
    # every pixel of a segment holds one value
    for s in np.unique(seg[1]):
        vals = got[1][seg[1] == s]
        assert (vals == vals[0]).all()


@pytest.fixture(scope="module")
def jax_feat_step(tmp_path_factory):
    """The JAX --instance_feat model (GlobalGenerator, 2-scale D, Encoder):
    init, losses and gradients at the init."""
    tmp = str(tmp_path_factory.mktemp("jax_feat"))
    with jnnops.precision_scope():
        opt = JaxTrainOptions(name="f", checkpoints_dir=tmp, ndf=8, batchSize=2,
                              instance_feat=True, no_vgg_loss=True, **ARCH)
        model = jax_create_model(opt)
        batch = synthetic_batch(np.random.RandomState(2), 2, hw=HW, label_nc=8)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = model.init_params(jax.random.PRNGKey(2), jb)
        flat = _npz_flat(tmp, params)
        loss_fn = jax_steps._make_loss_fn(model, None, None)
        grad_fn = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jb), has_aux=True))
        (_, (metrics, fake)), grads = grad_fn(params)
        gflat = {}
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            gflat["/".join(str(getattr(k, "key", k)) for k in keypath)] = np.asarray(leaf)
        return dict(batch=batch, flat=flat, metrics={k: float(v) for k, v in metrics.items()},
                    grads=gflat, fake=np.asarray(fake))


def _port_feat_model(flat):
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", ndf=8, batchSize=2,
                                                 instance_feat=True, no_vgg_loss=True, **ARCH))
    sds = state_dicts_from_jax(flat)
    assert set(sds) == {"G", "D", "E"}
    for net, mod in (("G", model.netG), ("D", model.netD), ("E", model.netE)):
        mod.load_state_dict(sds[net], strict=True)
    return model


def test_instance_feat_step_matches_jax(jax_feat_step, restore_torch_precision):
    """Losses, fake and every G, D and E gradient leaf; the generator input
    is one-hot ⊕ edge ⊕ masked RGB ⊕ the Encoder's features."""
    model = _port_feat_model(jax_feat_step["flat"])
    assert model.generator_input_nc() == 8 + 1 + 3 + 3
    tb = {k: torch.from_numpy(v) for k, v in jax_feat_step["batch"].items()}
    g_in = model.encode_input(tb)
    assert torch.is_tensor(g_in) and g_in.shape[-1] == 15
    total, metrics, fake = model.losses(tb)
    assert np.abs(fake.detach().numpy() - jax_feat_step["fake"]).max() <= ATOL
    for k, want in jax_feat_step["metrics"].items():
        got = float(metrics[k])
        if want == 0:
            assert got == 0, k
            continue
        assert abs(got - want) <= LOSS_RTOL * abs(want), (k, got, want)
    total.backward()
    got = state_dicts_to_jax({
        net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in mod.named_parameters()}
        for net, mod in (("G", model.netG), ("D", model.netD), ("E", model.netE))})
    want = jax_feat_step["grads"]
    assert set(got) == set(want)
    live = {}
    for k, w in want.items():
        scale = np.abs(w).max()
        if scale == 0:
            assert np.abs(got[k]).max() == 0, k
            continue
        live[k[0]] = live.get(k[0], 0) + 1
        assert np.abs(got[k] - w).max() <= GRAD_TOL * scale, (k, np.abs(got[k] - w).max(), scale)
    # E: its 6 kernels and conv_out's bias take a gradient through G
    assert live == {"G": 9, "D": 14, "E": 7}


def test_feature_override_and_padded_stem(restore_torch_precision):
    """batch["feat"] replaces the Encoder's features; features join after
    the encode kernel, so the GlobalGenerator takes the unpadded input."""
    model = create_model(MaskToImageTestOptions(gpu_ids="-1", instance_feat=True, **ARCH))
    batch = synthetic_batch(np.random.RandomState(4), 1, hw=HW, label_nc=8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        g_enc = model.encode_input(tb)
        tb["feat"] = torch.full((1,) + HW + (3,), 0.3)
        g_feat = model.encode_input(tb)
    assert torch.is_tensor(g_enc) and tuple(g_enc.shape) == (1,) + HW + (15,)
    assert torch.equal(g_feat[..., :12], g_enc[..., :12])
    assert torch.equal(g_feat[..., 12:], tb["feat"])
    assert not torch.equal(g_enc[..., 12:], g_feat[..., 12:])


def test_kmeans_and_clusters_bit_exact():
    rng = np.random.RandomState(3)
    feats = {c: [rng.randn(3).astype(np.float32) for _ in range(n)]
             for c, n in ((0, 1), (2, 7), (5, 40), (9, 3), (40, 2))}
    for k in (1, 4, 10):
        x = np.stack(feats[5])
        np.testing.assert_array_equal(features.kmeans(x, k, seed=k), jfeatures.kmeans(x, k, seed=k))
    np.testing.assert_array_equal(features.kmeans(np.zeros((0, 3), np.float32), 4),
                                  jfeatures.kmeans(np.zeros((0, 3), np.float32), 4))
    got = features.cluster_features(feats, 35, 10, 3, seed=1)
    want = jfeatures.cluster_features(feats, 35, 10, 3, seed=1)
    assert got.shape == (35, 10, 3)
    np.testing.assert_array_equal(got, want)
    _, inst = crowded_inst(2, 5)
    inst[0, :4, :4] = 40000  # a class outside label_nc: left at zero
    for kw in (dict(cluster_idx=3), dict(rng=np.random.RandomState(7))):
        kw2 = {k: (np.random.RandomState(7) if k == "rng" else v) for k, v in kw.items()}
        np.testing.assert_array_equal(features.sample_cluster_features(got, inst, **kw),
                                      jfeatures.sample_cluster_features(want, inst, **kw2))


def test_encode_dataset_features_matches_jax(jax_tier, restore_torch_precision, tmp_path):
    """The same instances in the same order, each vector within ATOL (the
    Encoder's convolutions summed in another order); uint8 images are
    normalized alike."""
    rng = np.random.RandomState(6)
    batches = []
    for i in range(2):
        label, inst = crowded_inst(2, 10 + i)
        img = rng.randint(0, 256, (2,) + HW + (3,), dtype=np.uint8)
        batches.append({"label": label, "inst": inst, "image": img,
                        "boxes": np.zeros((2, 4), np.float32)})
    jopt = JaxTestOptions(instance_feat=True, **ARCH)
    jmodel = jax_create_model(jopt)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jb["image"] = jb["image"].astype(jnp.float32) / 127.5 - 1.0
    params = jmodel.init_params(jax.random.PRNGKey(0), jb)
    with jnnops.precision_scope("highest"):
        want = jfeatures.encode_dataset_features(jmodel, params, batches)
    model = create_model(MaskToImageTestOptions(gpu_ids="-1", instance_feat=True, **ARCH))
    flat = _npz_flat(str(tmp_path), {"E": params["E"]})
    model.netE.load_state_dict(params_from_jax(flat, "E/params/"), strict=True)
    got = features.encode_dataset_features(model, batches)
    assert list(got) == list(want)
    for c in want:
        assert len(got[c]) == len(want[c]), c
        np.testing.assert_allclose(np.stack(got[c]), np.stack(want[c]), rtol=0, atol=ATOL)
    assert len(want[5]) == 2 * 2 * 70

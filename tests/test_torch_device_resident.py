"""The port's device-resident data path against the JAX package's, on the
CPU: ``crop_resize(..., "pil_bicubic")``, ``sample_batch_impl`` fed the
draws ``jax.random`` gives the JAX function, ``bbox_batch_impl``, the
resident loaders against the port's host loaders, the memory guard, the
loader factory, and the fused resident step (its resume, its display
variant, and one step against JAX ``make_resident_train_step``)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data import device_resident as jdr
from neurips18_hierchical_image_manipulation_tpu.data.bbox import BboxCropDataset as JaxBboxDS
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import boxcomposite as jbc
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.train.state import GANTrainState
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTrainOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data import device_resident as pdr
from neurips18_hierchical_image_manipulation_tpu_torch.data.bbox import BboxCropDataset
from neurips18_hierchical_image_manipulation_tpu_torch.data.cityscapes import AlignedDataset
from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import (
    CreateDataLoader,
    DataLoader,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.ops import boxcomposite as pbc
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import (
    make_resident_train_step,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
    state_dicts_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

# the fused step against the JAX one: the bars of test_torch_train_step.py
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3    # of each leaf's max |g|
# pil_bicubic against the JAX function, on the 0-255 scale: fp32 products
# summed in another order (both ~3e-5 from an fp64 reference)
PIL_ATOL = 1e-3
TINY = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1, num_D=1,
            n_layers_D=2, no_vgg_loss=True)


@pytest.fixture
def dataroot(tmp_path):
    """4 scenes of 64x128: two stripes and one object each (3 records a
    scene), label ids < 8."""
    root = tmp_path / "city"
    for sub in ("train_label", "train_inst", "train_img"):
        (root / sub).mkdir(parents=True)
    for i in range(4):
        label = np.full((64, 128), 3, np.uint8)
        label[:32] = 5
        inst = label.astype(np.int32) * 1000   # the stripes are records too
        y0, x0 = 18, 28 + 10 * i
        label[y0:y0 + 26, x0:x0 + 34] = 6
        inst[y0:y0 + 26, x0:x0 + 34] = 6000 + i
        # smooth RGB (PIL's bicubic rounds its first pass to uint8, which
        # noise would amplify), shifted per scene
        yy, xx = np.mgrid[0:64, 0:128]
        img = np.stack([(yy * 2 + i) % 256, (xx * 2) % 256, (yy + xx + 7 * i) % 256], -1)
        img = img.astype(np.uint8)
        Image.fromarray(label).save(root / "train_label" / f"{i:03d}.png")
        Image.fromarray(inst, mode="I").save(root / "train_inst" / f"{i:03d}.png")
        Image.fromarray(img).save(root / "train_img" / f"{i:03d}.png")
    return str(root)


def opt_kw(dataroot, tmp_path, **kw):
    base = dict(name="dr", checkpoints_dir=os.path.join(str(tmp_path), "ckpt"),
                dataroot=dataroot, loadSize=128, fineSize=64, resize_or_crop="none",
                no_flip=True, batchSize=2, serial_batches=True, use_bbox_dataset=False,
                gpu_ids="-1")
    base.update(kw)
    return base


def port_opt(dataroot, tmp_path, **kw):
    return MaskToImageTrainOptions(**opt_kw(dataroot, tmp_path, **kw))


def jax_opt(dataroot, tmp_path, **kw):
    kw = opt_kw(dataroot, tmp_path, **kw)
    kw.pop("gpu_ids")
    return JaxTrainOptions(**kw)


# ---------------------------------------------------------------- pil_bicubic

PIL_CASES = [   # (window, out): down 4-8x, up 2x, full frame, bottom-right edge
    ((8, 16, 64, 128), (16, 16)), ((10, 20, 24, 40), (48, 48)),
    ((0, 0, 96, 160), (32, 32)), ((60, 120, 36, 40), (20, 20)),
    ((3.5, 7.25, 40.5, 33.0), (24, 24)),
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", range(len(PIL_CASES)))
def test_pil_bicubic_matches_jax(case, dtype):
    box, out = PIL_CASES[case]
    img = np.random.RandomState(11).randint(0, 255, (96, 160, 3)).astype(dtype)
    want = np.asarray(jbc._crop_resize_pil_one(jnp.asarray(img), jnp.asarray(box, jnp.float32),
                                               out))
    got = pbc.crop_resize(torch.from_numpy(img[None]), torch.tensor([box], dtype=torch.float32),
                          out, method="pil_bicubic")[0].numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PIL_ATOL)
    if dtype == "uint8":
        assert got.min() >= 0 and got.max() <= 255


def test_pil_bicubic_batched_and_degenerate():
    """A batch of windows (each its own resample), and windows of size 0 or
    outside the image: zeros, finite."""
    img = (np.random.RandomState(0).rand(4, 24, 32, 3) * 255).astype(np.uint8)
    boxes = np.asarray([[4, 4, 0, 0], [100, 200, 8, 8], [2, 3, 17, 11], [0, 0, 24, 32]],
                       np.float32)
    got = pbc.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), (8, 8),
                          method="pil_bicubic").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:2], 0.0)
    for k in (2, 3):
        want = np.asarray(jbc._crop_resize_pil_one(jnp.asarray(img[k]), jnp.asarray(boxes[k]),
                                                   (8, 8)))
        np.testing.assert_allclose(got[k], want, rtol=0, atol=PIL_ATOL)


# ---------------------------------------------------------------- sample_batch_impl

def stores(n=5, h=40, w=56, seed=0):
    rng = np.random.RandomState(seed)
    return {"label": rng.randint(0, 35, (n, h, w)).astype(np.uint8),
            "inst": rng.randint(0, 65536, (n, h, w)).astype(np.uint16),   # past int16
            "image": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)}


def jax_draws(key, b, hw, fine, do_crop, do_flip):
    """The draws JAX sample_batch_impl makes from ``key`` (``:149-166``)."""
    kc, kx, kf = jax.random.split(key, 3)
    ys = xs = np.zeros(b, np.int64)
    if do_crop:
        ys = np.asarray(jax.random.randint(kc, (b,), 0, max(hw[0] - fine, 0) + 1))
        xs = np.asarray(jax.random.randint(kx, (b,), 0, max(hw[1] - fine, 0) + 1))
    coin = (np.asarray(jax.random.bernoulli(kf, 0.5, (b,))) if do_flip
            else np.zeros(b, bool))
    return torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(coin)


@pytest.mark.parametrize("as_float", [False, True])
@pytest.mark.parametrize("do_crop,do_flip", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_sample_batch_impl_matches_jax(do_crop, do_flip, as_float):
    s = stores()
    if as_float:
        s["inst"] = s["inst"].astype(np.int32)
    idx = np.asarray([3, 0, 3, 4], np.int32)
    fine, key = 24, jax.random.PRNGKey(9)
    want = jdr.sample_batch_impl({k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(idx),
                                 key, fine, do_crop, do_flip, as_float)
    data = {k: torch.from_numpy(pdr._ids_store(v, not as_float) if k == "inst" else v)
            for k, v in s.items()}
    ys, xs, coin = jax_draws(key, 4, s["label"].shape[1:3], fine, do_crop, do_flip)
    if do_flip:
        assert 0 < int(coin.sum()) < 4   # both branches taken
    got = pdr.sample_batch_impl(data, torch.from_numpy(idx), ys, xs, coin, fine, do_crop,
                                do_flip, as_float)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        if k == "image" and as_float:
            # the JAX CPU compile takes x / 127.5 - 1 as one FMA with the
            # reciprocal; the port divides, as its host loader does: one ulp
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_sample_draws_laws():
    """sample_draws' crop corners stay in [0, H - fine] x [0, W - fine],
    cover the range, and the coin is fair; the same generator seed gives
    the same draws."""
    g = torch.Generator().manual_seed(3)
    ys, xs, coin = pdr.sample_draws(4000, (40, 56), 24, True, True, g, "cpu")
    assert int(ys.min()) == 0 and int(ys.max()) == 16
    assert int(xs.min()) == 0 and int(xs.max()) == 32
    assert abs(float(coin.float().mean()) - 0.5) < 5 * 0.5 / np.sqrt(4000)
    again = pdr.sample_draws(4000, (40, 56), 24, True, True, torch.Generator().manual_seed(3),
                             "cpu")
    assert all(torch.equal(a, b) for a, b in zip((ys, xs, coin), again))


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize("u8", [True, False])
def test_resident_bit_equal_to_host_loader(dataroot, tmp_path, u8):
    """No crop, no flip: every resident batch is the host loader's, bit for
    bit, in its dtypes."""
    ds = AlignedDataset(port_opt(dataroot, tmp_path, uint8_transfer=u8))
    host = DataLoader(ds, batch_size=2, shuffle=True, seed=4, num_threads=1)
    res = pdr.DeviceResidentLoader(ds, batch_size=2, shuffle=True, seed=4)
    n = 0
    for hb, rb in zip(host, res):
        for k in ("label", "inst", "image"):
            assert rb[k].numpy().dtype == hb[k].dtype, k
            np.testing.assert_array_equal(rb[k].numpy().view(np.uint8), hb[k].view(np.uint8))
        n += 1
    assert n == len(res) == 2


def test_resident_crop_pads_like_host(dataroot, tmp_path):
    """scale_width leaves 64 rows < fineSize 96 < 128 columns: the host crop
    reads PIL's zero fill past row 64, which the resident store pads."""
    opt = port_opt(dataroot, tmp_path, resize_or_crop="scale_width_and_crop", fineSize=96,
                   uint8_transfer=True)
    ds = AlignedDataset(opt)
    res = pdr.DeviceResidentLoader(ds, batch_size=2, shuffle=False)
    rb = next(iter(res))
    hb = next(iter(DataLoader(ds, batch_size=2, shuffle=False, num_threads=1)))
    for k in ("label", "inst", "image"):
        assert tuple(rb[k].shape) == hb[k].shape, k
        assert not rb[k].numpy()[:, 64:].any()


@pytest.mark.parametrize("u8", [True, False])
def test_bbox_batch_impl_matches_jax(dataroot, tmp_path, u8):
    """The resident bbox batch of every record against the JAX package's:
    ids, masks, boxes and classes bit for bit, RGB within 1e-3."""
    kw = dict(use_bbox_dataset=True, fineSize=32, min_box_size=8, uint8_transfer=u8,
              loadSize=128, resize_or_crop="scale_width")
    pds = BboxCropDataset(port_opt(dataroot, tmp_path, **kw))
    jds = JaxBboxDS(jax_opt(dataroot, tmp_path, **kw))
    assert pds.records == jds.records and len(pds.records) == 12
    pl = pdr.DeviceResidentBboxLoader(pds, batch_size=1, shuffle=False)
    jl = jdr.DeviceResidentBboxLoader(jds, batch_size=1, shuffle=False)
    idx = np.asarray([0, 5, 11, 2, 7, 9], np.int32)
    want = jl._draw(idx)
    got = pl._draw(idx)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        if k == "image":
            if u8:   # rounded to uint8: the products' last bits move a tie at most
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_bbox_resident_ids_equal_streamed(dataroot, tmp_path):
    """The resident bbox batch against the port's streaming dataset: the id
    planes, masks, boxes and classes bit for bit; RGB to PIL's fixed-point
    weights (uint8 steps)."""
    opt = port_opt(dataroot, tmp_path, use_bbox_dataset=True, fineSize=32, min_box_size=8,
                   uint8_transfer=True)
    ds = BboxCropDataset(opt)
    res = pdr.DeviceResidentBboxLoader(ds, batch_size=1, shuffle=False)
    for i in range(len(ds.records)):
        host, dev = ds[i], res._draw(np.asarray([i]))
        for k in ("gt_layout", "masked_layout", "boxmask", "gt_objmask", "inst", "boxes"):
            assert dev[k].numpy()[0].dtype == np.asarray(host[k]).dtype, k
            np.testing.assert_array_equal(dev[k].numpy()[0], host[k], err_msg=k)
        assert int(dev["cls"][0]) == int(host["cls"])
        d = np.abs(dev["image"].numpy()[0].astype(np.float32) - host["image"].astype(np.float32))
        assert d.mean() < 0.5 and d.max() < 3.0, (d.mean(), d.max())


def test_create_dataloader_resident_branches(dataroot, tmp_path):
    aligned = CreateDataLoader(port_opt(dataroot, tmp_path, device_resident_data=True,
                                        uint8_transfer=True))
    assert isinstance(aligned, pdr.DeviceResidentLoader) and len(aligned) == 2
    batches = list(aligned)
    assert len(batches) == 2 and batches[0]["label"].shape == (2, 64, 128)
    bbox = CreateDataLoader(port_opt(dataroot, tmp_path, device_resident_data=True,
                                     use_bbox_dataset=True, fineSize=32, min_box_size=8,
                                     batchSize=1))
    assert isinstance(bbox, pdr.DeviceResidentBboxLoader) and len(bbox) == 12
    assert next(iter(bbox))["gt_layout"].dtype == torch.int32
    with pytest.raises(ValueError, match="does not support --load_features"):
        CreateDataLoader(port_opt(dataroot, tmp_path, device_resident_data=True,
                                  load_features=True))
    # the JAX resident loader would drop the background boxes silently
    with pytest.raises(ValueError, match="bg_box_prob"):
        CreateDataLoader(BoxToMaskTrainOptions(
            dataroot=dataroot, checkpoints_dir=os.path.join(str(tmp_path), "ckpt"),
            gpu_ids="-1", label_nc=8, fineSize=32, min_box_size=8, device_resident_data=True,
            bg_box_prob=0.25))
    # the JAX package drops --data_backend grain under --device_resident_data
    # without a word (ROADMAP §C.15)
    with pytest.raises(ValueError, match="§C.15"):
        CreateDataLoader(port_opt(dataroot, tmp_path, device_resident_data=True,
                                  data_backend="grain", grain_workers=2))


def test_hbm_guard_refuses_and_allows(dataroot, tmp_path, monkeypatch):
    ds = AlignedDataset(port_opt(dataroot, tmp_path))
    monkeypatch.setenv("HIMAN_HBM_BUDGET_BYTES", "1000")
    with pytest.raises(RuntimeError, match="device_resident_data.*stream from the host"):
        pdr.DeviceResidentLoader(ds, batch_size=2)
    bds = BboxCropDataset(port_opt(dataroot, tmp_path, use_bbox_dataset=True, fineSize=32,
                                   min_box_size=8))
    with pytest.raises(RuntimeError, match="resident base planes"):
        pdr.DeviceResidentBboxLoader(bds, batch_size=2)
    monkeypatch.setenv("HIMAN_HBM_BUDGET_BYTES", str(1 << 30))
    assert next(iter(pdr.DeviceResidentLoader(ds, batch_size=2)))["label"].shape[0] == 2
    monkeypatch.setenv("HIMAN_HBM_BUDGET_BYTES", str(1 << 24))
    monkeypatch.setenv("HIMAN_RESIDENT_HBM_FRACTION", "0.00001")
    with pytest.raises(RuntimeError, match="HIMAN_RESIDENT_HBM_FRACTION"):
        pdr.DeviceResidentLoader(ds, batch_size=2)
    monkeypatch.setenv("HIMAN_RESIDENT_HBM_FRACTION", "1.5")
    with pytest.raises(ValueError, match="HIMAN_RESIDENT_HBM_FRACTION"):
        pdr.DeviceResidentLoader(ds, batch_size=2)
    monkeypatch.delenv("HIMAN_HBM_BUDGET_BYTES")
    monkeypatch.delenv("HIMAN_RESIDENT_HBM_FRACTION")
    assert pdr._hbm_budget_bytes("cpu") is None   # no budget on the CPU


# ---------------------------------------------------------------- the fused step

def fused_setup(dataroot, tmp_path, shuffle=True, seed=3):
    opt = port_opt(dataroot, tmp_path, use_masked_image=False,
                   resize_or_crop="scale_width_and_crop", loadSize=64, fineSize=16,
                   no_flip=False, seed=seed, **TINY)
    loader = pdr.DeviceResidentLoader(AlignedDataset(opt), batch_size=2, shuffle=shuffle,
                                      seed=seed)
    assert loader.do_crop and loader.do_flip
    model = create_model(opt)
    state = make_optimizers(opt, model, 2)
    sample_fn, data = loader.fused_sampler()
    return opt, loader, model, state, sample_fn, data


def params_of(model):
    return {f"{net}.{k}": v.detach().clone()
            for net, m in (("G", model.netG), ("D", model.netD))
            for k, v in m.state_dict().items()}


def test_fused_step_resume_is_exact(dataroot, tmp_path, restore_torch_precision):
    """2 steps, then 2 more from freshly built closures (a restart from the
    step count), equal 4 straight steps bit for bit: the permutation and the
    draws are a function of (seed, step)."""
    _, loader, m_a, s_a, sample_fn, data = fused_setup(dataroot, tmp_path)
    step, _ = make_resident_train_step(m_a, sample_fn, loader.n_samples, 2, seed=3)
    for _ in range(4):
        met_a, _ = step(s_a, data)
    _, _, m_b, s_b, sample_fn, data = fused_setup(dataroot, tmp_path)
    step, _ = make_resident_train_step(m_b, sample_fn, loader.n_samples, 2, seed=3)
    for _ in range(2):
        step(s_b, data)
    step2, _ = make_resident_train_step(m_b, sample_fn, loader.n_samples, 2, seed=3)
    for _ in range(2):
        met_b, _ = step2(s_b, data)
    assert s_a.step == s_b.step == 4
    pa, pb = params_of(m_a), params_of(m_b)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(met_a[k], met_b[k]) for k in met_a)


def test_fused_step_with_batch_matches_step(dataroot, tmp_path, restore_torch_precision):
    _, loader, m_a, s_a, sample_fn, data = fused_setup(dataroot, tmp_path, shuffle=False)
    step, _ = make_resident_train_step(m_a, sample_fn, loader.n_samples, 2, shuffle=False,
                                       seed=3)
    met_a, fake_a = step(s_a, data)
    _, _, m_b, s_b, sample_fn, data = fused_setup(dataroot, tmp_path, shuffle=False)
    _, step_wb = make_resident_train_step(m_b, sample_fn, loader.n_samples, 2, shuffle=False,
                                          seed=3)
    met_b, fake_b, batch = step_wb(s_b, data)
    pa, pb = params_of(m_a), params_of(m_b)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(fake_a, fake_b)
    assert all(torch.equal(met_a[k], met_b[k]) for k in met_a)
    # serial order, step 0: the first two scenes, each under its own draws
    assert batch["label"].shape == (2, 16, 16)
    labels = data["label"][:2].to(torch.int32)
    for b in range(2):
        window = batch["label"][b]
        found = any(torch.equal(window, labels[b, y:y + 16, x:x + 16].flip(-1 if f else 0)
                                if f else labels[b, y:y + 16, x:x + 16])
                    for y in range(17) for x in range(49) for f in (False, True))
        assert found


def test_fused_step_matches_jax(dataroot, tmp_path, restore_torch_precision):
    """One fused resident step against JAX make_resident_train_step from the
    same weights, the port fed the draws the JAX step makes (the serial
    order, the crop corners and coins of fold_in(sample_key, 0)): the loss
    terms within 1e-4 relative, every G and D gradient leaf (the JAX step's
    SGD update at lr 1) within 1e-3 of its max."""
    seed = 3
    kw = dict(use_masked_image=False, resize_or_crop="scale_width_and_crop", loadSize=64,
              fineSize=16, no_flip=False, seed=seed, conv_precision="highest", **TINY)
    with jnnops.precision_scope():
        jopt = jax_opt(dataroot, tmp_path, **kw)
        from neurips18_hierchical_image_manipulation_tpu.data.cityscapes import (
            AlignedDataset as JaxAligned,
        )

        jl = jdr.DeviceResidentLoader(JaxAligned(jopt), batch_size=2, shuffle=False, seed=seed)
        jmodel = jax_create_model(jopt)
        sample_fn, jdata = jl.fused_sampler()
        params = jmodel.init_params(jax.random.PRNGKey(0), jl.first_batch())
        path = os.path.join(str(tmp_path), "p.npz")
        save_params_npz(path, params)
        vgg = params.pop("VGG", None)
        step, _ = jax_steps.make_resident_train_step(
            jmodel, sample_fn, jl.n_samples, 2, vgg_params=vgg, shuffle=False, seed=seed,
            donate=False)
        import optax

        # SGD at lr 1: the step's update is minus its gradient, read back
        # from the one compiled step (within an ulp of each parameter)
        tx = optax.sgd(1.0)
        new, jmetrics, _ = step(GANTrainState.create(params, tx, tx, jax.random.PRNGKey(1)),
                                jdata)
        skey = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xA3C0), 0)
        grads = jax.tree.map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                             params, new.params)
    want_grads = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                  for kp, v in jax.tree_util.tree_flatten_with_path(grads)[0]}

    popt = port_opt(dataroot, tmp_path, **kw)
    loader = pdr.DeviceResidentLoader(AlignedDataset(popt), batch_size=2, shuffle=False,
                                      seed=seed)
    model = create_model(popt)
    with np.load(path) as f:
        sds = state_dicts_from_jax({k: f[k] for k in f.files})
    model.netG.load_state_dict(sds["G"])
    model.netD.load_state_dict(sds["D"])
    draws = jax_draws(skey, 2, loader.data["label"].shape[1:3], 16, True, True)

    def sample_jax_draws(data, idx, generator):
        return pdr.sample_batch_impl(data, idx, *draws, 16, True, True, as_float=True)

    pstep, _ = make_resident_train_step(model, sample_jax_draws, loader.n_samples, 2,
                                        shuffle=False, seed=seed)
    metrics, _ = pstep(make_optimizers(popt, model, 2), loader.data)
    assert set(metrics) == {k for k in jmetrics}
    for k, v in jmetrics.items():
        want = float(v)
        assert abs(float(metrics[k]) - want) <= LOSS_RTOL * abs(want), (k, float(metrics[k]), want)
    got = state_dicts_to_jax({net: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                    for n, p in m.named_parameters()}
                              for net, m in (("G", model.netG), ("D", model.netD))})
    assert set(got) == set(want_grads)
    for k, w in want_grads.items():
        scale = np.abs(w).max()
        diff = np.abs(got[k] - w).max()
        assert diff <= GRAD_TOL * scale if scale else diff == 0, (k, diff, scale)

"""The port's data-parallel steps on gloo CPU ranks against the JAX
package's ``shard_map`` steps on its virtual CPU devices, from the same
weights (a JAX init through the npz sidecar) and the same global batch:
``make_dp_train_step`` over 2 ranks (the small objective and the full one,
LSGAN + feature matching + VGG), over a 2 x 2 hybrid ('dcn', 'data') mesh,
and ``make_resident_dp_train_step``; each also against the port's own
single-process step on the concatenated batch. One SGD step at lr 0.1 on
both sides, so the parameters after it show the averaged gradients (as
``tests/test_train_step.py`` compares them): rtol 2e-3 / atol 2e-4, its
tolerance. Also ``maybe_initialize`` without a launcher and the rules of
``make_data_mesh``."""

import json
import os

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.cityscapes import (
    AlignedDataset as JaxAligned,
)
from neurips18_hierchical_image_manipulation_tpu.data.device_resident import (
    DeviceResidentLoader as JaxResidentLoader,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.parallel.mesh import make_hybrid_data_mesh
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.train.state import GANTrainState
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.parallel import DataMesh, make_data_mesh
from neurips18_hierchical_image_manipulation_tpu_torch.parallel.distributed import (
    maybe_initialize,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps
from test_torch_device_resident import jax_draws
from torch_parallel_ranks import (
    _resident,
    dp_cases,
    port_model,
    resident_dp_cases,
    run_ranks,
    sgd_state,
    trained_params,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

RTOL, ATOL = 2e-3, 2e-4
LR = 0.1
TINY = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
            conv_precision="highest")
CASES = {   # name: (arch, ranks, mesh kind)
    "dp": ({**TINY, "num_D": 1, "n_layers_D": 2, "no_ganFeat_loss": True, "no_vgg_loss": True},
           2, "data"),
    "dp_full_loss": (TINY, 2, "data"),
    "hybrid": ({**TINY, "num_D": 1, "n_layers_D": 2, "no_ganFeat_loss": True,
                "no_vgg_loss": True}, 4, "hybrid"),
}
BS = 4
# the resident DP step against JAX: the single-device fused-step comparison's setup
# (``test_torch_device_resident.py::test_fused_step_matches_jax``), its
# dataroot, crops, flips and tolerances, over 2 ranks of one row each
RES_JAX = dict(arch={"label_nc": 8, "ngf": 8, "ndf": 8, "n_downsample_global": 2,
                     "n_blocks_global": 1, "num_D": 1, "n_layers_D": 2, "no_vgg_loss": True,
                     "conv_precision": "highest", "use_masked_image": False,
                     "use_bbox_dataset": False},
               data={"loadSize": 64, "fineSize": 16, "resize_or_crop": "scale_width_and_crop",
                     "no_flip": False, "serial_batches": True, "batchSize": 2, "seed": 3},
               bs=2, seed=3, fine=16)
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-3   # of each leaf's max |g|
# the resident DP step against the port's single-device fused stream: the
# JAX resident DP test's 8 scenes, shuffled, no crop, no flip
RES_STREAM = dict(arch={"label_nc": 35, "ngf": 8, "ndf": 8, "n_downsample_global": 2,
                        "n_blocks_global": 1, "num_D": 1, "n_layers_D": 2, "no_vgg_loss": True,
                        "conv_precision": "highest", "use_masked_image": False,
                        "use_bbox_dataset": False},
                  data={"loadSize": 64, "fineSize": 32, "resize_or_crop": "none",
                        "no_flip": True, "serial_batches": True, "batchSize": 8},
                  bs=8, seed=5, steps=2)


def _write_scenes(root, n, hw, scene):
    for sub in ("train_label", "train_inst", "train_img"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        label, inst, img = scene(i, *hw)
        Image.fromarray(label).save(root / "train_label" / f"{i:03d}.png")
        Image.fromarray(inst, mode="I").save(root / "train_inst" / f"{i:03d}.png")
        Image.fromarray(img).save(root / "train_img" / f"{i:03d}.png")
    return str(root)


def _stripes(i, h, w):
    """``test_torch_device_resident.py``'s scenes: two stripes, one object."""
    label = np.full((h, w), 3, np.uint8)
    label[:h // 2] = 5
    inst = label.astype(np.int32) * 1000
    y0, x0 = 18, 28 + 10 * i
    label[y0:y0 + 26, x0:x0 + 34] = 6
    inst[y0:y0 + 26, x0:x0 + 34] = 6000 + i
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 2 + i) % 256, (xx * 2) % 256, (yy + xx + 7 * i) % 256], -1)
    return label, inst, img.astype(np.uint8)


def _boxes(i, h, w):
    """``tests/test_resident_dp.py``'s scenes."""
    label = np.full((h, w), 3, np.uint8)
    inst = np.zeros((h, w), np.int32)
    label[8 + i:24, 10:40 + i] = 6
    inst[8 + i:24, 10:40 + i] = 6000 + i
    img = np.random.RandomState(i).randint(0, 255, size=(h, w, 3), dtype=np.uint8)
    return label, inst, img


def _flat(tmp, name, params):
    path = os.path.join(tmp, f"{name}.npz")
    save_params_npz(path, params)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _jax_mesh(kind, n):
    if kind == "hybrid":
        mesh = make_hybrid_data_mesh(n_slices=2, n_devices=n)
        assert mesh.axis_names == ("dcn", "data") and mesh.devices.shape == (2, n // 2)
        return mesh, ("dcn", "data")
    return Mesh(np.array(jax.devices()[:n]), ("data",)), "data"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {"jax": _write_scenes(tmp_path_factory.mktemp("city4"), 4, (64, 128), _stripes),
            "shuffled": _write_scenes(tmp_path_factory.mktemp("city8"), 8, (32, 64), _boxes)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, roots):
    """Every case's JAX step, then the port's ranks: one spawn of 2 ranks
    (both 1-D cases and the resident step), one of 4 (the hybrid mesh)."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    jax_out, by_world = {}, {}
    with jnnops.precision_scope():
        for name, (arch, n, kind) in CASES.items():
            opt = JaxTrainOptions(name=name, checkpoints_dir=tmp, batchSize=BS, **arch)
            model = jax_create_model(opt)
            batch = synthetic_batch(np.random.RandomState(0), BS, hw=(32, 32), label_nc=8)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            params = model.init_params(jax.random.PRNGKey(0), jb)
            flat = _flat(tmp, f"{name}_init", params)
            vgg = params.pop("VGG", None)
            mesh, axis = _jax_mesh(kind, n)
            state = GANTrainState.create(params, optax.sgd(LR), optax.sgd(LR),
                                         jax.random.PRNGKey(1))
            dp = jax_steps.make_dp_train_step(model, mesh, vgg_params=vgg, axis=axis)
            new, metrics, _ = dp(jax_steps.replicate(state, mesh),
                                 jax_steps.shard_batch(jb, mesh, axis=axis))
            jax_out[name] = dict(batch=batch, flat=flat,
                                 params=_flat(tmp, f"{name}_jax", new.params),
                                 metrics={k: float(v) for k, v in metrics.items()})
            in_path = os.path.join(tmp, f"{name}_in.npz")
            np.savez(in_path, arch=np.array(json.dumps(arch)), lr=LR,
                     **{f"w:{k}": v for k, v in flat.items()},
                     **{f"b:{k}": v for k, v in batch.items()})
            by_world.setdefault(n, []).append((in_path, os.path.join(tmp, f"{name}_out.npz"),
                                               kind))
        # the resident DP step in serial order, each device's draws handed
        # to its rank
        r = RES_JAX
        jopt = JaxTrainOptions(name="rdp", checkpoints_dir=tmp, dataroot=roots["jax"],
                               **r["arch"], **r["data"])
        jl = JaxResidentLoader(JaxAligned(jopt), batch_size=r["bs"], shuffle=False,
                               seed=r["seed"])
        jm = jax_create_model(jopt)
        sample_fn, data = jl.fused_sampler()
        params = jm.init_params(jax.random.PRNGKey(0), jl.first_batch())
        jflat = _flat(tmp, "rdp_init", params)
        mesh, _ = _jax_mesh("data", 2)
        step, _ = jax_steps.make_resident_dp_train_step(
            jm, mesh, sample_fn, jl.n_samples, r["bs"], shuffle=False, seed=r["seed"],
            donate=False)
        tx = optax.sgd(1.0)
        new, metrics, _ = step(jax_steps.replicate(
            GANTrainState.create(params, tx, tx, jax.random.PRNGKey(1)), mesh),
            jax_steps.replicate(data, mesh))
        key = jax.random.fold_in(jax.random.PRNGKey(r["seed"] ^ 0xA3C0), 0)
        draws = [jax_draws(jax.random.fold_in(key, d), 1, data["label"].shape[1:3], r["fine"],
                           True, True) for d in range(2)]
        after = _flat(tmp, "rdp_jax", new.params)
        jax_out["resident"] = dict(
            grads={k: jflat[k].astype(np.float64) - after[k] for k in after},
            metrics={k: float(v) for k, v in metrics.items()})
        # the shuffled stream's weights
        s = RES_STREAM
        sopt = JaxTrainOptions(name="rs", checkpoints_dir=tmp, dataroot=roots["shuffled"],
                               **s["arch"], **s["data"])
        sl = JaxResidentLoader(JaxAligned(sopt), batch_size=s["bs"], seed=s["seed"])
        sflat = _flat(tmp, "rs_init", jax_create_model(sopt).init_params(
            jax.random.PRNGKey(0), sl.first_batch()))
        jax_out["shuffled"] = dict(flat=sflat)
    cfg = {"jax": {**{k: v for k, v in r.items() if k != "data"},
                   "data": {**r["data"], "dataroot": roots["jax"]}},
           "shuffled": {**{k: v for k, v in s.items() if k != "data"},
                        "data": {**s["data"], "dataroot": roots["shuffled"]}}}
    rin = os.path.join(tmp, "rdp_in.npz")
    np.savez(rin, cfg=np.array(json.dumps(cfg)), lr=LR,
             **{f"draw{k}": np.stack([d[k].numpy() for d in draws]) for k in range(3)},
             **{f"jw:{k}": v for k, v in jflat.items()},
             **{f"sw:{k}": v for k, v in sflat.items()})
    run_ranks(_two_rank_cases, 2, tmp, by_world[2], rin, os.path.join(tmp, "rdp_out.npz"))
    run_ranks(dp_cases, 4, tmp, by_world[4])
    got = {name: _load(os.path.join(tmp, f"{name}_out.npz")) for name in CASES}
    got["resident"] = _load(os.path.join(tmp, "rdp_out.npz"))
    return jax_out, got, cfg


def _two_rank_cases(rank, world, cases, rin, rout):
    dp_cases(rank, world, cases)
    resident_dp_cases(rank, world, rin, rout)


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def _single_step(arch, flat, batch):
    """The port's single-process step on the whole batch, SGD at LR."""
    model = port_model(arch, flat)
    metrics, _ = steps.make_train_step(model)(sgd_state(model, LR),
                                              {k: torch.from_numpy(v) for k, v in batch.items()})
    return trained_params(model), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax_and_single(runs, name, restore_torch_precision):
    """Ranks' mean gradients (and metrics) equal the JAX DP step's and the
    port's single-process step's on the concatenated batch."""
    jax_out, got, _ = runs
    j, g = jax_out[name], got[name]
    params, metrics = _sub(g, "p:"), {k: float(v) for k, v in _sub(g, "m:").items()}
    _close(params, j["params"], f"{name} vs JAX")
    _close(metrics, j["metrics"], f"{name} metrics vs JAX")
    moved = max(np.abs(j["params"][k] - j["flat"][k]).max() for k in j["params"])
    assert moved > 1e-3   # the step did move the parameters
    s_params, s_metrics = _single_step(CASES[name][0], j["flat"], j["batch"])
    _close(params, s_params, f"{name} vs single")
    _close(metrics, s_metrics, f"{name} metrics vs single")
    if name == "dp_full_loss":
        assert metrics["G_VGG"] != 0.0 and metrics["G_GAN_Feat"] != 0.0


def test_resident_dp_step_matches_jax(runs, restore_torch_precision):
    """One resident DP step in serial order against JAX
    ``make_resident_dp_train_step`` on 2 devices, each rank fed its
    device's draws: the mean loss terms within 1e-4 relative, every mean
    gradient leaf within 1e-3 of its max (the bars of the single-device
    fused-step comparison)."""
    jax_out, got, _ = runs
    g, want = got["resident"], jax_out["resident"]
    metrics = {k: float(v) for k, v in _sub(g, "jax:m:").items()}
    assert set(metrics) == set(want["metrics"])
    for k, w in want["metrics"].items():
        assert abs(metrics[k] - w) <= LOSS_RTOL * abs(w), (k, metrics[k], w)
    grads = _sub(g, "jax:g:")
    assert set(grads) == set(want["grads"])
    for k, w in want["grads"].items():
        scale, diff = np.abs(w).max(), np.abs(grads[k] - w).max()
        assert diff <= GRAD_TOL * scale if scale else diff == 0, (k, diff, scale)


def test_resident_dp_step_matches_single(runs, restore_torch_precision):
    """Shuffled, the resident DP step trains the port's single-device fused
    stream: the same global batch (the permutation of (seed, epoch) on every
    rank) and the same parameters after the steps."""
    jax_out, got, cfg = runs
    g, c = got["resident"], cfg["shuffled"]
    loader = _resident(c["arch"], c["data"], c["bs"], c["seed"])
    sample_fn, data = loader.fused_sampler()
    model = port_model(c["arch"], jax_out["shuffled"]["flat"])
    state = sgd_state(model, LR)
    step, step_wb = steps.make_resident_train_step(model, sample_fn, loader.n_samples, c["bs"],
                                                   shuffle=True, seed=c["seed"])
    _, _, batch = step_wb(state, data)
    for _ in range(c["steps"] - 1):
        step(state, data)
    np.testing.assert_array_equal(g["shuffled:label"], batch["label"].numpy())
    serial = loader.data["label"][:c["bs"]].numpy()
    assert not np.array_equal(g["shuffled:label"], serial)
    _close(_sub(g, "shuffled:p:"), trained_params(model), "resident vs single")


def test_resident_dp_rejects_indivisible_batch(runs, restore_torch_precision):
    _, _, cfg = runs
    c = cfg["shuffled"]
    loader = _resident(c["arch"], c["data"], c["bs"], c["seed"])
    sample_fn, _ = loader.fused_sampler()
    model = port_model(c["arch"], {})
    mesh = DataMesh((2,), ("data",), rank=0)   # refused before any collective
    with pytest.raises(ValueError, match="divisible"):
        steps.make_resident_dp_train_step(model, mesh, sample_fn, loader.n_samples, 9)
    with pytest.raises(ValueError, match="divisible"):
        steps.shard_batch({"label": torch.zeros(9, 2, 2)}, mesh)


def test_maybe_initialize_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize() is False   # no launcher environment: single process
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_devices,bs,cpu,cards", [
    (0, 4, None, 2), (2, 4, 2, 2), (3, 4, 2, 2), (4, 6, 3, 2), (5, 5, 5, None), (2, 1, None, None),
    (4, 7, None, None)])
def test_make_data_mesh_rules(mesh_devices, bs, cpu, cards, monkeypatch):
    """The JAX rules: 0 means every local device, capped at the devices
    present, shrunk to the largest divisor of the global batch, None at 1.
    The CPU offers one device unless --mesh_devices asks for more (at most
    its cores); here 2 cards."""
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for gpu_ids, want in (("-1", cpu), ("0", cards)):
        mesh = make_data_mesh(MaskToImageTrainOptions(gpu_ids=gpu_ids, mesh_devices=mesh_devices,
                                                      batchSize=bs))
        assert (mesh.world_size if mesh else None) == want, gpu_ids
        assert mesh is None or (mesh.axis_names == ("data",) and not mesh.launched)

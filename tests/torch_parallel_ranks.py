"""Rank workers of the port's multi-process tests (``tests/test_torch_parallel*.py``,
``test_torch_spatial.py``). Spawned ranks import this module afresh, so it
imports only torch, numpy and the port, never JAX: the JAX side of each
comparison runs in the pytest process and hands its arrays over in ``.npz``
files. Each worker joins a gloo group through a file, runs on the CPU with
one thread and writes rank 0's results to an ``.npz``."""

import json
import os

import numpy as np
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.parallel import distributed, make_mesh
from neurips18_hierchical_image_manipulation_tpu_torch.parallel import spatial

GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 180.0


def run_ranks(fn, world, tmp_path, *args):
    """``fn(rank, world, *args)`` on ``world`` gloo CPU ranks joined through
    a file under ``tmp_path``; fails past JOIN_TIMEOUT_S."""
    init = f"file://{os.path.join(str(tmp_path), 'dist_init')}"
    if os.path.exists(init[len("file://"):]):
        os.remove(init[len("file://"):])
    distributed.spawn(_entry, world, args=(fn, world, init, args), join_timeout_s=JOIN_TIMEOUT_S)


def _entry(rank, fn, world, init, args):
    torch.set_num_threads(1)
    distributed.maybe_initialize(init, world, rank, "gloo", timeout_s=GROUP_TIMEOUT_S)
    try:
        fn(rank, world, *args)
    finally:
        distributed.shutdown(True)


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def spatial_case(rank, world, in_path, out_path):
    """Every spatial function over a 1-D mesh: the halo conv (k 3 and 7),
    the GlobalGenerator, the LocalEnhancer and the width-1 rejection, each
    result gathered back to the full width."""
    from neurips18_hierchical_image_manipulation_tpu_torch.models.networks import (
        GlobalGenerator,
        LocalEnhancer,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
        params_from_jax,
    )

    d = _load(in_path)
    arch = json.loads(str(d["arch"]))
    mesh = make_mesh((world,), ("data",))
    out = {}
    x = torch.from_numpy(d["conv_x"])
    for k in (3, 7):
        w, b = torch.from_numpy(d[f"w{k}"]), torch.from_numpy(d[f"b{k}"])
        fn = spatial.make_spatial_conv(mesh, w, b, padding=k // 2)
        out[f"conv{k}"] = spatial.gather_w(fn(spatial.shard_w(x, mesh)), mesh).numpy()
    g = GlobalGenerator(**arch["gen"])
    g.load_state_dict(params_from_jax(_sub(d, "gen:")))
    fn = spatial.make_spatial_generator(mesh, g, n_downsampling=arch["gen"]["n_downsampling"],
                                        n_blocks=arch["gen"]["n_blocks"])
    xg = torch.from_numpy(d["gen_x"])
    out["gen"] = spatial.gather_w(fn(spatial.shard_w(xg, mesh)), mesh).numpy()
    le = LocalEnhancer(**arch["le"])
    le.load_state_dict(params_from_jax(_sub(d, "le:")))
    a = arch["le"]
    fn = spatial.make_spatial_local_enhancer(
        mesh, le, n_downsample_global=a["n_downsample_global"],
        n_blocks_global=a["n_blocks_global"], n_local_enhancers=a["n_local_enhancers"],
        n_blocks_local=a["n_blocks_local"])
    out["le"] = spatial.gather_w(fn(spatial.shard_w(torch.from_numpy(d["le_x"]), mesh)),
                                 mesh).numpy()
    narrow = spatial.make_spatial_generator(mesh, g, n_downsampling=2, n_blocks=1)
    try:
        narrow(torch.zeros(1, 16, 4, arch["gen"]["input_nc"]))
        out["narrow"] = np.array("accepted")
    except ValueError as e:
        out["narrow"] = np.array(str(e))
    if rank == 0:
        np.savez(out_path, **out)


def spatial_2d_case(rank, world, in_path, out_path):
    """The halo conv on a 2-D ('data', 'spatial') mesh: rows split over
    'data', W over 'spatial', halos along 'spatial' only."""
    d = _load(in_path)
    mesh = make_mesh((2, world // 2), ("data", "spatial"))
    x = torch.from_numpy(d["x"])
    n_rows = x.shape[0] // mesh.axis_size("data")
    r = mesh.axis_index("data")
    xs = spatial.shard_w(x[r * n_rows:(r + 1) * n_rows], mesh, "spatial")
    y = spatial.halo_exchange_conv2d(xs, torch.from_numpy(d["w"]), torch.from_numpy(d["b"]),
                                     padding=1, mesh=mesh, axis="spatial")
    rows = spatial.gather_w(y, mesh, "spatial")
    full = torch.cat(mesh.all_gather(rows, "data"), 0)
    if rank == 0:
        np.savez(out_path, y=full.numpy())


def sgd_state(model, lr):
    """A train state whose optimizers are plain SGD at ``lr``: a step's
    update is minus lr times its gradient, so the parameters after it show
    the gradient the step averaged."""
    from neurips18_hierchical_image_manipulation_tpu_torch.train.state import GANTrainState

    g_side = [p for net in (model.netG, getattr(model, "netE", None)) if net is not None
              for p in net.parameters()]
    opt_g = torch.optim.SGD(g_side, lr=lr)
    opt_d = torch.optim.SGD(model.netD.parameters(), lr=lr)
    return GANTrainState(opt_g, opt_d, torch.optim.lr_scheduler.LambdaLR(opt_g, lambda s: 1.0),
                         torch.optim.lr_scheduler.LambdaLR(opt_d, lambda s: 1.0))


def port_model(arch, flat):
    """The port's mask2image model of ``arch`` on the CPU, G, D (and VGG)
    loaded from a JAX npz dict."""
    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
        MaskToImageTrainOptions,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
    from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
        state_dicts_from_jax,
    )

    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **arch))
    for net, sd in state_dicts_from_jax(flat).items():
        model.nets()[net].load_state_dict(sd)
    return model


def trained_params(model):
    """G's and D's parameters keyed like the JAX tree."""
    from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
        state_dicts_to_jax,
    )

    return state_dicts_to_jax({"G": model.netG.state_dict(), "D": model.netD.state_dict()})


def _mesh(kind, world):
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import make_hybrid_data_mesh

    if kind == "hybrid":
        return make_hybrid_data_mesh(2), ("dcn", "data")
    return make_mesh((world,), ("data",)), "data"


def dp_cases(rank, world, cases):
    """One SGD step of ``make_dp_train_step`` per case (in_path, out_path,
    mesh kind): each rank its rows of the case's global batch."""
    from neurips18_hierchical_image_manipulation_tpu_torch.train import steps

    for in_path, out_path, kind in cases:
        d = _load(in_path)
        model = port_model(json.loads(str(d["arch"])), _sub(d, "w:"))
        mesh, axis = _mesh(kind, world)
        state = sgd_state(model, float(d["lr"]))
        batch = {k[2:]: torch.from_numpy(v) for k, v in d.items() if k.startswith("b:")}
        metrics, fake = steps.make_dp_train_step(model, mesh, axis=axis)(
            state, steps.shard_batch(batch, mesh, axis))
        if rank == 0:
            np.savez(out_path, **{f"p:{k}": v for k, v in trained_params(model).items()},
                     **{f"m:{k}": float(v) for k, v in metrics.items()})


def _resident(arch, data_opts, bs, seed):
    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
        MaskToImageTrainOptions,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.data.cityscapes import AlignedDataset
    from neurips18_hierchical_image_manipulation_tpu_torch.data.device_resident import (
        DeviceResidentLoader,
    )

    opt = MaskToImageTrainOptions(gpu_ids="-1", **arch, **data_opts)
    return DeviceResidentLoader(AlignedDataset(opt), batch_size=bs, shuffle=True, seed=seed)


def resident_dp_cases(rank, world, in_path, out_path):
    """``make_resident_dp_train_step`` over the same resident stores:

      * "jax": one SGD step at lr 1 in serial order, each rank sampling its
        row with the draws the JAX step makes on its device (the updates
        are minus the mean gradients);
      * "shuffled": ``n_steps`` SGD steps at ``lr`` in shuffled order, with
        every rank's first batch gathered."""
    from neurips18_hierchical_image_manipulation_tpu_torch.data import device_resident as pdr
    from neurips18_hierchical_image_manipulation_tpu_torch.train import steps

    d = _load(in_path)
    cfg = json.loads(str(d["cfg"]))
    mesh, axis = _mesh("data", world)
    out = {}
    c = cfg["jax"]
    loader = _resident(c["arch"], c["data"], c["bs"], c["seed"])
    draws = [torch.from_numpy(d[f"draw{k}"][rank]) for k in range(3)]

    def sample_jax_draws(data, idx, generator):
        return pdr.sample_batch_impl(data, idx, *draws, c["fine"], True, True, as_float=True)

    model = port_model(c["arch"], _sub(d, "jw:"))
    before = {k: v.copy() for k, v in trained_params(model).items()}
    step, _ = steps.make_resident_dp_train_step(model, mesh, sample_jax_draws, loader.n_samples,
                                                c["bs"], shuffle=False, seed=c["seed"])
    metrics, _ = step(sgd_state(model, 1.0), loader.data)
    out.update({f"jax:g:{k}": before[k] - v for k, v in trained_params(model).items()})
    out.update({f"jax:m:{k}": float(v) for k, v in metrics.items()})
    c = cfg["shuffled"]
    loader = _resident(c["arch"], c["data"], c["bs"], c["seed"])
    sample_fn, data = loader.fused_sampler()
    model = port_model(c["arch"], _sub(d, "sw:"))
    state = sgd_state(model, float(d["lr"]))
    step, step_wb = steps.make_resident_dp_train_step(model, mesh, sample_fn, loader.n_samples,
                                                      c["bs"], shuffle=True, seed=c["seed"])
    _, _, batch = step_wb(state, data)
    out["shuffled:label"] = torch.cat(mesh.all_gather(batch["label"].contiguous(), "data"),
                                      0).numpy()
    for _ in range(c["steps"] - 1):
        step(state, data)
    out.update({f"shuffled:p:{k}": v for k, v in trained_params(model).items()})
    if rank == 0:
        np.savez(out_path, **out)

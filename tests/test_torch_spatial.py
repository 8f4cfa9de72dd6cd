"""The port's W-sharded inference (``parallel/spatial.py``) on gloo CPU
ranks against the JAX package's ``shard_map`` forms on its virtual CPU
devices and against the port's unsharded modules: the halo conv (k 3 and
7), the GlobalGenerator, the LocalEnhancer, the width-1-bottleneck
rejection, and the halo conv on a 2-D (data x spatial) mesh over 4 ranks.
Tolerance atol 2e-5 / rtol 1e-5, the JAX tests' (``test_spatial_sharding.py``)."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from neurips18_hierchical_image_manipulation_tpu.models import networks as jnet
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.parallel import spatial as jspatial
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import save_params_npz
from neurips18_hierchical_image_manipulation_tpu_torch.models.networks import (
    GlobalGenerator,
    LocalEnhancer,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import params_from_jax
from torch_parallel_ranks import run_ranks, spatial_2d_case, spatial_case

ATOL, RTOL = 2e-5, 1e-5
WORLD = 2
GEN = dict(input_nc=5, output_nc=3, ngf=8, n_downsampling=2, n_blocks=2)
LE = dict(input_nc=5, output_nc=3, ngf=4, n_downsample_global=2, n_blocks_global=2,
          n_local_enhancers=1, n_blocks_local=1)


def _hwio(w):
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _flat(tmp, name, params):
    path = os.path.join(tmp, f"{name}.npz")
    save_params_npz(path, {"G": params})
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX results on WORLD virtual devices, then the port's on WORLD
    gloo ranks (one spawn for every 1-D case, one of 4 ranks for the 2-D
    case)."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    rng = np.random.RandomState(0)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    d = {"conv_x": rng.randn(2, 8, 32, 16).astype(np.float32)}
    want = {}
    with jnnops.precision_scope():
        jnnops.set_default_precision("highest")
        for k in (3, 7):
            d[f"w{k}"] = (rng.randn(8, 16, k, k) * 0.1).astype(np.float32)
            d[f"b{k}"] = rng.randn(8).astype(np.float32)
            fn = jspatial.make_spatial_conv(mesh, jnp.asarray(_hwio(d[f"w{k}"])),
                                            jnp.asarray(d[f"b{k}"]), padding=k // 2)
            want[f"conv{k}"] = np.asarray(fn(jnp.asarray(d["conv_x"])))
        gen = jnet.GlobalGenerator(output_nc=3, ngf=8, n_downsampling=2, n_blocks=2)
        d["gen_x"] = np.random.RandomState(7).randn(1, 16, 8 * WORLD * 4, 5).astype(np.float32)
        gp = gen.init(jax.random.PRNGKey(0), jnp.asarray(d["gen_x"]))
        want["gen"] = np.asarray(jspatial.make_spatial_generator(
            mesh, gp, n_downsampling=2, n_blocks=2)(jnp.asarray(d["gen_x"])))
        le = jnet.LocalEnhancer(output_nc=3, ngf=4, n_downsample_global=2, n_blocks_global=2,
                                n_local_enhancers=1, n_blocks_local=1)
        d["le_x"] = np.random.RandomState(3).randn(1, 16, 16 * WORLD, 5).astype(np.float32)
        lp = le.init(jax.random.PRNGKey(0), jnp.asarray(d["le_x"]))
        want["le"] = np.asarray(jspatial.make_spatial_local_enhancer(
            mesh, lp, n_downsample_global=2, n_blocks_global=2, n_local_enhancers=1,
            n_blocks_local=1)(jnp.asarray(d["le_x"])))
        # the 2-D mesh: data 2 x spatial 2
        x2 = rng.randn(4, 8, 32, 16).astype(np.float32)
        w2 = (rng.randn(8, 16, 3, 3) * 0.1).astype(np.float32)
        b2 = rng.randn(8).astype(np.float32)
        want["conv2d"] = np.asarray(jnnops.conv2d(jnp.asarray(x2), jnp.asarray(_hwio(w2)),
                                                  jnp.asarray(b2), stride=1, padding=1))
    for prefix, params in (("gen:", gp), ("le:", lp)):
        d.update({prefix + k: v for k, v in _flat(tmp, prefix[:-1], params).items()})
    d["arch"] = np.array(json.dumps({"gen": GEN, "le": LE}))
    np.savez(os.path.join(tmp, "in.npz"), **d)
    np.savez(os.path.join(tmp, "in2d.npz"), x=x2, w=w2, b=b2)
    run_ranks(spatial_case, WORLD, tmp, os.path.join(tmp, "in.npz"),
              os.path.join(tmp, "out.npz"))
    run_ranks(spatial_2d_case, 4, tmp, os.path.join(tmp, "in2d.npz"),
              os.path.join(tmp, "out2d.npz"))
    with np.load(os.path.join(tmp, "out.npz")) as f:
        got = {k: f[k] for k in f.files}
    with np.load(os.path.join(tmp, "out2d.npz")) as f:
        got["conv2d"] = f["y"]
    return d, want, got


def _unsharded(module_cls, arch, flat, x):
    net = module_cls(**arch)
    net.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("k", [3, 7])
def test_halo_conv_matches(runs, k):
    d, want, got = runs
    np.testing.assert_allclose(got[f"conv{k}"], want[f"conv{k}"], atol=ATOL, rtol=RTOL)
    x = torch.from_numpy(d["conv_x"]).permute(0, 3, 1, 2)
    ref = F.conv2d(x, torch.from_numpy(d[f"w{k}"]), torch.from_numpy(d[f"b{k}"]),
                   padding=k // 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got[f"conv{k}"], ref, atol=ATOL, rtol=RTOL)


def test_spatial_generator_matches(runs):
    d, want, got = runs
    assert got["gen"].shape == want["gen"].shape == (1, 16, 64, 3)
    np.testing.assert_allclose(got["gen"], want["gen"], atol=ATOL, rtol=RTOL)
    flat = {k[4:]: v for k, v in d.items() if k.startswith("gen:")}
    ref = _unsharded(GlobalGenerator, GEN, flat, d["gen_x"])
    np.testing.assert_allclose(got["gen"], ref, atol=ATOL, rtol=RTOL)


def test_spatial_local_enhancer_matches(runs):
    d, want, got = runs
    assert got["le"].shape == want["le"].shape == (1, 16, 32, 3)
    np.testing.assert_allclose(got["le"], want["le"], atol=ATOL, rtol=RTOL)
    flat = {k[3:]: v for k, v in d.items() if k.startswith("le:")}
    ref = _unsharded(LocalEnhancer, LE, flat, d["le_x"])
    np.testing.assert_allclose(got["le"], ref, atol=ATOL, rtol=RTOL)


def test_spatial_generator_rejects_width1_bottleneck(runs):
    """Per-shard W 4 under 2 downs leaves a bottleneck of 1 column, which
    the JAX package once turned into an empty output: refused."""
    _, _, got = runs
    assert "bottleneck" in str(got["narrow"])


def test_halo_conv_on_2d_mesh_dp_x_spatial(runs):
    _, want, got = runs
    np.testing.assert_allclose(got["conv2d"], want["conv2d"], atol=ATOL, rtol=RTOL)

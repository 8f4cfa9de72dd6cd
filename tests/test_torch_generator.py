"""The port's GlobalGenerator serving path (Pix2PixHDModel.inference) against
the JAX package's, with JAX-initialized weights carried over through the
npz sidecar and ``params_from_jax``."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTestOptions as JaxOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.utils.checkpoint import (
    load_params_npz,
    save_params_npz,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.ops.nnops import PaddedStemInput
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    params_from_jax,
    params_to_jax,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

# fp32 with full-fp32 convolutions on both sides (--conv_precision highest):
# the same math in another summation order, through 7 conv layers and INs.
ATOL = 1e-4
ARCH = dict(label_nc=8, ngf=8, n_downsample_global=2, n_blocks_global=1)
DEAD = ("conv_in", "down0", "down1", "res0/conv1", "res0/conv2", "up0", "up1")


@pytest.fixture
def jax_tier():
    """jax create_model flips process-wide tier switches; restore them."""
    with jnnops.precision_scope():
        yield


def jax_setup(tmp_path, norm, seed=0):
    """JAX model, a (B=2, 32x64) batch, and its G params as a flat npz."""
    opt = JaxOptions(name="g", checkpoints_dir=str(tmp_path), norm=norm,
                     conv_precision="highest", **ARCH)
    model = jax_create_model(opt)
    batch = synthetic_batch(np.random.RandomState(seed), 2, hw=(32, 64), label_nc=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init_params(jax.random.PRNGKey(seed), jb)
    path = os.path.join(str(tmp_path), "g_params.npz")
    save_params_npz(path, {"G": params["G"]})
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    return model, jb, batch, flat, path, params


def jax_inference(model, jb, flat, path, params):
    np.savez(path, **flat)
    g = load_params_npz(path, {"G": params["G"]})
    return np.asarray(model.inference(g, jb))


def port_inference(norm, batch, flat):
    opt = MaskToImageTestOptions(gpu_ids="-1", norm=norm, conv_precision="highest", **ARCH)
    model = create_model(opt)
    model.netG.load_state_dict(params_from_jax(flat))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model.inference(tb).numpy(), model


def perturb_biases(flat, seed, only=None):
    """Non-zero biases (and batch-norm scales) so every live one shows."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "scale") and (only is None or any(f"/{m}/" in k for m in only)):
            out[k] = (v + rng.randn(*v.shape) * 0.3).astype(v.dtype)
    return out


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_inference_matches_jax(jax_tier, restore_torch_precision, tmp_path, norm):
    model, jb, batch, flat, path, params = jax_setup(tmp_path, norm)
    flat = perturb_biases(flat, 1)
    want = jax_inference(model, jb, flat, path, params)
    got, _ = port_inference(norm, batch, flat)
    assert got.shape == want.shape == (2, 32, 64, 3)
    assert np.abs(got - want).max() <= ATOL


def test_dead_biases_do_not_move_output(jax_tier, restore_torch_precision, tmp_path):
    model, jb, batch, flat, path, params = jax_setup(tmp_path, "instance", seed=2)
    moved = perturb_biases(flat, 3, only=DEAD)
    assert any(not np.array_equal(moved[k], flat[k]) for k in flat)
    jax_a = jax_inference(model, jb, flat, path, params)
    jax_b = jax_inference(model, jb, moved, path, params)
    port_a, _ = port_inference("instance", batch, flat)
    port_b, _ = port_inference("instance", batch, moved)
    np.testing.assert_array_equal(jax_a, jax_b)
    np.testing.assert_array_equal(port_a, port_b)
    # conv_out's bias is live
    live = perturb_biases(flat, 4, only=("conv_out",))
    port_c, _ = port_inference("instance", batch, live)
    assert np.abs(port_c - port_a).max() > 1e-3


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_params_round_trip_bit_exact(jax_tier, tmp_path, norm):
    _, _, _, flat, _, _ = jax_setup(tmp_path, norm, seed=5)
    back = params_to_jax(params_from_jax(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])


def test_state_dict_keys_match_jax_tree(jax_tier, restore_torch_precision, tmp_path):
    _, _, batch, flat, _, _ = jax_setup(tmp_path, "batch", seed=6)
    _, model = port_inference("batch", batch, flat)
    assert sorted(model.netG.state_dict()) == sorted(params_from_jax(flat))


def test_encode_input_branches(restore_torch_precision):
    """Instance norm + even H/W -> the padded stem input; batch norm ->
    the unpadded tensor; every IN site goes through the kernel wrapper."""
    batch = synthetic_batch(np.random.RandomState(7), 1, hw=(32, 64), label_nc=8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = MaskToImageTestOptions(gpu_ids="-1", **ARCH)
    m = create_model(opt)
    g = m.encode_input(tb)
    assert isinstance(g, PaddedStemInput) and tuple(g.padded.shape) == (1, 38, 70, 12)
    calls = []
    orig = kin.instance_norm
    kin.instance_norm = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        out = m.inference(tb)
    finally:
        kin.instance_norm = orig
    assert tuple(out.shape) == (1, 32, 64, 3)
    assert len(calls) == 1 + 2 * 2 + 2 * 1  # stem, downs + ups, 2 per resblock
    mb = create_model(MaskToImageTestOptions(gpu_ids="-1", norm="batch", **ARCH))
    assert tuple(mb.encode_input(tb).shape) == (1, 32, 64, 12)


def test_uint8_image_normalized_on_device(restore_torch_precision):
    batch = synthetic_batch(np.random.RandomState(8), 1, hw=(16, 16), label_nc=8)
    u8 = np.random.RandomState(9).randint(0, 256, size=(1, 16, 16, 3)).astype(np.uint8)
    m = create_model(MaskToImageTestOptions(gpu_ids="-1", **ARCH))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    a = m.encode_input(dict(tb, image=torch.from_numpy(u8))).padded
    b = m.encode_input(dict(tb, image=torch.from_numpy(u8.astype(np.float32) / 127.5 - 1.0))).padded
    assert torch.equal(a, b)


def test_gpu_ids_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(MaskToImageTestOptions(gpu_ids="0", **ARCH))

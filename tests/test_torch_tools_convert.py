"""The port's checkpoint converters (``tools/convert_torch_checkpoint.py``,
``tools/load_vgg_weights.py``) and pix2pixHD's module format
(``tools/pix2pixhd_format.py``) against the JAX package's tools of the
same names, on the CPU.

  (a) the npz each writes equals the JAX tool's, array for array and bit
      for bit: G (2 downs, 2 resblocks, both resblock spellings), D (2
      scales, each key spelling), VGG19 up to the key prefix;
  (b) the port's G loaded from a ``.pth`` against the reference-format
      module run by plain PyTorch (atol 5e-5, rtol 1e-4, the JAX test's
      tolerance, ``tests/test_parity_runbook.py``) and against the JAX G
      loaded from the JAX tool's npz (1e-4);
  (c) the port's stand-ins equal the JAX tool's for the same seed, and the
      inverse maps (port G / D -> pix2pixHD keys) round-trip bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurips18_hierchical_image_manipulation_tpu.models import networks as jnet
from neurips18_hierchical_image_manipulation_tpu_torch.cli.evaluate import load_vgg
from neurips18_hierchical_image_manipulation_tpu_torch.configs import options as popts
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks as pnet
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (
    convert_torch_checkpoint as pconv,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import load_vgg_weights as pvgg
from neurips18_hierchical_image_manipulation_tpu_torch.tools import parity_report as ppr
from neurips18_hierchical_image_manipulation_tpu_torch.tools import pix2pixhd_format as fmt
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    state_dicts_from_jax,
)
from torch_oracle import GlobalGeneratorT, NLayerDiscriminatorT
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import convert_torch_checkpoint as jconv  # noqa: E402  (the JAX tool)
import load_vgg_weights as jvgg  # noqa: E402
import parity_report as jpr  # noqa: E402

N_DOWN, N_BLOCKS, NGF, IN_NC = 2, 2, 8, 9
ATOL, RTOL = 5e-5, 1e-4


def same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def g_state_dict(seed, inner="block"):
    torch.manual_seed(seed)
    t = GlobalGeneratorT(IN_NC, 3, ngf=NGF, n_down=N_DOWN, n_blocks=N_BLOCKS).eval()
    sd = {k: v.numpy() for k, v in t.state_dict().items()}
    if inner != "block":
        sd = {k.replace(".block.", f".{inner}."): v for k, v in sd.items()}
    return t, sd


def d_state_dict(spelling, num_D=2, n_layers=2, in_nc=5, ndf=8):
    """pix2pixHD's multiscale D keys in one spelling, from reference-format
    modules (attribute 0 the coarsest)."""
    torch.manual_seed(4)
    ds = [NLayerDiscriminatorT(in_nc, ndf=ndf, n_layers=n_layers).eval() for _ in range(num_D)]
    sd = {}
    for i, d in enumerate(ds):
        for n, stage in enumerate(d.stages):
            key = spelling.format(i=i, n=n)
            sd[f"{key}.0.weight"] = stage[0].weight.detach().numpy()
            sd[f"{key}.0.bias"] = stage[0].bias.detach().numpy()
    return ds, sd


def vgg_state_dict(seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for (b, c), idx in pvgg.TORCHVISION_CONV_INDICES.items():
        ci, co = ppr._VGG19_CHANNELS[(b, c)]
        sd[f"features.{idx}.weight"] = (rng.randn(co, ci, 3, 3) * 0.05).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.randn(co).astype(np.float32)
    return sd


@pytest.mark.parametrize("inner", ["block", "conv_block"])
def test_g_npz_equals_jax_tool(tmp_path, monkeypatch, inner):
    _, sd = g_state_dict(3, inner)
    same_arrays(pconv.convert_global_generator(sd, N_DOWN, N_BLOCKS),
                jconv.convert_global_generator(sd, N_DOWN, N_BLOCKS))
    # and through both CLIs, from a .pth file
    pth = str(tmp_path / "net_G.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    flags = ["--pth", pth, "--net", "G", "--n_down", str(N_DOWN), "--n_blocks", str(N_BLOCKS)]
    monkeypatch.setattr(sys, "argv", ["x", *flags, "--out", str(tmp_path / "jax.npz")])
    jconv.main()
    pconv.main([*flags, "--out", str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        same_arrays(dict(a), dict(b))


@pytest.mark.parametrize("spelling", fmt.D_SPELLINGS)
def test_d_npz_equals_jax_tool(spelling):
    _, sd = d_state_dict(spelling)
    got = pconv.convert_multiscale_discriminator(sd, num_D=2, n_layers=2)
    same_arrays(got, jconv.convert_multiscale_discriminator(sd, num_D=2, n_layers=2))
    # the scale order reversed: forward scale 0 is pix2pixHD's last attribute
    np.testing.assert_array_equal(got["D/params/scale0/layer0/bias"],
                                  sd[f"{spelling.format(i=1, n=0)}.0.bias"])


def test_vgg_npz_equals_jax_tool_up_to_prefix(tmp_path):
    sd = vgg_state_dict()
    got = pvgg.convert_vgg19_state_dict(sd)
    want = jvgg.convert_vgg19_state_dict(sd)
    assert all(k.startswith("params/") for k in got)
    same_arrays({k[len("params/"):]: v for k, v in got.items()},
                {k[len("VGG/params/"):]: v for k, v in want.items()})
    # the port's file is the layout its evaluator reads
    np.savez(tmp_path / "vgg.npz", **got)
    vgg = pnet.Vgg19Features()
    load_vgg(str(tmp_path / "vgg.npz"), vgg)
    for (b, c), idx in pvgg.TORCHVISION_CONV_INDICES.items():
        conv = getattr(vgg, f"conv{b}_{c}")
        np.testing.assert_array_equal(conv.weight.detach().numpy(), sd[f"features.{idx}.weight"])
        np.testing.assert_array_equal(conv.bias.detach().numpy(), sd[f"features.{idx}.bias"])


def port_model(label_nc=5):
    """A port mask2image model whose G takes IN_NC channels (the one-hot,
    the edge, the masked RGB)."""
    return create_model(popts.MaskToImageTestOptions(
        gpu_ids="-1", label_nc=label_nc, ngf=NGF, n_downsample_global=N_DOWN,
        n_blocks_global=N_BLOCKS))


def test_port_g_from_pth_matches_reference_and_jax(restore_torch_precision):  # noqa: F811
    t, sd = g_state_dict(5, "conv_block")
    model = port_model()
    # conv_in, the downs, two convs a resblock, the ups, conv_out: a weight
    # and a bias each
    n = pconv.load_pix2pixhd_into(model, {k: torch.from_numpy(v) for k, v in sd.items()}, "G")
    assert n == 2 * (2 + 2 * N_DOWN + 2 * N_BLOCKS)
    x = np.random.RandomState(0).randn(1, IN_NC, 16, 24).astype(np.float32)
    with torch.no_grad():
        got = model.netG(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy().transpose(0, 3, 1, 2)
        ref = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)

    g = jnet.GlobalGenerator(output_nc=3, ngf=NGF, n_downsampling=N_DOWN, n_blocks=N_BLOCKS)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    template = g.init(jax.random.PRNGKey(0), xj)
    flat = jpr._strip_net_prefix(jconv.convert_global_generator(sd, N_DOWN, N_BLOCKS))
    out = np.asarray(g.apply(jpr._load_into(template, flat), xj)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, out, atol=1e-4, rtol=0)


def test_port_d_from_pth_equals_reference_tensors():
    _, sd = d_state_dict(fmt.D_SPELLINGS[1], in_nc=12, ndf=8)
    model = create_model(popts.MaskToImageTrainOptions(
        gpu_ids="-1", label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
        n_layers_D=2, num_D=2))
    assert pconv.load_pix2pixhd_into(model, sd, "D") == 2 * 2 * 4
    got = model.netD.state_dict()
    for i in range(2):
        for n in range(4):
            for leaf in ("weight", "bias"):
                np.testing.assert_array_equal(got[f"scale{i}.layer{n}.{leaf}"].numpy(),
                                              sd[f"layer{1 - i}.model{n}.0.{leaf}"])


def test_load_into_refuses_other_nets():
    with pytest.raises(ValueError, match="net must be G or D"):
        pconv.load_pix2pixhd_into(port_model(), {}, "E")


def test_standins_equal_jax_tool_and_round_trip(tmp_path):
    jpr.make_standins(str(tmp_path / "jax"), input_nc=IN_NC, ngf=NGF, n_down=N_DOWN,
                      n_blocks=N_BLOCKS, seed=7)
    ppr.make_standins(str(tmp_path / "port"), input_nc=IN_NC, ngf=NGF, n_down=N_DOWN,
                      n_blocks=N_BLOCKS, seed=7)
    for name in ("latest_net_G.pth", "vgg19.pth"):
        a, b = (torch.load(tmp_path / d / name, weights_only=True) for d in ("jax", "port"))
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
    # port G -> pix2pixHD keys -> port G, bit for bit
    sd = torch.load(tmp_path / "port" / "latest_net_G.pth", weights_only=True)
    model = port_model()
    pconv.load_pix2pixhd_into(model, sd, "G")
    back = fmt.global_generator_state_dict(model.netG.state_dict(), N_DOWN, N_BLOCKS,
                                           inner="block")
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("spelling", fmt.D_SPELLINGS)
def test_d_inverse_map_round_trips(spelling):
    model = create_model(popts.MaskToImageTrainOptions(
        gpu_ids="-1", label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
        n_layers_D=2, num_D=2))
    torch.manual_seed(11)
    with torch.no_grad():
        for p in model.netD.parameters():
            p.normal_()
    sd = fmt.multiscale_discriminator_state_dict(model.netD.state_dict(), 2, 2, spelling)
    assert sorted(sd) == sorted(f"{spelling.format(i=i, n=n)}.0.{leaf}" for i in range(2)
                                for n in range(4) for leaf in ("weight", "bias"))
    flat = pconv.convert_multiscale_discriminator(pconv.numpy_state_dict(sd), 2, 2)
    back = state_dicts_from_jax(flat)["D"]
    for k, v in model.netD.state_dict().items():
        assert torch.equal(back[k], v), k

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from torch_port_helpers import cuda_device, restore_torch_precision  # noqa: F401

pytestmark = pytest.mark.cuda


def bits_equal(a, b):
    v = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(v), b.view(v))


def encode_inputs(dev, shape=(2, 64, 96), nc=35, seed=0):
    b, h, w = shape
    batch = synthetic_batch(np.random.RandomState(seed), b, hw=(h, w), label_nc=nc)
    batch["label"][0, 0, :3] = [-1, nc, 200]
    batch["image"][1, 0, 0, 0] = -0.0
    batch["boxes"][0] = [0, 0, 5, 7.5]  # a box at the border
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 20, 300)])  # 1 and 3 pixel tiles a row
def test_encode_kernel_bit_exact(cuda_device, dt, pad, shape):
    i = encode_inputs(cuda_device, shape)
    img = i["image"].to(getattr(torch, dt))
    before = kenc.encode.launches
    got = kenc.encode(i["label"], i["inst"], img, i["boxes"], 35, pad=pad)
    assert kenc.encode.launches == before + 1
    want = kenc.encode_plain(i["label"], i["inst"], img, i["boxes"], 35, pad=pad)
    torch.cuda.synchronize()
    assert bits_equal(got, want)


def test_encode_kernel_without_image_or_instance(cuda_device):
    i = encode_inputs(cuda_device, nc=8)
    got = kenc.encode(i["label"], i["inst"], None, None, 8)
    want = kenc.encode_plain(i["label"], i["inst"], None, None, 8)
    assert bits_equal(got, want)
    got = kenc.encode(i["label"], None, i["image"], i["boxes"], 8, pad=3)
    want = kenc.encode_plain(i["label"], None, i["image"], i["boxes"], 8, pad=3)
    torch.cuda.synchronize()
    assert bits_equal(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 96, 64), (1, 8, 16, 1024), (1, 5, 7, 48)])
def test_in_kernel_matches_plain(cuda_device, dt, act, residual, shape):
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(tdt)
    r = torch.randn(shape, generator=g, device=cuda_device).to(tdt) if residual else None
    y, mean, rstd = kin.instance_norm(x, act, r)
    yp, meanp, rstdp = kin.instance_norm_plain(x, act, r)
    torch.cuda.synchronize()
    torch.testing.assert_close(mean, meanp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstdp, atol=1e-5, rtol=1e-5)
    if dt == "float32":
        torch.testing.assert_close(y, yp, atol=1e-4, rtol=0)
    else:  # one rounding of nearly equal fp32 values: at most one bf16 ulp
        torch.testing.assert_close(y.float(), yp.float(), atol=2.0**-7, rtol=2.0**-7)


def test_in_kernel_large_mean(cuda_device):
    """|mean| >> std: the Welford/Chan statistics must not cancel."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((1, 256, 512, 64), generator=g, device=cuda_device) * 0.01 + 300.0
    y, _, rstd = kin.instance_norm(x, "none")
    x64 = x.double()
    m = x64.mean(dim=(1, 2), keepdim=True)
    v = (x64 - m).square().mean(dim=(1, 2))
    # a one-pass fp32 E[x^2] - E[x]^2 loses the 1e-4 variance under the
    # 9e4 mean square entirely; 1% is far tighter than that failure
    torch.testing.assert_close(rstd.double(), 1 / torch.sqrt(v + 1e-5), rtol=1e-2, atol=0)
    got_std = y.double().std(dim=(0, 1, 2), unbiased=False)
    torch.testing.assert_close(got_std, torch.sqrt(v / (v + 1e-5))[0], rtol=1e-2, atol=0)


def test_wrappers_raise_on_bad_cuda_input(cuda_device):
    x = torch.zeros(1, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        kin.instance_norm(x.permute(0, 2, 1, 3), "none")
    i = encode_inputs(cuda_device)
    with pytest.raises(ValueError):
        kenc.encode(i["label"].long(), i["inst"], i["image"], i["boxes"], 35)


def test_model_kernel_path_matches_plain(cuda_device, restore_torch_precision, monkeypatch):
    """A small generator forward through the kernels vs the plain path."""
    opt = MaskToImageTestOptions(gpu_ids="0", label_nc=8, ngf=16, n_downsample_global=2,
                                 n_blocks_global=2)
    model = create_model(opt)
    batch = encode_inputs(cuda_device, shape=(2, 64, 128), nc=8, seed=3)
    e0, i0 = kenc.encode.launches, kin.instance_norm.launches
    out = model.inference(batch)
    assert kenc.encode.launches == e0 + 1
    assert kin.instance_norm.launches == i0 + 1 + 2 * 2 + 2 * 2
    monkeypatch.setattr(kenc, "encode", kenc.encode_plain)
    monkeypatch.setattr(kin, "instance_norm", kin.instance_norm_plain)
    ref = model.inference(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-3

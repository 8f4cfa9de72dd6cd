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
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
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


# the forward's two variants (kernels/instance_norm._fwd_plan): clusters at
# a 64x96 site, the bottleneck and 64x128x256, the first D layer at N 2, a
# tiny one; the split form at 128x256x128 and the stem; channel counts off
# the 16-byte vectors (split, scalar accesses: 3 in both dtypes, 100 in bf16)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 96, 64), (1, 8, 16, 1024), (1, 5, 7, 48),
                                   (1, 16, 32, 1024), (1, 64, 128, 256), (2, 65, 129, 128),
                                   (1, 128, 256, 128), (1, 256, 512, 64), (2, 5, 7, 3),
                                   (1, 9, 11, 100)])
def test_in_kernel_matches_plain(cuda_device, dt, act, residual, shape):
    """Each variant against the plain version, one launch counted per call
    on the variant the plan picks, and the same bits on a second call."""
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(tdt)
    r = torch.randn(shape, generator=g, device=cuda_device).to(tdt) if residual else None
    variant = kin._fwd_plan(*shape, tdt)["variant"]
    before, v0 = kin.instance_norm.launches, dict(kin.instance_norm.variants)
    y, mean, rstd = kin.instance_norm(x, act, r)
    again = kin.instance_norm(x, act, r)
    assert kin.instance_norm.launches == before + 2
    assert {k: n - v0[k] for k, n in kin.instance_norm.variants.items()} == dict(
        {k: 0 for k in v0}, **{variant: 2})
    yp, meanp, rstdp = kin.instance_norm_plain(x, act, r)
    torch.cuda.synchronize()
    for a, b in zip((y, mean, rstd), again):
        assert bits_equal(a, b)  # no atomics: the same bits every run
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


def close_bf16_ok(got, want, dt):
    """fp32: the same sums in another order; bf16: one rounding of nearly
    equal fp32 values, at most one ulp apart."""
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2.0**-7, rtol=2.0**-7)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("residual", [False, True])
# a generator site, two odd discriminator sites, a tiny one; the bottleneck
# (a cluster of 5), a cluster of 16 (fp32), the 256x512x64 split site and a
# channel count off the 16-byte vectors (split, scalar loads)
@pytest.mark.parametrize("shape", [(1, 64, 128, 64), (2, 33, 65, 256), (1, 17, 33, 512),
                                   (1, 5, 7, 48), (1, 16, 32, 1024), (1, 64, 128, 256),
                                   (1, 256, 512, 64), (2, 5, 7, 3)])
def test_in_backward_kernel_matches_plain(cuda_device, dt, act, residual, shape):
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(tdt)
    r = torch.randn(shape, generator=g, device=cuda_device).to(tdt) if residual else None
    gy = torch.randn(shape, generator=g, device=cuda_device).to(tdt)
    y, mean, rstd = kin.instance_norm(x, act, r)
    before = kin.instance_norm_bwd.launches
    variant = kin._bwd_plan(*shape, tdt)["variant"]
    v0 = kin.instance_norm_bwd.variants[variant]
    dx, dres = kin.instance_norm_bwd(x, y, gy, mean, rstd, act, want_dres=residual)
    assert kin.instance_norm_bwd.launches == before + 1
    assert kin.instance_norm_bwd.variants[variant] == v0 + 1
    dxp, dresp = kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, act, want_dres=residual)
    torch.cuda.synchronize()
    close_bf16_ok(dx, dxp, tdt)
    if residual:
        close_bf16_ok(dres, dresp, tdt)
    again, _ = kin.instance_norm_bwd(x, y, gy, mean, rstd, act, want_dres=residual)
    assert torch.equal(again, dx)  # no atomics: the same bits every run


def test_in_autograd_through_kernels_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 16, 32, 128), generator=g, device=cuda_device, requires_grad=True)
    r = torch.randn((2, 16, 32, 128), generator=g, device=cuda_device, requires_grad=True)
    gy = torch.randn((2, 16, 32, 128), generator=g, device=cuda_device)
    grads = []
    for fn in (kin.instance_norm_act, kin.instance_norm_act_plain):
        grads.append(torch.autograd.grad(fn(x, "relu", r), (x, r), gy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# (N, H, W, C), pad, the variant kernels/reflect_pad._plan picks: bulk at
# p 1 (the resblock pads at bs 1 and 32) and p 3 (the head pad, a 64x128
# one), and at h <= 2p (one tile, mirrors overlapping); gather at channel
# counts whose pixels are not 16-byte multiples, at h <= 2p too
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pad,variant", [
    ((1, 16, 32, 1024), 1, "bulk"), ((32, 16, 32, 1024), 1, "bulk"),
    ((1, 256, 512, 64), 3, "bulk"), ((1, 64, 128, 64), 3, "bulk"), ((2, 2, 3, 8), 1, "bulk"),
    ((1, 4, 5, 16), 3, "bulk"), ((1, 5, 7, 3), 1, "gather"), ((1, 4, 5, 3), 3, "gather"),
    ((2, 6, 9, 6), 1, "gather")])
def test_reflect_pad_backward_kernel_matches_plain(cuda_device, dt, shape, pad, variant):
    """Each variant against the plain version, its launches counted per
    variant, and the same bits on a second call."""
    tdt = getattr(torch, dt)
    n, h, w, c = shape
    assert krp._plan(n, h, w, c, pad, tdt)["variant"] == variant
    g = torch.Generator(device=cuda_device).manual_seed(4)
    dy = torch.randn((n, h + 2 * pad, w + 2 * pad, c), generator=g, device=cuda_device).to(tdt)
    before, v0 = krp.reflect_pad_bwd.launches, dict(krp.reflect_pad_bwd.variants)
    dx = krp.reflect_pad_bwd(dy, pad)
    again = krp.reflect_pad_bwd(dy, pad)
    assert krp.reflect_pad_bwd.launches == before + 2
    assert {k: m - v0[k] for k, m in krp.reflect_pad_bwd.variants.items()} == dict(
        {k: 0 for k in v0}, **{variant: 2})
    want = krp.reflect_pad_bwd_plain(dy, pad)
    torch.cuda.synchronize()
    assert bits_equal(dx, again)
    close_bf16_ok(dx, want, tdt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2345, 300_001, 8_388_608])
def test_loss_kernels_match_plain(cuda_device, dt, n):
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    a = torch.randn(n, generator=g, device=cuda_device).to(tdt)
    b = torch.randn(n, generator=g, device=cuda_device).to(tdt)
    m0, l0 = klosses.mse_to_scalar.launches, klosses.l1_to_scalar.launches
    mse = klosses.mse_to_scalar(a, 1.0)
    l1 = klosses.l1_to_scalar(a, b)
    assert (klosses.mse_to_scalar.launches, klosses.l1_to_scalar.launches) == (m0 + 1, l0 + 1)
    torch.testing.assert_close(mse, klosses.mse_to_scalar_plain(a, 1.0), rtol=1e-5, atol=0)
    torch.testing.assert_close(l1, klosses.l1_to_scalar_plain(a, b), rtol=1e-5, atol=0)
    assert torch.equal(klosses.l1_to_scalar(a, b), l1)  # deterministic


def test_loss_backward_on_card(cuda_device):
    a = torch.randn(1000, device=cuda_device, requires_grad=True)
    b = torch.randn(1000, device=cuda_device)
    (klosses.mse_to_scalar(a, 0.0) + klosses.l1_to_scalar(a, b)).backward()
    want = 2 * a.detach() / 1000 + torch.sign(a.detach() - b) / 1000
    torch.testing.assert_close(a.grad, want)


def test_encode_cond_counts_apart(cuda_device):
    i = encode_inputs(cuda_device, nc=8)
    e0, c0 = kenc.encode.launches, kenc.encode_cond.launches
    got = kenc.encode_cond(i["label"], i["inst"], 8)
    assert (kenc.encode.launches, kenc.encode_cond.launches) == (e0, c0 + 1)
    torch.cuda.synchronize()
    assert bits_equal(got, kenc.encode_cond_plain(i["label"], i["inst"], 8))


def test_train_step_kernel_path_matches_plain(cuda_device, restore_torch_precision, monkeypatch):
    """A small G+D+VGG step: every training kernel launches, and the loss
    terms and gradients agree with the plain path."""
    opt = MaskToImageTrainOptions(gpu_ids="0", label_nc=8, ngf=16, ndf=16,
                                  n_downsample_global=2, n_blocks_global=2)
    model = create_model(opt)
    batch = encode_inputs(cuda_device, shape=(2, 64, 128), nc=8, seed=6)
    counters = [kin.instance_norm_bwd, klosses.mse_to_scalar, klosses.l1_to_scalar,
                krp.reflect_pad_bwd, kenc.encode_cond]
    before = [c.launches for c in counters]
    total, metrics, _ = model.losses(batch)
    total.backward()
    # IN bwd: G 1 + 2*2 + 2*2 sites, D 2 applies x 2 scales x 3 sites;
    # 6 MSE; FM 2 scales x 4 layers + 5 VGG taps; 2*2 resblock pads + head
    assert [c.launches - b for c, b in zip(counters, before)] == [9 + 12, 6, 13, 5, 1]
    params = [p for m in (model.netG, model.netD) for p in m.parameters()]
    got = [p.grad.clone() if p.grad is not None else None for p in params]
    for p in params:
        p.grad = None
    for mod, name, plain in ((kenc, "encode", kenc.encode_plain),
                             (kenc, "encode_cond", kenc.encode_cond_plain),
                             (kin, "instance_norm_act", kin.instance_norm_act_plain),
                             (klosses, "mse_to_scalar", klosses.mse_to_scalar_plain),
                             (klosses, "l1_to_scalar", klosses.l1_to_scalar_plain),
                             (krp, "reflect_pad", krp.reflect_pad_plain)):
        monkeypatch.setattr(mod, name, plain)
    total_p, metrics_p, _ = model.losses(batch)
    total_p.backward()
    for k in metrics:
        torch.testing.assert_close(metrics[k], metrics_p[k], rtol=1e-4, atol=0)
    for a, p in zip(got, params):
        if a is None:
            assert p.grad is None
            continue
        assert (a - p.grad).abs().max() <= 1e-3 * p.grad.abs().max()


def two_bf16_ulps(got, want):
    """|got - want| within two bf16 ulps of max(|want|, 1)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1.0))) - 7)
    return bool(((got.float() - want.float()).abs() <= 2 * ulp).all())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu,residual", [(True, False), (False, True), (False, False)])
# the JAX test shape, an odd shape, 4x4 (Cout 24), channel counts that are
# not multiples of 8 (no 16-byte loads), the bottleneck; the wgmma kernel
# (kernels/conv_in._plan): bs 4 (a 4-block cluster), 9x17 with Cin 96 (a
# 2-block cluster, H*W and Cin off the tile), 32x48 (16 tiles: the two-launch
# epilogue), a row wider than a tile (300 columns), the roofline shape
@pytest.mark.parametrize("shape", [(2, 8, 16, 128, 128), (2, 9, 17, 96, 40),
                                   (1, 4, 4, 8, 24), (1, 5, 7, 12, 20),
                                   (1, 16, 32, 1024, 1024), (4, 16, 32, 1024, 1024),
                                   (64, 9, 17, 96, 40), (16, 32, 48, 64, 64),
                                   (4, 6, 300, 64, 64), (32, 16, 32, 1024, 1024)])
def test_conv_in_kernel_matches_plain(cuda_device, restore_torch_precision, dt, relu,
                                      residual, shape):
    torch.backends.cudnn.allow_tf32 = False  # the plain conv in full fp32
    tdt = getattr(torch, dt)
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((n, h, w, cin), generator=g, device=cuda_device) * 0.5).to(tdt)
    w3 = (torch.randn((3, 3, cin, cout), generator=g, device=cuda_device)
          * (1.0 / (9 * cin) ** 0.5)).to(tdt)
    b = torch.randn((cout,), generator=g, device=cuda_device).to(tdt)
    r = torch.randn((n, h, w, cout), generator=g, device=cuda_device).to(tdt) if residual else None
    before = kconv.conv3x3_in_act.launches
    variant = kconv._plan(*shape, tdt)["variant"]
    v0 = kconv.conv3x3_in_act.variants[variant]
    with torch.no_grad():
        y = kconv.conv3x3_in_act(x, w3, b, relu=relu, residual=r)
        again = kconv.conv3x3_in_act(x, w3, b, relu=relu, residual=r)
        want = kconv.conv3x3_in_act_plain(x, w3, b, relu=relu, residual=r)
        torch.cuda.synchronize()
    assert kconv.conv3x3_in_act.launches == before + 2
    assert kconv.conv3x3_in_act.variants[variant] == v0 + 2
    assert bits_equal(y, again)  # no atomics: the same bits every run
    if dt == "float32":
        torch.testing.assert_close(y, want, atol=3e-5, rtol=1e-4)
    else:
        # the plain version in bf16 (the JAX _reference) rounds the pre-norm
        # conv to bf16 before the statistics, which the kernel, like the TPU
        # kernel, never does; so the kernel is held to the plain version on
        # the fp32 values of the same bf16 inputs, rounded once
        f = [t.float() if t is not None else None for t in (x, w3, b, r)]
        want = kconv.conv3x3_in_act_plain(f[0], f[1], f[2], relu=relu, residual=f[3])
        assert two_bf16_ulps(y, want.to(tdt)), (y.float() - want).abs().max()


def test_conv_in_gradient_matches_plain(cuda_device, restore_torch_precision):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(8)
    shape = (2, 9, 17, 64)
    x = torch.randn(shape, generator=g, device=cuda_device, requires_grad=True)
    w3 = (torch.randn((3, 3, 64, 64), generator=g, device=cuda_device) * 0.05).requires_grad_()
    b = torch.randn((64,), generator=g, device=cuda_device, requires_grad=True)
    r = torch.randn(shape, generator=g, device=cuda_device, requires_grad=True)
    gy = torch.randn(shape, generator=g, device=cuda_device)
    grads = []
    for fn in (kconv.conv3x3_in_act, kconv.conv3x3_in_act_plain):
        y = fn(x, w3, b, relu=True, residual=r)
        grads.append(torch.autograd.grad(y, (x, w3, b, r), gy))
    for a, p in zip(*grads):
        torch.testing.assert_close(a, p, atol=1e-4, rtol=1e-4)

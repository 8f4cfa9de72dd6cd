"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTrainOptions,
    MaskToImageTestOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (
    synthetic_batch,
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
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


# the IN sites no other path runs: the 1024p LocalEnhancer's full-resolution
# branch at 32 channels (bs 1 fp32; bs 4 bf16: 4 channel tiles of the split
# form), the Encoder's 16-channel stem at a 512x1024 scene (half a 32-channel
# tile), and its bottleneck-side 256 channels at 32x64
@pytest.mark.parametrize("shape,dt", [((1, 512, 1024, 32), "float32"),
                                      ((4, 512, 1024, 32), "bfloat16"),
                                      ((1, 512, 1024, 16), "float32"),
                                      ((1, 32, 64, 256), "float32")])
@pytest.mark.parametrize("act,residual", [("relu", False), ("none", True)])
def test_in_kernels_at_1024p_and_encoder_sites(cuda_device, shape, dt, act, residual):
    """The forward and the backward at these shapes, each on its planned
    variant, against the plain version, the same bits twice."""
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(tdt)
    r = torch.randn(shape, generator=g, device=cuda_device).to(tdt) if residual else None
    gy = torch.randn(shape, generator=g, device=cuda_device).to(tdt)
    fv, bv = kin._fwd_plan(*shape, tdt)["variant"], kin._bwd_plan(*shape, tdt)["variant"]
    f0, b0 = dict(kin.instance_norm.variants), dict(kin.instance_norm_bwd.variants)
    y, mean, rstd = kin.instance_norm(x, act, r)
    again = kin.instance_norm(x, act, r)
    dx, dres = kin.instance_norm_bwd(x, y, gy, mean, rstd, act, want_dres=residual)
    dx2, _ = kin.instance_norm_bwd(x, y, gy, mean, rstd, act, want_dres=residual)
    assert {k: n - f0[k] for k, n in kin.instance_norm.variants.items()} == dict(
        {k: 0 for k in f0}, **{fv: 2})
    assert {k: n - b0[k] for k, n in kin.instance_norm_bwd.variants.items()} == dict(
        {k: 0 for k in b0}, **{bv: 2})
    yp, meanp, rstdp = kin.instance_norm_plain(x, act, r)
    dxp, dresp = kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, act, want_dres=residual)
    torch.cuda.synchronize()
    for a, b in zip((y, mean, rstd, dx), (*again, dx2)):
        assert bits_equal(a, b)
    torch.testing.assert_close(mean, meanp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstdp, atol=1e-5, rtol=1e-5)
    if dt == "float32":
        torch.testing.assert_close(y, yp, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(y.float(), yp.float(), atol=2.0**-7, rtol=2.0**-7)
    close_bf16_ok(dx, dxp, tdt)
    if residual:    # act 'none': the residual's gradient is the cotangent itself
        assert bits_equal(dres, dresp)


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
    ((2, 6, 9, 6), 1, "gather"),
    # the instance-feature path: the GlobalGenerator stem's 35 + 1 + 3 + 3
    # channels (their input takes the Encoder's gradient), the Encoder's head
    ((1, 512, 512, 42), 3, "gather"), ((1, 512, 512, 16), 3, "bulk")])
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


LOSS_RTOL = 1e-5  # one fp32 sum of up to 8.4M terms, in another order


def loss_terms(dev, tdt, seed):
    """Mixed sizes (one element, a D logit, an n not a multiple of 8, a
    VGG tap) in both modes, with scalar and tensor targets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    terms = []
    for k, n in enumerate((1, 2345, 300_001, 8_388_608, 77)):
        a = torch.randn(n, generator=g, device=dev).to(tdt)
        b = torch.randn(n, generator=g, device=dev).to(tdt)
        terms.append(("mse", a, float(k % 2)) if k % 2 == 0 else ("l1", a, b))
        terms.append(("l1", b, 0.5) if k % 2 == 0 else ("mse", b, a))
    return terms


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_group_bits_alone_grouped_and_again(cuda_device, dt):
    terms = loss_terms(cuda_device, getattr(torch, dt), 9)
    m0, l0 = klosses.mse_to_scalar.launches, klosses.l1_to_scalar.launches
    g0 = (klosses.mse_to_scalar.variants["group"], klosses.l1_to_scalar.variants["group"])
    grouped = klosses.reduce_group(terms)
    assert (klosses.mse_to_scalar.launches - m0, klosses.l1_to_scalar.launches - l0) == (5, 5)
    assert (klosses.mse_to_scalar.variants["group"] - g0[0],
            klosses.l1_to_scalar.variants["group"] - g0[1]) == (1, 1)
    again = klosses.reduce_group(terms)
    alone = torch.cat([klosses.reduce_group([t]) for t in terms])
    reordered = klosses.reduce_group(terms[::-1]).flip(0)
    plain = klosses.reduce_group_plain(terms)
    torch.cuda.synchronize()
    assert grouped.shape == (len(terms),) and grouped.dtype == torch.float32
    for other in (again, alone, reordered):
        assert bits_equal(grouped, other)
    torch.testing.assert_close(grouped, plain, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_group_misaligned_view_same_bits(cuda_device, dt):
    """A view 1 element off the 16-byte grid takes the kernel's scalar loop
    and gives the bits of an aligned copy."""
    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    # rows 16-byte aligned in both dtypes, each view one element past its row
    buf = torch.randn(2, 100_008, generator=g, device=cuda_device).to(tdt)
    a, b = buf[0, 1:], buf[1, 1:]
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    terms = [("l1", a, b), ("mse", a, 1.0)]
    copies = [("l1", a.clone(), b.clone()), ("mse", a.clone(), 1.0)]
    assert all(t[1].data_ptr() % 16 == 0 for t in copies)
    got, want = klosses.reduce_group(terms), klosses.reduce_group(copies)
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    torch.testing.assert_close(got, klosses.reduce_group_plain(terms), rtol=LOSS_RTOL, atol=0)


def test_loss_group_graph_replays(cuda_device):
    """Captured once in a CUDA graph on the stream of its warm-up, the
    launch gives the eager bits on each of 3 replays; the per-term tickets
    of that stream's workspace are back at 0 after each, and the counters
    counted the one launch that was captured."""
    terms = loss_terms(cuda_device, torch.float32, 4)
    eager = klosses.reduce_group(terms)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        klosses.reduce_group(terms)
    torch.cuda.current_stream().wait_stream(side)
    m0, g0 = klosses.mse_to_scalar.launches, klosses.mse_to_scalar.variants["group"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = klosses.reduce_group(terms)
    assert (klosses.mse_to_scalar.launches - m0,
            klosses.mse_to_scalar.variants["group"] - g0) == (5, 1)
    tickets = klosses._workspace(cuda_device, side.cuda_stream)[:64].view(torch.int32)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert bits_equal(out, eager)
        assert int(tickets.abs().sum()) == 0
    assert klosses.mse_to_scalar.launches - m0 == 5


def test_loss_group_workspace_per_stream(cuda_device):
    """A launch on a second stream takes that stream's own tickets and
    partials, and gives the bits of the first stream's launch."""
    terms = loss_terms(cuda_device, torch.float32, 4)
    want = klosses.reduce_group(terms)
    cur, other = torch.cuda.current_stream(), torch.cuda.Stream()
    other.wait_stream(cur)
    with torch.cuda.stream(other):
        got = klosses.reduce_group(terms)
    cur.wait_stream(other)
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert (klosses._workspace(cuda_device, other.cuda_stream).data_ptr()
            != klosses._workspace(cuda_device, cur.cuda_stream).data_ptr())


@pytest.mark.parametrize("terms", [[], "mixed", "seventeen"])
def test_loss_group_rejects_bad_tables_on_card(cuda_device, terms):
    a = torch.randn(10, device=cuda_device)
    if terms == "mixed":
        terms = [("l1", a, a), ("l1", a.bfloat16(), a.bfloat16())]
    elif terms == "seventeen":
        terms = [("mse", a, 0.0)] * 17
    with pytest.raises(ValueError):
        klosses.reduce_group(terms)


def test_encode_cond_counts_apart(cuda_device):
    i = encode_inputs(cuda_device, nc=8)
    e0, c0 = kenc.encode.launches, kenc.encode_cond.launches
    got = kenc.encode_cond(i["label"], i["inst"], 8)
    assert (kenc.encode.launches, kenc.encode_cond.launches) == (e0, c0 + 1)
    torch.cuda.synchronize()
    assert bits_equal(got, kenc.encode_cond_plain(i["label"], i["inst"], 8))


# the whole step, kernel path against plain path, as chip_smoke.compare_step
# holds it: losses to STEP_LOSS_RTOL; the kernel path run twice to
# STEP_GRAD_TOL of each leaf's max |g|; the whole-path gradient difference
# to STEP_SENS_FACTOR times the step's own 1-ulp sensitivity
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_SENS_FACTOR = 1e-4, 1e-4, 2.0


def grad_diff(a, b):
    """Worst leaf of |a - b| as max|diff| / max|b| and as ||diff|| / ||b||
    (chip_smoke._grad_diff)."""
    mx = nr = 0.0
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is None:
            continue
        d = (x - y).double()
        mx = max(mx, (d.abs().max() / y.abs().max().clamp_min(1e-30)).item())
        nr = max(nr, (d.norm() / y.double().norm().clamp_min(1e-30)).item())
    return mx, nr


def check_step_kernel_path(model, batch, launches, groups=(2, 2), nudges=("image",)):
    """One step of ``model`` on ``batch``: the training kernels' launches
    (IN backward, MSE terms, L1 terms, reflect-pad backward, encode_cond)
    and the loss groups as given, and the loss terms and gradients against
    the plain path. cuDNN deterministic and TF32 off, so that repeated runs
    give the same bits; the gradient of a randomly initialized GAN step
    amplifies last-ulp differences of its forward, so the whole-path
    difference is held to twice the change a 1-ulp nudge of the input image
    makes, measured on both paths ("params" in ``nudges``: also the change
    a 1-ulp nudge of every trained parameter makes, the larger counting).
    The gradients are G's, D's and, under instance features, E's -> the
    kernel path's gradients."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    bumped = dict(batch)
    bumped["image"] = torch.nextafter(batch["image"], torch.full_like(batch["image"], 2.0))
    params = [p for net, m in model.nets().items() if net != "VGG" for p in m.parameters()]

    def plain_path():
        stack = contextlib.ExitStack()
        for mod, name, plain in ((kenc, "encode", kenc.encode_plain),
                                 (kenc, "encode_cond", kenc.encode_cond_plain),
                                 (kin, "instance_norm_act", kin.instance_norm_act_plain),
                                 (klosses, "reduce_group", klosses.reduce_group_plain),
                                 (krp, "reflect_pad", krp.reflect_pad_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        return stack

    def run(b, ctx):
        for p in params:
            p.grad = None
        with ctx:
            total, metrics, _ = model.losses(b)
            total.backward()
        return metrics, [p.grad.clone() if p.grad is not None else None for p in params]

    def params_nudged(ctx):
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p in params:
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        try:
            return run(batch, ctx)[1]
        finally:
            with torch.no_grad():
                for p, v in zip(params, saved):
                    p.copy_(v)

    counters = [kin.instance_norm_bwd, klosses.mse_to_scalar, klosses.l1_to_scalar,
                krp.reflect_pad_bwd, kenc.encode_cond]
    before = [c.launches for c in counters]
    groups0 = [klosses.mse_to_scalar.variants["group"], klosses.l1_to_scalar.variants["group"]]
    mk, gk = run(batch, contextlib.nullcontext())
    assert [c.launches - b for c, b in zip(counters, before)] == list(launches)
    assert [klosses.mse_to_scalar.variants["group"] - groups0[0],
            klosses.l1_to_scalar.variants["group"] - groups0[1]] == list(groups)
    mid = [c.launches for c in counters]
    mp, gp = run(batch, plain_path())
    assert [c.launches for c in counters] == mid  # the plain path launches nothing
    _, again = run(batch, contextlib.nullcontext())
    _, gk_nudged = run(bumped, contextlib.nullcontext())
    _, gp_nudged = run(bumped, plain_path())
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], rtol=STEP_LOSS_RTOL, atol=0)
    assert grad_diff(again, gk)[0] <= STEP_GRAD_TOL
    whole = grad_diff(gk, gp)
    sens = [max(a, b) for a, b in zip(grad_diff(gk_nudged, gk), grad_diff(gp_nudged, gp))]
    if "params" in nudges:
        sens = [max(a, b, c) for a, b, c in zip(
            sens, grad_diff(params_nudged(contextlib.nullcontext()), gk),
            grad_diff(params_nudged(plain_path()), gp))]
    assert whole[0] <= STEP_SENS_FACTOR * sens[0] and whole[1] <= STEP_SENS_FACTOR * sens[1], (
        whole, sens)
    return gk


def test_train_step_kernel_path_matches_plain(cuda_device, restore_torch_precision):
    """A small G+D+VGG step: every training kernel launches as often as the
    architecture gives (each loss one group launch), and the loss terms and
    gradients agree with the plain path (check_step_kernel_path)."""
    opt = MaskToImageTrainOptions(gpu_ids="0", label_nc=8, ngf=16, ndf=16,
                                  n_downsample_global=2, n_blocks_global=2)
    model = create_model(opt)
    batch = encode_inputs(cuda_device, shape=(2, 64, 128), nc=8, seed=6)
    # IN bwd: G 1 + 2*2 + 2*2 sites, D 2 applies x 2 scales x 3 sites;
    # 6 MSE; FM 2 scales x 4 layers + 5 VGG taps; 2*2 resblock pads + head
    check_step_kernel_path(model, batch, [9 + 12, 6, 13, 5, 1])


def test_local_enhancer_step_kernel_path_matches_plain(cuda_device, restore_torch_precision):
    """The same for a small LocalEnhancer (the 1024p recipe's one enhancer,
    a 3-scale D): its unpadded input takes the pad-0 encode."""
    opt = MaskToImageTrainOptions(gpu_ids="0", label_nc=8, ngf=8, ndf=16, netG="local",
                                  n_downsample_global=2, n_blocks_global=2,
                                  n_local_enhancers=1, n_blocks_local=1, num_D=3)
    model = create_model(opt)
    assert isinstance(model.netG, networks.LocalEnhancer)
    batch = encode_inputs(cuda_device, shape=(2, 64, 128), nc=8, seed=7)
    pad0 = kenc.encode.variants["pad0"]
    # IN bwd: the trunk's 1 + 2*2 + 2*2 and the branch's 3 + 2 sites, D 2
    # applies x 3 scales x 3 sites; 9 MSE; FM 3 scales x 4 layers + 5 VGG
    # taps; the trunk's 2*2 and the branch's 2 resblock pads + head
    check_step_kernel_path(model, batch, [14 + 18, 9, 17, 7, 1])
    assert kenc.encode.variants["pad0"] - pad0 == 3    # one a kernel-path run


def test_instance_feat_step_kernel_path_matches_plain(cuda_device, restore_torch_precision):
    """The same for a small --instance_feat model: E's gradients are among
    those held to the plain path, and reach it through the generator stem's
    42-channel pad (one-hot 35 + edge + RGB + 3 features), whose backward
    takes the gather variant. The sensitivity counts the parameter nudge
    too: the kernel and plain paths differ by an ulp or so at every IN
    site, and with the Encoder those differences reach G through E as
    well, which a nudge of the input image alone underestimates here."""
    opt = MaskToImageTrainOptions(gpu_ids="0", ngf=16, ndf=16, n_downsample_global=2,
                                  n_blocks_global=2, instance_feat=True, feat_num=3, nef=8,
                                  n_downsample_E=2)
    model = create_model(opt)
    batch = encode_inputs(cuda_device, shape=(2, 64, 128), nc=35, seed=8)
    gather = krp.reflect_pad_bwd.variants["gather"]
    # IN bwd: G 1 + 2*2 + 2*2 and E 1 + 2*2 sites, D 2 applies x 2 scales x
    # 3 sites; 6 MSE; FM 2 scales x 4 layers + 5 VGG taps; G's 2*2 resblock
    # pads, its head and its stem, E's head
    grads = check_step_kernel_path(model, batch, [9 + 5 + 12, 6, 13, 7, 1],
                                   nudges=("image", "params"))
    assert krp.reflect_pad_bwd.variants["gather"] - gather >= 3   # the stem's, each run
    e_grads = grads[-len(list(model.netE.parameters())):]     # E comes last in nets()
    assert any(g is not None and bool(g.abs().max() > 0) for g in e_grads)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_segment_mean_2d_same_bits_on_card(cuda_device, dt):
    """nnops.segment_mean_2d on a CUDA tensor, over segments of up to 20000
    pixels: the forward and its gradient the same bits twice; the fp32 ones
    against the fp64 segment mean."""
    from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops

    tdt = getattr(torch, dt)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    seg = torch.randint(0, 12, (2, 128, 256), generator=g, device=cuda_device)
    seg[1, :80] = 3
    feat = (torch.rand((2, 128, 256, 3), generator=g, device=cuda_device) * 2 - 1).to(tdt)
    gy = torch.randn((2, 128, 256, 3), generator=g, device=cuda_device).to(tdt)

    def run():
        x = feat.clone().requires_grad_(True)
        out = nnops.segment_mean_2d(x, seg, 16)
        out.backward(gy)
        return out.detach(), x.grad

    (out, grad), (out2, grad2) = run(), run()
    assert bits_equal(out, out2) and bits_equal(grad, grad2)
    if dt == "float32":
        ids = (seg + 16 * torch.arange(2, device=cuda_device)[:, None, None]).reshape(-1)
        counts = torch.bincount(ids, minlength=32).double().clamp_min(1.0)[:, None]
        for got, v in ((out, feat), (grad, gy)):
            sums = torch.zeros((32, 3), dtype=torch.float64, device=cuda_device)
            want = (sums.index_add_(0, ids, v.double().reshape(-1, 3)) / counts)[ids]
            torch.testing.assert_close(got.double().reshape(-1, 3), want, rtol=0, atol=1e-6)


def test_box2mask_step_kernel_path_matches_plain(cuda_device, restore_torch_precision):
    """A small box2mask step (two-stream G, 2-layer layout D, a background
    box in the batch): every training kernel launches as often as the
    architecture gives, and the loss terms and gradients agree with the
    plain path, calibrated as chip_smoke.compare_step is, the 1-ulp nudge on
    every G and D parameter (the inputs are one-hot maps and 0/1 masks)."""
    opt = BoxToMaskTrainOptions(gpu_ids="0", label_nc=8, ngf=16, ndf=16, n_downsample_global=2,
                                n_blocks_global=2, n_layers_D=2, fineSize=32, lambda_ctx_neg=5.0)
    model = create_model(opt)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_box2mask_batch(np.random.RandomState(7), 2, size=32, label_nc=8)
    batch["cls"][0], batch["gt_objmask"][0] = -1, 0.0
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    params = [p for net, m in model.nets().items() if net != "VGG" for p in m.parameters()]

    def plain_path():
        stack = contextlib.ExitStack()
        for mod, name, plain in ((kin, "instance_norm_act", kin.instance_norm_act_plain),
                                 (klosses, "reduce_group", klosses.reduce_group_plain),
                                 (krp, "reflect_pad", krp.reflect_pad_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        return stack

    def run(ctx, nudge=False):
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p in params:
                p.grad = None
                if nudge:
                    p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        with ctx:
            total, metrics, _ = model.losses(batch)
            total.backward()
        grads = [p.grad.clone() if p.grad is not None else None for p in params]
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
        return metrics, grads

    counters = [kin.instance_norm, kin.instance_norm_bwd, klosses.mse_to_scalar,
                klosses.l1_to_scalar, krp.reflect_pad_bwd, kenc.encode, kenc.encode_cond]
    before = [c.launches for c in counters]
    groups = klosses.mse_to_scalar.variants["group"]
    mk, gk = run(contextlib.nullcontext())
    # IN: G 2 + 3*2 + 2*2 sites, D 2 applies x 2 sites, forward and backward;
    # 3 MSE terms in 2 launches; 2*2 resblock pads + the two 7x7 heads
    assert [c.launches - b for c, b in zip(counters, before)] == [16, 16, 3, 0, 6, 0, 0]
    assert klosses.mse_to_scalar.variants["group"] - groups == 2
    mid = [c.launches for c in counters]
    mp, gp = run(plain_path())
    assert [c.launches for c in counters] == mid  # the plain path launches nothing
    _, again = run(contextlib.nullcontext())
    _, gk_nudged = run(contextlib.nullcontext(), nudge=True)
    _, gp_nudged = run(plain_path(), nudge=True)
    assert set(mk) == {"G_GAN", "G_recon", "G_obj", "G_ctxneg", "D_real", "D_fake"}
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], rtol=STEP_LOSS_RTOL, atol=0)
    assert grad_diff(again, gk)[0] <= STEP_GRAD_TOL
    whole = grad_diff(gk, gp)
    sens = [max(a, b) for a, b in zip(grad_diff(gk_nudged, gk), grad_diff(gp_nudged, gp))]
    assert whole[0] <= STEP_SENS_FACTOR * sens[0] and whole[1] <= STEP_SENS_FACTOR * sens[1], (
        whole, sens)
    return gk


@pytest.mark.parametrize("stacked", [1, 2])
def test_layout_discriminator_batch_one_on_card(cuda_device, stacked):
    """The layout D at B = 1 with the layout stacked k times over one
    conditioning: k non-empty logit maps, each the D of its own layout."""
    d = networks.LayoutDiscriminator(8, ndf=16, n_layers=2, get_interm_feat=False)
    d.reset_parameters(torch.Generator().manual_seed(0))
    d.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    layout = torch.rand((stacked, 32, 32, 8), generator=g, device=cuda_device)
    boxmask = (torch.rand((1, 32, 32, 1), generator=g, device=cuda_device) > 0.5).float()
    cls = torch.zeros((1, 8), device=cuda_device)
    cls[0, 3] = 1.0
    with torch.no_grad():
        (out,) = d(layout, boxmask, cls)
        alone = torch.cat([d(layout[i : i + 1], boxmask, cls)[0] for i in range(stacked)])
    torch.cuda.synchronize()
    assert out.shape == (stacked, 11, 11, 1) and out.numel() > 0
    torch.testing.assert_close(out, alone, rtol=1e-5, atol=1e-5)


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
# epilogue), a row wider than a tile (300 columns), the roofline shape; the
# fp32 kernel's 4-byte copies (Cin 7, Cout 10)
@pytest.mark.parametrize("shape", [(2, 8, 16, 128, 128), (2, 9, 17, 96, 40),
                                   (1, 4, 4, 8, 24), (1, 5, 7, 12, 20),
                                   (1, 16, 32, 1024, 1024), (4, 16, 32, 1024, 1024),
                                   (64, 9, 17, 96, 40), (16, 32, 48, 64, 64),
                                   (4, 6, 300, 64, 64), (32, 16, 32, 1024, 1024),
                                   (1, 6, 9, 7, 10)])
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


def test_conv_in_fp32_split_k_at_bs1(cuda_device, restore_torch_precision):
    """The bs-1 bottleneck in fp32: the plan's K split of 8 (128 blocks;
    the splits' sums and the statistics are two more launches),
    one call counted as one "fma" call, the same bits twice, and within
    3e-5 + 1e-4 |y| of the plain version."""
    torch.backends.cudnn.allow_tf32 = False
    plan = kconv._plan(1, 16, 32, 1024, 1024, torch.float32)
    assert (plan["variant"], plan["k_split"], plan["cluster"], plan["launches"]) == (
        "fma", 8, 1, 3)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn((1, 16, 32, 1024), generator=g, device=cuda_device) * 0.5
    w3 = torch.randn((3, 3, 1024, 1024), generator=g, device=cuda_device) / 96
    b = torch.randn((1024,), generator=g, device=cuda_device)
    v0 = dict(kconv.conv3x3_in_act.variants)
    with torch.no_grad():
        y = kconv.conv3x3_in_act(x, w3, b, relu=True)
        again = kconv.conv3x3_in_act(x, w3, b, relu=True)
        want = kconv.conv3x3_in_act_plain(x, w3, b, relu=True)
    torch.cuda.synchronize()
    assert kconv.conv3x3_in_act.variants == dict(v0, fma=v0["fma"] + 2)
    assert bits_equal(y, again)
    torch.testing.assert_close(y, want, atol=3e-5, rtol=1e-4)


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


def test_two_step_kernel_path_matches_plain(cuda_device, restore_torch_precision, monkeypatch):
    """The two-step pipeline at a small width, add / remove / swap, through
    the kernels (each edit: the two generators' IN sites, 1 encode at pad
    3) against the plain path: the integer maps equal (the seeded scene's
    fills have no near-tie: top two probabilities at least 1e-5 apart), the
    images within 1e-3, outside the box the input passed through exactly,
    and the same bits on a second run (cuDNN deterministic)."""
    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
        BoxToMaskTestOptions,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.eval.two_step import TwoStepPipeline
    from neurips18_hierchical_image_manipulation_tpu_torch.ops import boxcomposite

    arch = dict(gpu_ids="0", label_nc=8, ngf=16, n_downsample_global=2, n_blocks_global=1)
    b2m = create_model(BoxToMaskTestOptions(fineSize=32, **arch))
    m2i = create_model(MaskToImageTestOptions(fineSize=64, **arch))
    pipe = TwoStepPipeline(b2m, m2i)
    scene = synthetic_batch(np.random.RandomState(7), 1, hw=(96, 160), label_nc=8)
    image, label, inst = (torch.from_numpy(scene[k]).to(cuda_device)
                          for k in ("image", "label", "inst"))
    old = torch.tensor([[20.0, 30.0, 30.0, 40.0]], device=cuda_device)
    new = torch.tensor([[40.5, 90.25, 26.0, 33.5]], device=cuda_device)
    cls = torch.tensor([6], dtype=torch.int32, device=cuda_device)
    edits = {"add": (lambda: pipe.add_object(image, label, inst, new, cls), [new]),
             "remove": (lambda: pipe.remove_object(image, label, inst, old), [old]),
             "swap": (lambda: pipe.swap_object(image, label, inst, old, new, cls), [old, new])}
    per_edit = (2 + 3 * 2 + 2 * 1) + (1 + 2 * 2 + 2 * 1)
    fills = []
    orig = b2m.inference

    def spy(batch, return_ctx=False):
        merged, obj, ctx = orig(batch, return_ctx=True)
        fills.append(torch.where(batch["cls"][:, None, None, None] < 0, ctx, merged))
        return merged, obj, ctx

    monkeypatch.setattr(b2m, "inference", spy)
    # the same bits twice with cuDNN's deterministic algorithms (its
    # transposed-conv algorithms may otherwise sum in another order)
    torch.backends.cudnn.deterministic = True
    got = {}
    for name, (run, boxes) in edits.items():
        e0, i0 = kenc.encode.launches, kin.instance_norm.launches
        out, again = run(), run()
        assert kenc.encode.launches - e0 == 2 * len(boxes)
        assert kin.instance_norm.launches - i0 == 2 * len(boxes) * per_edit
        for k, v in out.items():
            assert bits_equal(v.float(), again[k].float()), (name, k)
        got[name] = out
    with monkeypatch.context() as m:
        m.setattr(kenc, "encode", kenc.encode_plain)
        m.setattr(kin, "instance_norm", kin.instance_norm_plain)
        fills.clear()
        want = {name: run() for name, (run, _) in edits.items()}
    torch.cuda.synchronize()
    for f in fills:
        top2 = f.topk(2, dim=-1).values
        assert ((top2[..., 0] - top2[..., 1]) >= 1e-5).all()
    for name, (_, boxes) in edits.items():
        out, ref = got[name], want[name]
        for k in ("completed_label", "edited_inst", "window_layout", "window_inst", "windows"):
            assert torch.equal(out[k], ref[k]), (name, k)
        for k in ("edited_image", "window_rgb", "object_mask"):
            assert torch.isfinite(out[k]).all()
            assert (out[k] - ref[k]).abs().max().item() <= 1e-3, (name, k)
        inside = sum(boxcomposite.box_mask(b, label.shape[1:3])[..., 0] for b in boxes) > 0
        assert torch.equal(out["edited_image"][~inside], image[~inside])
        assert torch.equal(out["completed_label"][~inside], label[~inside])


def test_resident_draws_on_card_within_their_laws(cuda_device):
    """The fused resident step's draws on the card: crop corners in range
    and covering it, a fair coin, the same draws from the same (seed, step),
    an epoch's permutation a permutation, and no host copy needed."""
    from neurips18_hierchical_image_manipulation_tpu_torch.data import device_resident as pdr
    from neurips18_hierchical_image_manipulation_tpu_torch.train import steps

    def draws(step):
        g = steps.seeded_generator(cuda_device, 3, steps._SAMPLE_TAG, step)
        return pdr.sample_draws(20000, (256, 512), 128, True, True, g, cuda_device)

    ys, xs, coin = draws(7)
    assert ys.device.type == "cuda" and ys.is_cuda and coin.is_cuda
    assert int(ys.min()) == 0 and int(ys.max()) == 128
    assert int(xs.min()) == 0 and int(xs.max()) == 384
    assert abs(float(coin.float().mean()) - 0.5) < 5 * 0.5 / np.sqrt(20000)
    again = draws(7)
    assert all(torch.equal(a, b) for a, b in zip((ys, xs, coin), again))
    assert not torch.equal(ys, draws(8)[0])
    g = steps.seeded_generator(cuda_device, 3, steps._SHUFFLE_TAG, 0)
    perm = torch.randperm(2975, generator=g, device=cuda_device)
    assert torch.equal(perm.sort().values, torch.arange(2975, device=cuda_device))
    # the resident gather of a uint16 store through its int16 bits
    store = {"label": torch.randint(0, 35, (4, 64, 96), dtype=torch.uint8, device=cuda_device),
             "inst": torch.randint(-32768, 32767, (4, 64, 96), dtype=torch.int16,
                                   device=cuda_device),
             "image": torch.randint(0, 256, (4, 64, 96, 3), dtype=torch.uint8,
                                    device=cuda_device)}
    idx = torch.tensor([2, 0, 3], device=cuda_device)
    ys, xs, coin = (t[:3] for t in draws(9))
    ys, xs = ys % 33, xs % 33
    out = pdr.sample_batch_impl(store, idx, ys, xs, coin, 32, True, True, as_float=False)
    cpu = pdr.sample_batch_impl({k: v.cpu() for k, v in store.items()}, idx.cpu(), ys.cpu(),
                                xs.cpu(), coin.cpu(), 32, True, True, as_float=False)
    torch.cuda.synchronize()
    assert out["inst"].dtype == torch.uint16
    for k in store:
        assert torch.equal(out[k].cpu().view(torch.uint8), cpu[k].view(torch.uint8)), k


def test_prefetch_path_bit_equal_to_synchronous(cuda_device, restore_torch_precision):
    """Batches staged on a side stream from pinned memory and read on the
    compute stream train the same bits as in-line copies (the event and
    record_stream keep the copy from being read early or its memory reused
    while the step reads it)."""
    from neurips18_hierchical_image_manipulation_tpu_torch.train.prefetch import (
        H2DStager,
        device_prefetch,
        ready,
        to_device,
    )

    opt = BoxToMaskTrainOptions(gpu_ids="0", label_nc=8, ngf=8, ndf=8, n_downsample_global=2,
                                n_blocks_global=1, n_layers_D=2, fineSize=32)
    torch.backends.cudnn.deterministic = True
    host = [synthetic_box2mask_batch(np.random.RandomState(i), 2, size=32, label_nc=8)
            for i in range(6)]
    results = {}
    for depth in (0, 2):
        from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
        from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import make_train_step

        model = create_model(opt)
        state = make_optimizers(opt, model, 6)
        step = make_train_step(model)
        stage = H2DStager(cuda_device) if depth else (lambda hb: to_device(hb, cuda_device))
        for staged, _ in device_prefetch(iter(host), stage, depth):
            step(state, ready(staged))
        torch.cuda.synchronize()
        results[depth] = {k: v.detach().clone() for k, v in model.netG.state_dict().items()}
    for k, v in results[0].items():
        assert bits_equal(v, results[2][k]), k


@pytest.mark.parametrize("image,pad", [(True, 3), (True, 0), (False, 0)])
def test_encode_op_opcheck_and_kernel(cuda_device, image, pad):
    """himan::encode on the card: schema, fake tensors and dispatch
    (torch.library.opcheck); its implementation launches the kernel, bit
    for bit the plain version."""
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import ops as kops

    i = encode_inputs(cuda_device)
    args = (i["label"], i["inst"], i["image"] if image else None,
            i["boxes"] if image else None, 35, pad, None if image else torch.bfloat16)
    torch.library.opcheck(kops.encode, args)
    counter = kenc.encode if image else kenc.encode_cond
    before = counter.launches
    got = torch.ops.himan.encode(*args)
    assert counter.launches == before + 1
    assert bits_equal(got, kenc.encode_plain(*[a.cpu() if torch.is_tensor(a) else a
                                               for a in args]).to(cuda_device))


@pytest.mark.parametrize("act,residual", [("none", False), ("relu", True), ("lrelu", False)])
def test_instance_norm_op_opcheck_and_kernel(cuda_device, act, residual):
    """himan::instance_norm on the card: opcheck; its implementation
    launches the forward kernel, within the kernel's tolerance of the plain
    version."""
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import ops as kops

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 16, 24, 64, device=cuda_device, generator=g)
    res = torch.randn(2, 16, 24, 64, device=cuda_device, generator=g) if residual else None
    torch.library.opcheck(kops.instance_norm, (x, act, res, kin.EPS))
    before = kin.instance_norm.launches
    y, mean, rstd = torch.ops.himan.instance_norm(x, act, res, kin.EPS)
    assert kin.instance_norm.launches == before + 1
    py, pmean, prstd = kin.instance_norm_plain(x, act, res)
    torch.testing.assert_close(y, py, atol=1e-4, rtol=0)
    torch.testing.assert_close(mean, pmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, prstd, atol=1e-5, rtol=1e-5)


def test_exported_box2mask_launches_kernels(cuda_device, restore_torch_precision, tmp_path):
    """A tiny box2mask exported on the card holds himan::instance_norm; the
    reloaded program launches the IN kernel as often as the eager forward,
    and gives its bits."""
    from neurips18_hierchical_image_manipulation_tpu_torch.tools import export_inference

    model, batch = export_inference.build("box2mask", 8, 32, 1, "0", ngf=8,
                                          n_downsample_global=2, n_blocks_global=1)
    ep = export_inference.export("box2mask", model, batch)
    export_inference.save(ep, str(tmp_path / "b2m.pt2"))
    prog = export_inference.load(str(tmp_path / "b2m.pt2")).module()
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        n0 = kin.instance_norm.launches
        eager = model.inference(batch)
        n1 = kin.instance_norm.launches
        got = prog(batch)
        n2 = kin.instance_norm.launches
    assert n1 - n0 == n2 - n1 == 2 + 3 * 2 + 2 * 1
    for a, b in zip(eager, got):
        assert bits_equal(a, b)


def test_avg_pool_3x3s2_input_gradient_against_fp64(cuda_device):
    """nnops.avg_pool_3x3s2 (the multiscale D's inter-scale pool) at the D's
    input shape (bs 4, 512x256, 36 channels): its input gradient on the
    card in fp32 against fp64 on the CPU, within 1e-5 of max |reference|
    (fp32 sums of at most 9 terms). Before the C.12 repair (the pool on
    the channels_last view of the NHWC tensor)
    reports/torch_r13/c12_oracle/pool_grad.py measured it 0.86-1.06 off."""
    from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 256, 512, 36, generator=g, dtype=torch.float64)
    gy = torch.randn(4, 128, 256, 36, generator=g, dtype=torch.float64)

    def input_grad(dev, dt):
        xd = x.to(dev, dt, copy=True).requires_grad_(True)
        nnops.avg_pool_3x3s2(xd).backward(gy.to(dev, dt))
        return xd.grad.double().cpu()

    ref = input_grad("cpu", torch.float64)
    got = input_grad(cuda_device, torch.float32)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# The port's PyTorch ops on the card against float64 on the CPU. The card
# tier above holds each kernel to its plain version, and both share every
# PyTorch op; this audit holds those ops to an independent reference. Bars,
# relative to max |reference|: AUDIT_BAR per dtype for short sums (pools,
# pads, gathers, interpolation: at most a few dozen terms), AUDIT_SUM_BAR
# for long ones (the convolutions' K and their weight gradients' N*H*W,
# segment sums of up to 131k pixels); max_pool_2x2 exactly. The inputs are
# rounded to the dtype first, so the reference sees the same values and the
# bar measures the op's own arithmetic: fp32 with TF32 off, bf16 with fp32
# accumulation and one rounding (2^-9 relative) of each output.
AUDIT_BAR = {"float32": 1e-5, "bfloat16": 1e-2}
AUDIT_SUM_BAR = {"float32": 1e-4, "bfloat16": 2e-2}


def _fp64_check(op, ref_op, inputs, dt, dev, grad_of=(), bar=AUDIT_BAR, gen=None):
    """op(*inputs) on the card in ``dt`` and ref_op(*inputs) on the CPU in
    float64 (float inputs rounded to ``dt`` first, integer ones as they
    are), and, for one random output gradient, the gradients of both with
    respect to the inputs ``grad_of`` (indices) -> {what: max |diff| / max
    |ref|}, each asserted within bar[dt]."""
    tdt = getattr(torch, dt)

    def prep(t, dev, ft):
        return t.to(tdt).to(dev, ft).requires_grad_(True) if t.is_floating_point() else t.to(dev)

    got_in = [prep(t, dev, tdt) for t in inputs]
    ref_in = [prep(t, "cpu", torch.float64) for t in inputs]
    got, ref = op(*got_in), ref_op(*ref_in)
    pairs = {"forward": (got, ref)}
    if grad_of:
        gy = torch.randn(ref.shape, generator=gen, dtype=torch.float64).to(tdt)
        gg = torch.autograd.grad(got, [got_in[i] for i in grad_of], gy.to(dev))
        rg = torch.autograd.grad(ref, [ref_in[i] for i in grad_of], gy.double())
        pairs.update({f"grad of input {i}": p for i, p in zip(grad_of, zip(gg, rg))})
    out = {}
    for k, (a, b) in pairs.items():
        a, b = a.detach().double().cpu(), b.detach()
        out[k] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
    bad = {k: v for k, v in out.items() if not v <= bar[dt]}
    assert not bad, f"over {bar[dt]} of max |reference|: {bad} (all {out})"
    return out


def _nchw_ref(fn):
    """An fp64 reference on NHWC tensors through the NCHW PyTorch op."""
    return lambda x, *a: fn(x.permute(0, 3, 1, 2).contiguous(), *a).permute(0, 2, 3, 1)


def _audit_avg_pool(shape):
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
        x = torch.randn(shape, generator=gen, dtype=torch.float64)
        ref = _nchw_ref(lambda t: torch.nn.functional.avg_pool2d(
            t, 3, 2, 1, count_include_pad=False))
        return _fp64_check(nnops.avg_pool_3x3s2, ref, [x], dt, dev, grad_of=(0,), gen=gen)
    return case


def _audit_max_pool(dt, dev, gen):
    """A ReLU'd VGG relu1_1 tap (1, 256, 512, 64), a third of it tied zeros
    and whole windows of them: forward and input gradient exactly, the
    gradient's nonzero positions too (a tied window routes to its first
    maximum in scan order, as the JAX package's max pool does)."""
    from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
    x = torch.relu(torch.randn(1, 256, 512, 64, generator=gen) + 0.5)
    x[:, :64, :128] = 0.0
    x = x.to(getattr(torch, dt))
    xg = x.to(dev).requires_grad_(True)
    xr = x.double().requires_grad_(True)
    y = nnops.max_pool_2x2(xg)
    yr = _nchw_ref(lambda t: torch.nn.functional.max_pool2d(t, 2, 2))(xr)
    gy = (torch.randn(yr.shape, generator=gen) + 2.0).to(x.dtype)   # nonzero everywhere
    (gx,) = torch.autograd.grad(y, xg, gy.to(dev))
    (gr,) = torch.autograd.grad(yr, xr, gy.double())
    assert torch.equal(y.detach().double().cpu(), yr.detach())
    assert torch.equal(gx.cpu() != 0, gr != 0), "the gradient is routed elsewhere"
    assert torch.equal(gx.double().cpu(), gr)
    return {"forward": 0.0, "grad of input 0": 0.0}


def _audit_conv(x_shape, cout, k, stride, padding):
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
        cin = x_shape[-1]
        x = torch.randn(x_shape, generator=gen, dtype=torch.float64)
        w = torch.randn(cout, cin, k, k, generator=gen, dtype=torch.float64) / (cin * k * k) ** .5
        b = torch.randn(cout, generator=gen, dtype=torch.float64)

        def op(x, w, b):
            return nnops.conv2d(x, w, b, stride=stride, padding=padding)

        def ref(x, w, b):
            return _nchw_ref(lambda t: torch.nn.functional.conv2d(
                t, w, b, stride=stride, padding=padding))(x)
        return _fp64_check(op, ref, [x, w, b], dt, dev, grad_of=(0, 1, 2), bar=AUDIT_SUM_BAR,
                           gen=gen)
    return case


def _audit_conv_t(x_shape, cout):
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
        cin = x_shape[-1]
        x = torch.randn(x_shape, generator=gen, dtype=torch.float64)
        w = torch.randn(cin, cout, 3, 3, generator=gen, dtype=torch.float64) / (cin * 9) ** .5
        b = torch.randn(cout, generator=gen, dtype=torch.float64)

        def ref(x, w, b):
            return _nchw_ref(lambda t: torch.nn.functional.conv_transpose2d(
                t, w, b, stride=2, padding=1, output_padding=1))(x)
        return _fp64_check(nnops.conv_transpose2d, ref, [x, w, b], dt, dev, grad_of=(0, 1, 2),
                           bar=AUDIT_SUM_BAR, gen=gen)
    return case


def _audit_reflect_pad(shape, pad):
    """The reflect pad's forward (a copy: exact) and its backward (the
    reflect-pad kernel) against F.pad's in fp64."""
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
        x = torch.randn(shape, generator=gen, dtype=torch.float64)
        ref = _nchw_ref(lambda t: torch.nn.functional.pad(t, (pad,) * 4, mode="reflect"))
        out = _fp64_check(lambda t: nnops.reflect_pad(t, pad), ref, [x], dt, dev,
                          grad_of=(0,), gen=gen)
        assert out["forward"] == 0.0
        return out
    return case


def _audit_segment_mean(c):
    """segment_mean_2d at an Encoder site (1, 256, 512, c) with the
    Encoder's segment space (35 classes x 64 slots) and 70 instances, the
    largest segment the background (about half the image)."""
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
        n_seg = 35 * 64
        seg = torch.zeros(1, 256, 512, dtype=torch.int64)
        for k in range(70):
            y0, x0 = (int(v) for v in torch.randint(0, 200, (2,), generator=gen))
            hh, ww = (int(v) for v in torch.randint(8, 56, (2,), generator=gen))
            seg[:, y0:y0 + hh, x0 * 2:x0 * 2 + ww] = 1 + k * 31
        feat = torch.randn(1, 256, 512, c, generator=gen, dtype=torch.float64) + 0.5

        def ref(f, s):
            flat = f.reshape(-1, c)
            sums = torch.zeros(n_seg, c, dtype=f.dtype).index_add(0, s.reshape(-1), flat)
            cnt = torch.zeros(n_seg, dtype=f.dtype).index_add(
                0, s.reshape(-1), torch.ones_like(flat[:, 0]))
            return (sums / cnt.clamp_min(1.0)[:, None])[s.reshape(-1)].reshape(f.shape)
        return _fp64_check(lambda f, s: nnops.segment_mean_2d(f, s, n_seg), ref, [feat, seg],
                           dt, dev, grad_of=(0,), bar=AUDIT_SUM_BAR, gen=gen)
    return case


def _audit_box(kind, method):
    """crop_resize / paste_resize at the two-step pipeline's sizes (a
    1024x512 scene, a 512 window, a 128 crop) and the resident loader's
    PIL-bicubic windows: forward only (no train path takes their
    gradient); the sample coordinates are fp32 on both sides, the
    interpolation of an fp64 image on the CPU."""
    def case(dt, dev, gen):
        from neurips18_hierchical_image_manipulation_tpu_torch.ops import boxcomposite as bc
        scene = torch.rand(2, 512, 1024, 3, generator=gen, dtype=torch.float64) * 2 - 1
        boxes = torch.tensor([[100.0, 300.0, 256.0, 300.0], [0.0, 512.0, 512.0, 512.0]])
        if kind == "crop":
            def op(img):
                return bc.crop_resize(img, boxes.to(img.device), (512, 512), method=method)
            return _fp64_check(op, op, [scene], dt, dev, gen=gen)
        patch = torch.rand(2, 128, 128, 3, generator=gen, dtype=torch.float64)

        def op(canvas, p):
            return bc.paste_resize(canvas, p, boxes.to(canvas.device), method=method)
        return _fp64_check(op, op, [scene, patch], dt, dev, gen=gen)
    return case


def _audit_encode_input_rgb(dt, dev, gen):
    """The no-kernel G input (one-hot, instance edges, RGB) at 512x256,
    bs 2: exact."""
    from neurips18_hierchical_image_manipulation_tpu_torch.ops import onehot_edges
    b = synthetic_batch(np.random.RandomState(3), 2, hw=(256, 512), label_nc=35)
    label, inst = torch.from_numpy(b["label"]), torch.from_numpy(b["inst"])
    rgb = torch.from_numpy(b["image"]).double()

    def op(lb, it, im):
        return onehot_edges.encode_input_rgb(lb, it, im, 35, dtype=im.dtype)
    out = _fp64_check(op, op, [label, inst, rgb], dt, dev, gen=gen)
    assert out["forward"] == 0.0
    return out


AUDIT_CASES = {
    "avg_pool_3x3s2-D-36ch": _audit_avg_pool((4, 256, 512, 36)),
    "avg_pool_3x3s2-D-3ch": _audit_avg_pool((4, 256, 512, 3)),
    "avg_pool_3x3s2-odd": _audit_avg_pool((2, 129, 257, 36)),
    "max_pool_2x2-vgg-relu1_1": _audit_max_pool,
    "conv2d-stem-7x7": _audit_conv((1, 262, 518, 39), 64, 7, 1, 0),
    "conv2d-head-7x7": _audit_conv((1, 262, 518, 64), 3, 7, 1, 0),
    "conv2d-resblock-3x3-1024": _audit_conv((1, 18, 34, 1024), 1024, 3, 1, 0),
    "conv2d-D-4x4-s2": _audit_conv((2, 129, 257, 64), 128, 4, 2, 2),
    **{f"conv_transpose2d-up{i}": _audit_conv_t((1, 16 * 2**i, 32 * 2**i, 1024 >> i),
                                                 512 >> i) for i in range(4)},
    "reflect_pad-1-resblock": _audit_reflect_pad((1, 16, 32, 1024), 1),
    "reflect_pad-3-stem": _audit_reflect_pad((1, 256, 512, 39), 3),
    "reflect_pad-3-head": _audit_reflect_pad((1, 256, 512, 64), 3),
    **{f"segment_mean_2d-{c}ch": _audit_segment_mean(c) for c in (16, 64, 256)},
    "crop_resize-bilinear": _audit_box("crop", "bilinear"),
    "crop_resize-pil_bicubic": _audit_box("crop", "pil_bicubic"),
    "paste_resize-bilinear": _audit_box("paste", "bilinear"),
    "encode_input_rgb": _audit_encode_input_rgb,
}


AUDIT_PARAMS = [pytest.param(op, dt) for op in AUDIT_CASES for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("op,dt", AUDIT_PARAMS)
def test_nnops_on_card_against_fp64(cuda_device, restore_torch_precision, op, dt):
    """Each PyTorch op of the port's main paths on the card (fp32 with TF32
    off, and bf16) against the same op in float64 on the CPU, at the shapes
    the main paths run: the output and the input (and weight) gradients
    within the stated bars (AUDIT_BAR, AUDIT_SUM_BAR), max_pool_2x2
    exactly."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(sorted(AUDIT_CASES).index(op))
    errs = AUDIT_CASES[op](dt, cuda_device, gen)
    print(f"{op} {dt}: {errs}")

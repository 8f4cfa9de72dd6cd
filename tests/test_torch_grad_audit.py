"""The step-level gradient check (tools/grad_audit, chip_smoke.py phase 38)
and the oracle's check at the init (tools/bench_torch_oracle), on the CPU
against the CPU at test widths: one side runs with oneDNN off (another
summation order in its convolutions), standing in for the card. Each
check passes untouched and reports a miss when a pool backward of C.12's
kind (the right forward, a gradient read in the wrong layout) is planted
on one side, and when one of the right layout but 1.5x the scale is."""

from contextlib import nullcontext
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTrainOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (
    synthetic_batch,
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_torch_oracle as bo
from neurips18_hierchical_image_manipulation_tpu_torch.tools import grad_audit as ga

ARCH = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1, num_D=2,
            n_layers_D=2)
HW = (32, 64)
PATHS = {
    "flagship": dict(ARCH),
    "local": dict(ARCH, netG="local", ngf=4, n_local_enhancers=1, n_blocks_local=1, num_D=3),
    "instance_feat": dict(ARCH, instance_feat=True, feat_num=3, nef=4, n_downsample_E=2),
}
_POOL = nnops.avg_pool_3x3s2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Whole small train steps, many times; beside the other test workers,
    torch's intra-op thread pool oversubscribes the cores and spins, so
    each test runs on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _LayoutBugPool(torch.autograd.Function):
    """The right pool forward; its input gradient computed from the output
    gradient's NHWC memory read as NCHW (C.12's kind of fault)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return _POOL(x.detach())

    @staticmethod
    def backward(ctx, gy):
        n, h, w, c = gy.shape
        wrong = gy.contiguous().reshape(n, c, h, w).permute(0, 2, 3, 1)
        x = torch.zeros(ctx.shape, dtype=gy.dtype, requires_grad=True)
        with torch.enable_grad():
            return torch.autograd.grad(_POOL(x), x, wrong)[0]


class _ScaledPool(torch.autograd.Function):
    """The right pool forward; its input gradient 1.5x the right one (the
    signs right: a fault max |diff| and the flips, set by the rounding's
    outliers, need not see)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return _POOL(x.detach())

    @staticmethod
    def backward(ctx, gy):
        x = torch.zeros(ctx.shape, dtype=gy.dtype, requires_grad=True)
        with torch.enable_grad():
            return 1.5 * torch.autograd.grad(_POOL(x), x, gy)[0]


PLANTED = {"layout": _LayoutBugPool.apply, "scale": _ScaledPool.apply}


def test_planted_pool_has_the_right_forward_and_a_wrong_gradient():
    x = torch.randn(1, 8, 12, 3, requires_grad=True)
    y = _LayoutBugPool.apply(x)
    assert torch.equal(y, _POOL(x))
    (g_bad,) = torch.autograd.grad(y, x, torch.ones_like(y) + torch.arange(y.numel()).view_as(y))
    (g,) = torch.autograd.grad(_POOL(x), x, torch.ones_like(y) + torch.arange(y.numel()).view_as(y))
    assert not torch.allclose(g_bad, g)


def _stand_in(card, planted=None):
    """ga.step_gradients with ``card``'s steps under oneDNN off (and the
    pool of PLANTED named ``planted``)."""
    orig = ga.step_gradients

    def step_gradients(model, batch, *a, **k):
        if model is not card:
            return orig(model, batch, *a, **k)
        pool = (mock.patch.object(nnops, "avg_pool_3x3s2", PLANTED[planted]) if planted
                else nullcontext())
        with torch.backends.mkldnn.flags(enabled=False), pool:
            return orig(model, batch, *a, **k)
    return mock.patch.object(ga, "step_gradients", step_gradients)


def _pair(opt_cls, **arch):
    card, cpu = (create_model(opt_cls(gpu_ids="-1", **arch)) for _ in range(2))
    torch.manual_seed(1)
    ga.copy_params(cpu, card)
    return card, cpu


def _m2i_batch(seed=0):
    b = synthetic_batch(np.random.RandomState(seed), 1, hw=HW, label_nc=8)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_step_check_passes_against_itself(path):
    card, cpu = _pair(MaskToImageTrainOptions, **PATHS[path])
    batch = _m2i_batch()
    with _stand_in(card):
        rep, ref = ga.check_step(card, cpu, batch, batch)
    assert rep["misses"] == [], rep["misses"]
    assert rep["tensors"] == len(ref) > 10
    if path == "instance_feat":
        assert any(k.startswith("E.") for k in ref)


def test_step_check_passes_box2mask_against_itself():
    arch = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
                n_layers_D=2, fineSize=32, lambda_ctx_neg=5.0)
    card, cpu = _pair(BoxToMaskTrainOptions, **arch)
    b = synthetic_box2mask_batch(np.random.RandomState(2), 2, size=32, label_nc=8)
    b["cls"][0] = -1
    b["gt_objmask"][0] = 0.0
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    with _stand_in(card):
        rep, _ = ga.check_step(card, cpu, batch, batch, nudge="params")
    assert rep["misses"] == [], rep["misses"]


@pytest.mark.parametrize("path", ["flagship", "local"])
def test_step_check_sees_a_wrong_pool_backward(path):
    """The planted pool on the card side: G's gradient (through the D's
    coarse scales) misses its bar; the losses do not move."""
    card, cpu = _pair(MaskToImageTrainOptions, **PATHS[path])
    batch = _m2i_batch(3)
    with _stand_in(card, planted="layout"):
        rep, _ = ga.check_step(card, cpu, batch, batch)
    g_missed = [k for k in rep["misses"] if k.startswith("G.")]
    assert g_missed, (rep["worst_max_rel"], rep["bar"])
    assert not any(k.startswith("loss") for k in rep["misses"])
    assert not any(k.startswith("D.") for k in rep["misses"])   # D's input takes no gradient


@pytest.mark.parametrize("path", ["flagship", "local"])
def test_step_check_sees_a_scaled_pool_backward(path):
    """A pool backward of the right signs at 1.5x the scale on the card
    side: ||diff|| / ||g|| takes G's tensors over REL_L2_BAR, whatever the
    spread-built bars of max |diff| and the flips say."""
    card, cpu = _pair(MaskToImageTrainOptions, **PATHS[path])
    batch = _m2i_batch(3)
    with _stand_in(card, planted="scale"):
        rep, _ = ga.check_step(card, cpu, batch, batch)
    over_l2 = [k for k, d in rep["per_tensor"].items()
               if k.startswith("G.") and d["rel_l2"] > ga.REL_L2_BAR]
    assert over_l2 and set(over_l2) <= set(rep["misses"]), rep["worst_rel_l2"]
    assert not any(k.startswith("loss") for k in rep["misses"])


def test_bar_of_takes_the_spread_within_floors_and_caps():
    small = {"t": {"max_rel": 1e-4, "flips": 0.0, "rel_l2": 1e-5}}
    mid = {"t": {"max_rel": 0.05, "flips": 0.004, "rel_l2": 0.2}}
    wide = {"t": {"max_rel": 0.9, "flips": 0.2, "rel_l2": 0.9}}
    assert ga.bar_of(small) == {**ga.FLOORS, "rel_l2": ga.REL_L2_BAR}
    assert ga.bar_of(small, mid) == {"max_rel": 0.1, "flips": 0.008, "rel_l2": ga.REL_L2_BAR}
    assert ga.bar_of(mid, wide) == {**ga.CAPS, "rel_l2": ga.REL_L2_BAR}
    assert ga.over_bars({"a": {"max_rel": 0.0, "flips": 0.0, "rel_l2": 0.06}, **small},
                        ga.bar_of(small)) == ["a"]


def test_tensor_diffs_counts_flips_and_cosine():
    ref = {"a": torch.tensor([1.0, -2.0, 0.0, 4.0]), "dead": torch.zeros(3)}
    got = {"a": torch.tensor([1.0, 2.0, 5.0, 4.0]), "dead": torch.ones(3)}
    d = ga.tensor_diffs(got, ref)
    assert set(d) == {"a"}
    assert d["a"]["max_rel"] == pytest.approx(5.0 / 4.0)
    assert d["a"]["flips"] == pytest.approx(1.0 / 3.0)
    assert d["a"]["rel_l2"] == pytest.approx((16 + 25) ** 0.5 / 21 ** 0.5)
    assert d["a"]["cos"] == pytest.approx((1 - 4 + 16) / (46 ** 0.5 * 21 ** 0.5))
    assert d["a"]["norm_ratio"] == pytest.approx(46 ** 0.5 / 21 ** 0.5)
    with pytest.raises(AssertionError):
        ga.tensor_diffs({"a": got["a"]}, ref)


def test_oracle_check_at_init_passes_and_sees_a_wrong_pool_backward():
    """bench_torch_oracle.check_gradients_at_init at test widths: the port
    against the plain-PyTorch oracle passes; with the planted pool in the
    port, G's leaves miss (the oracle pools with nn.AvgPool2d)."""
    opt = MaskToImageTrainOptions(gpu_ids="-1", use_masked_image=True, **ARCH)
    model = create_model(opt)
    b = synthetic_batch(np.random.RandomState(4), 2, hw=HW, label_nc=8)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    rep = bo.check_gradients_at_init(model, batch)
    assert rep["ok"] and rep["ok_nudge"], rep
    with mock.patch.object(nnops, "avg_pool_3x3s2", _LayoutBugPool.apply):
        bad = bo.check_gradients_at_init(model, batch)
    assert not bad["ok"] and not bad["ok_nudge"]
    assert any(k.startswith("G.") for k in bad["over_bar_nudge"])
    assert bad["oracle_vs_port"]["G"]["max_rel"][0] > 10 * bad["bar"]["max_rel"]


def _bf16_check(planted):
    """check_bf16 on the flagship against its fp32 step: clean and with the
    pool of PLANTED named ``planted`` in the bf16 step."""
    opt = MaskToImageTrainOptions(gpu_ids="-1", **ARCH)
    m32 = create_model(opt)
    m16 = create_model(MaskToImageTrainOptions(gpu_ids="-1", dtype="bfloat16", **ARCH))
    ga.copy_params(m32, m16)
    batch = _m2i_batch(5)
    _, ref = ga.step_gradients(m32, batch)
    clean = ga.check_bf16(m16, batch, ref)
    with mock.patch.object(nnops, "avg_pool_3x3s2", PLANTED[planted]):
        bad = ga.check_bf16(m16, batch, ref)
    return clean, bad


def _g_misses(rep):
    return [k for k in rep["misses"] if k.startswith("G.")]


def test_bf16_check_sees_a_wrong_pool_backward():
    """check_bf16 against the fp32 step: the planted pool in the bf16 step
    moves G's tensors below the cosine bar or over the flipped-sign bar."""
    clean, bad = _bf16_check("layout")
    assert bad["worst_cos"][0] < clean["worst_cos"][0]
    assert len(_g_misses(bad)) > len(_g_misses(clean))


def test_bf16_check_sees_a_scaled_pool_backward():
    """A pool backward of the right signs at 1.5x the scale in the bf16
    step: G's tensors leave the norm bar."""
    clean, bad = _bf16_check("scale")
    assert bad["worst_norm"][0] > ga.BF16_NORM > clean["worst_norm"][0]
    assert len(_g_misses(bad)) > len(_g_misses(clean))


def test_step_gradients_leave_the_parameters_as_they_were():
    model = create_model(MaskToImageTrainOptions(gpu_ids="-1", **ARCH))
    before = {k: v.clone() for k, v in model.netG.state_dict().items()}
    losses, grads = ga.step_gradients(model, _m2i_batch())
    assert set(losses) == {"G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake"}
    assert all(g.dtype == torch.float64 for g in grads.values())
    assert not any(k.startswith("VGG.") for k in grads)
    for k, v in model.netG.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in model.netG.parameters())
    _, again = ga.step_gradients(model, _m2i_batch())
    for k in grads:
        assert torch.equal(grads[k], again[k]) or F.cosine_similarity(
            grads[k].flatten(), again[k].flatten(), dim=0) > 0.999999, k


def test_oracle_check_init_cli_writes_its_report(tmp_path):
    out = tmp_path / "check_init.json"
    report = bo.main(["--check_init", "--smoke", "--gpu_ids", "-1", "--out", str(out)])
    assert out.exists() and report["bs"] == bo.CHECK_BS and report["device"] == "cpu"
    assert report["check_gradients_at_init"]["ok"]

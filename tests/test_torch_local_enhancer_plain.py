"""The port's 1024p LocalEnhancer against the benchmark's plain reference
(``port_bench/reference/pix2pixhd_local.py``), on the CPU at a tiny width:
the same seeded weights load strictly into both; G's forward, one fused
resident train step's loss terms and G's and D's first gradients agree in
fp32 and not in bf16; the counts' layer list is the reference G's own
convolutions and IN sites; and the forward's spans (``himan.G.*``), which
only the LocalEnhancer records, and the two metrics that read them."""

import importlib.util
import os
import shutil
import sys
import types

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (  # noqa: E402
    MaskToImageTestOptions,
    parse_cli,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks  # noqa: E402
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import (  # noqa: E402
    create_model,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train import profiler  # noqa: E402
from port_bench import common, flops, run as bench_run  # noqa: E402
from port_bench.kinds import train_resident  # noqa: E402
from port_bench.reference import layers as rlayers  # noqa: E402
from port_bench.reference import pix2pixhd_local, registry  # noqa: E402
from port_bench.tests import tiny  # noqa: E402
from port_bench.trace import Trace  # noqa: E402
from torch_port_helpers import restore_torch_precision  # noqa: E402,F401  (fixture)

SEED = 2**31 + 11
MODEL = "pix2pixHD-local"
# the recipe's layer list at a tiny width: 2 downs, 1 trunk and 1 branch
# resblock, 3 D scales of 2 layers, 64 x 64 windows
ARCH = dict(label_nc=35, ngf=8, n_downsample_global=2, n_blocks_global=1, n_local_enhancers=1,
            n_blocks_local=1, ndf=8, n_layers_D=2, num_D=3, lambda_feat=10.0, lr=0.0002,
            beta1=0.5)
HW = 64
# fp32 on both sides, the same math in another order (the port's NHWC
# convolutions, its IN kernels' plain versions): the tanh outputs agree to
# 3e-6 (the 36 INs scale a summation order's round-off up by the inverse
# spread of a tiny net's activations); a bf16 port is off by 2e-2
FWD_ATOL = 2e-5
# one step's loss terms (relative) and each leaf's first-gradient norm
# (relative to the larger of its own and the median leaf's): fp32 agrees to
# 1e-7 and 4e-7; the bf16 tier's operands (8 bits of mantissa) part by 8e-4
# and 2e-2
STEP_RTOL = 1e-4


def _config():
    o = dict(ARCH, netG="local", niter_fix_global=0, fineSize=HW, loadSize=256,
             contextMargin=2.0, min_box_size=4)
    c = dict(ARCH, name="tiny-local", model=MODEL, train_options="MaskToImageTrainOptions",
             test_options="MaskToImageTestOptions", scene_hw=[128, 256], objects_per_scene=3,
             object_h=[12, 40], object_w=[16, 60], options=o)
    return c


def _port_g(cfg):
    return networks.LocalEnhancer(
        cfg["label_nc"] + 4, 3, ngf=cfg["ngf"], n_downsample_global=cfg["n_downsample_global"],
        n_blocks_global=cfg["n_blocks_global"], n_local_enhancers=1,
        n_blocks_local=cfg["n_blocks_local"])


def _g_input(cfg, n=2, seed=0):
    """(B,H,W,39) as the encode builds it: one-hot, edges, box-masked RGB."""
    g = torch.Generator().manual_seed(seed)
    label = torch.randint(0, cfg["label_nc"], (n, HW, HW), generator=g)
    inst = label * 1000 + torch.randint(0, 3, (n, HW, HW), generator=g)
    rgb = torch.rand(n, 3, HW, HW, generator=g) * 2 - 1
    rgb[:, :, 20:40, 16:48] = 0.0
    x = torch.cat([rlayers.onehot(label, cfg["label_nc"]), rlayers.edges(inst), rgb], 1)
    return x


def test_the_registry_finds_the_model_and_the_weights_load_strictly_into_both():
    cfg = _config()
    assert registry.find(MODEL) is pix2pixhd_local
    w = common.make_weights(cfg, SEED, torch.device("cpu"), train=True)
    assert list(w) == ["G", "D", "VGG"]
    _port_g(cfg).load_state_dict(w["G"], strict=True)
    ref = pix2pixhd_local.Reference(cfg, True)
    for net, m in ref.nets.items():
        m.load_state_dict(w[net], strict=True)
    assert ref.nets["D"].num_D == 3
    names = {k.split(".")[0] for k in w["G"]}
    assert names == {"global", "local1_conv_in", "local1_down", "local1_res0", "local1_up",
                     "conv_out"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_forward_equals_the_references(dtype):
    cfg = _config()
    w = common.make_weights(cfg, SEED, torch.device("cpu"), train=False)["G"]
    port, ref = _port_g(cfg), pix2pixhd_local.Reference(cfg, False).nets["G"]
    port.load_state_dict(w, strict=True)
    ref.load_state_dict(w, strict=True)
    x = _g_input(cfg)
    with torch.no_grad():
        want = ref(x)
        got = port.to(dtype)(x.permute(0, 2, 3, 1).to(dtype)).float().permute(0, 3, 1, 2)
    gap = float((got - want).abs().max())
    assert got.shape == want.shape == (2, 3, HW, HW)
    if dtype == torch.float32:
        assert gap < FWD_ATOL
    else:
        assert gap > FWD_ATOL      # the tolerance tells a bf16 forward apart


def _train_run(dtype, trace=0):
    """A tiny cell of the model through the benchmark's train kind on the
    CPU -> the Run (its check holds both sides' readings)."""
    bench, files = tiny.bench_and_files(dtype)
    bench["workloads"].append({"name": "loc", "config": "tiny-local", "traffic": "train",
                               "chips": 1})
    files["configs"]["tiny-local"] = _config()
    files["limits"]["loc"] = tiny.LIMITS["train"]
    r = bench_run.Run(bench, "loc", SEED, 0.2, trace, torch.device("cpu"), files=files)
    try:
        train_resident.run(r)
    finally:
        for d in r.cleanup:
            shutil.rmtree(d, ignore_errors=True)
    return r


def _step_gaps(r):
    prog, ref = r.check["program"], r.check["reference"]
    terms = {k: abs(prog["metrics"][0][k] - v) / abs(v) for k, v in ref["metrics"][0].items()}
    grads = common.leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    return terms, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_train_step_matches_the_references(dtype, restore_torch_precision):  # noqa: F811
    r = _train_run(dtype)
    terms, grads = _step_gaps(r)
    assert set(terms) == {"G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake"}
    assert {k.split(".")[0] for k in grads} == {"G", "D"}
    assert any(k.startswith("G.global.") for k in grads)
    assert any(k.startswith("G.local1_") for k in grads)
    worst = max(max(terms.values()), max(grads.values()))
    if dtype == "float32":
        assert worst < STEP_RTOL, (terms, max(grads.items(), key=lambda kv: kv[1]))
        assert common.judge(r.readings, tiny.LIMITS["train"])[0]
    else:
        assert worst > STEP_RTOL    # the tolerance tells a bf16 step apart


def _hooked_counts(cfg):
    """(the reference G's convolution FLOPs a sample, as flops.py counts
    them, and its IN sites [(elements, channels)]) by forward hooks."""
    g = pix2pixhd_local.Reference(cfg, False).nets["G"]
    total = [0.0]
    sites = []

    def conv_hook(m, inp, out):
        cin = inp[0].shape[1]
        if isinstance(m, rlayers.ConvT):
            hi, wi = inp[0].shape[2:]
            total[0] += flops.convt(1, hi, wi, cin, out.shape[1])
        else:       # every output element: cin x k x k MACs, taps on the pad too
            total[0] += 2.0 * out[0].numel() * cin * m.weight.shape[-1] ** 2

    for m in g.modules():
        if isinstance(m, (rlayers.Conv, rlayers.ConvT)):
            m.register_forward_hook(conv_hook)
    real_in = F.instance_norm

    def counting_in(x, *a, **k):
        sites.append((x[0].numel(), x.shape[1]))
        return real_in(x, *a, **k)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "instance_norm", counting_in)
        g(_g_input(cfg, n=1))
    return total[0], sites


@pytest.mark.parametrize("n_blocks_local", [1, 3])
def test_g_layers_are_the_references_own_convolutions(n_blocks_local):
    cfg = dict(_config(), n_blocks_local=n_blocks_local)
    layers, sites = pix2pixhd_local.g_layers(cfg, HW, HW)
    hooked, hooked_sites = _hooked_counts(cfg)
    assert sum(f for f, _ in layers) == hooked
    assert sorted((e, c) for e, c, _ in sites) == sorted(hooked_sites)
    # the trunk's 3 + 2 nb + 2 nd IN sites at half size and the branch's
    # 3 + 2 nb at full size
    nd, nb = cfg["n_downsample_global"], cfg["n_blocks_global"]
    assert len(sites) == (1 + 2 * nd + 2 * nb) + (3 + 2 * n_blocks_local)
    assert len(layers) == (1 + 2 * nd + 2 * nb) + (4 + 2 * n_blocks_local)
    # no data gradient into either stem: each sees the input
    assert [i for i, (_, dgrad) in enumerate(layers) if not dgrad] == [0, 1 + 2 * nd + 2 * nb]
    # the train step's count takes them through the registry
    got = flops.g_forward(cfg, 3, (HW, HW))
    assert got == 3 * hooked


# ------------------------------------------------------------------ spans

G_SPANS = ("himan.G.pyramid", "himan.G.trunk", "himan.G.local1")


def _inference_table(netG, tmp_path):
    opt = parse_cli(MaskToImageTestOptions, [
        "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path), "--name", "spans",
        "--netG", netG, "--ngf", "8", "--n_downsample_global", "2", "--n_blocks_global", "1",
        "--n_blocks_local", "1", "--fineSize", str(HW)])
    model = create_model(opt)
    g = torch.Generator().manual_seed(0)
    batch = {"label": torch.randint(0, 35, (1, HW, HW), generator=g),
             "inst": torch.randint(0, 35, (1, HW, HW), generator=g),
             "image": torch.rand(1, HW, HW, 3, generator=g) * 2 - 1,
             "boxes": torch.tensor([[8.0, 8.0, 20.0, 20.0]])}
    profiler.reset_spans()
    with torch.no_grad():
        model.inference(batch)      # no profiler: nothing recorded
    assert profiler.span_table() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            for _ in range(2):
                model.inference(batch)
    return profiler.span_table()


@pytest.mark.parametrize("netG", ["local", "global"])
def test_only_the_local_enhancers_forward_records_the_g_spans(netG, tmp_path,
                                                              restore_torch_precision):  # noqa: F811
    table = _inference_table(netG, tmp_path)
    assert table["himan.infer.G"]["count"] == 2
    if netG == "global":
        assert not any(k.startswith("himan.G.") for k in table)
    else:
        assert {k: (table[k]["count"], table[k]["parent"]) for k in G_SPANS} == {
            k: (2, "himan.infer.G") for k in G_SPANS}


def test_a_traced_train_step_records_the_g_spans_under_its_g(restore_torch_precision):  # noqa: F811
    r = _train_run("float32", trace=1)
    table = profiler.span_table()
    steps = table["himan.step"]["count"]
    assert steps == r.layer["trace"].calls == tiny.TRAIN["trace_steps"]
    assert {k: (table[k]["count"], table[k]["parent"]) for k in G_SPANS} == {
        k: (steps, "himan.step.forward.G") for k in G_SPANS}
    # the CPU has no device times: the readers read nothing
    assert all(_reader(m)(r.layer) is None for m in METRICS)


METRICS = {"g_trunk_ms.train": "himan.G.trunk", "g_local_ms.train": "himan.G.local1"}


def _reader(name):
    path = common.named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _entry(count, device_s, parent):
    return {"count": count, "host_s": 0.001, "device_s": device_s, "parent": parent}


@pytest.mark.parametrize("case", ["spans", "parent_port", "no_table", "serve"])
def test_the_metric_readers(case, monkeypatch):
    """ms a step from the spans' card times; None on a port without the
    spans (the parent of the spans, a GlobalGenerator cell), without a
    table, and in a serving reading."""
    table = {"himan.step": _entry(4, 1.6, None),
             "himan.step.forward": _entry(4, 0.6, "himan.step"),
             "himan.step.forward.G": _entry(4, 0.2, "himan.step.forward")}
    if case != "parent_port":
        table.update({"himan.G.trunk": _entry(4, 0.08, "himan.step.forward.G"),
                      "himan.G.local1": _entry(4, 0.1, "himan.step.forward.G")})
    port = (types.SimpleNamespace() if case == "no_table"
            else types.SimpleNamespace(span_table=lambda: table))
    monkeypatch.setattr(common, "port_module", lambda sub: port)
    r = {"kind": "serve" if case == "serve" else "train", "trace": Trace([], 1.6, 4)}
    got = {m: _reader(m)(r) for m in METRICS}
    if case == "spans":
        assert got == pytest.approx({"g_trunk_ms.train": 20.0, "g_local_ms.train": 25.0})
    else:
        assert got == {m: None for m in METRICS}

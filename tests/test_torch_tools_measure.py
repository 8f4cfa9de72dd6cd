"""The port's measurement tools against the JAX repo's (tools/roofline_step.py,
bench_convt.py, bench_torch_oracle.py, trace_attrib.py / profile_decode.py)
and its shell recipes against the JAX scripts, on the CPU:

  * the true-MAC FLOP count equals the JAX tool's on its own test records
    and on random ones;
  * the convolution population of a tiny fp32 train step, collected by
    ``roofline_step``'s dispatch mode, against the JAX step's jaxpr at the
    same config: forward, dgrad and wgrad FLOPs by class;
  * the three ConvT forms of ``bench_convt`` against each other and against
    the JAX package's;
  * the oracle's analytic FLOPs against the JAX tool's;
  * a fixture Chrome trace attributed to its sites and classes;
  * each port script's argv against the JAX script's, and parsed by the
    port's option classes.
"""

import argparse
import importlib.util
import json
import os
import shlex

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurips18_hierchical_image_manipulation_tpu.configs.options import (
    MaskToImageTrainOptions as JaxTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu.models.factory import (
    create_model as jax_create_model,
)
from neurips18_hierchical_image_manipulation_tpu.ops import nnops as jnnops
from neurips18_hierchical_image_manipulation_tpu.train import steps as jax_steps
from neurips18_hierchical_image_manipulation_tpu.train.state import (
    GANTrainState,
    make_optimizers as jax_make_optimizers,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_convt
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_torch_oracle
from neurips18_hierchical_image_manipulation_tpu_torch.tools import profile_decode
from neurips18_hierchical_image_manipulation_tpu_torch.tools import roofline_step as rs
from neurips18_hierchical_image_manipulation_tpu_torch.tools import trace_attrib
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tools run thousands of small ops here; beside the other test
    workers, torch's intra-op thread pool oversubscribes the cores and
    spins, so each test runs them on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "neurips18_hierchical_image_manipulation_tpu_torch"


def jax_tool(name):
    """A JAX repo tool, loaded from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- (a) FLOPs

def _rec(**kw):
    """tests/test_roofline_flops.py's base record."""
    base = dict(lhs_shape=[4, 16, 32, 8], rhs_shape=[3, 3, 8, 16],
                dimension_numbers=[[0, 3, 1, 2], [3, 2, 0, 1], [0, 3, 1, 2]],
                lhs_dilation=[1, 1], rhs_dilation=[1, 1], window_strides=[1, 1],
                padding=[[1, 1], [1, 1]], feature_group_count=1)
    base.update(kw)
    return base


JAX_TEST_RECORDS = [_rec(), _rec(window_strides=[2, 2]),
                    _rec(lhs_dilation=[2, 2], padding=[[2, 2], [2, 2]]),
                    _rec(rhs_dilation=[2, 2], padding=[[2, 2], [2, 2]])]


def _random_records(n=200, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = [int(rng.randint(1, 8)), int(rng.randint(1, 8))]
        ld = [int(rng.randint(1, 4)), int(rng.randint(1, 4))]
        rd = [int(rng.randint(1, 3)), int(rng.randint(1, 3))]
        st = [int(rng.randint(1, 4)), int(rng.randint(1, 4))]
        size = [int(rng.randint(k[i] * rd[i], 40)) for i in range(2)]
        pad = [[int(rng.randint(0, 4)), int(rng.randint(0, 4))] for _ in range(2)]
        out.append(_rec(lhs_shape=[int(rng.randint(1, 5)), *size, int(rng.randint(1, 9))],
                        rhs_shape=[*k, 8, int(rng.randint(1, 9))], lhs_dilation=ld,
                        rhs_dilation=rd, window_strides=st, padding=pad))
    for r in out:
        r["lhs_shape"][3] = r["rhs_shape"][2]
    return out


@pytest.mark.parametrize("which", ["jax_test_records", "random_records"])
def test_conv_flops_equal_jax_tool(which):
    jax_flops = jax_tool("roofline_step")._conv_flops
    recs = JAX_TEST_RECORDS if which == "jax_test_records" else _random_records()
    assert [rs._conv_flops(r) for r in recs] == [jax_flops(r) for r in recs]


# ------------------------------------------------- (b) the conv population

TINY = dict(label_nc=8, ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1, num_D=1,
            n_layers_D=2, use_masked_image=True)
TINY_BS, TINY_HW = 2, (64, 128)


def jax_population():
    """FLOPs and counts by class of every conv_general_dilated in the jaxpr
    of the JAX make_train_step at the tiny config (fp32 parity tier), walked
    as the JAX tool's collect does (tools/roofline_step.py:87): forward
    specs have the forward rhs spec, dgrads the transposed one, wgrads a
    kernel-shaped output."""
    flops = jax_tool("roofline_step")._conv_flops
    with jnnops.precision_scope():
        opt = JaxTrainOptions(name="rl", checkpoints_dir="/nonexistent", batchSize=TINY_BS,
                              conv_precision="highest", **TINY)
        model = jax_create_model(opt)
        batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
            np.random.RandomState(0), TINY_BS, hw=TINY_HW, label_nc=8).items()}
        # shapes only, as the JAX tool's collect takes them
        shapes = jax.eval_shape(lambda r: model.init_params(r, batch), jax.random.PRNGKey(0))
        params = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        vgg = params.pop("VGG")
        tx_g, tx_d = jax_make_optimizers(opt, 10)
        state = GANTrainState.create(params, tx_g, tx_d, jax.random.PRNGKey(1))
        step = jax_steps.make_train_step(model, vgg_params=vgg, donate=False)
        jaxpr = jax.make_jaxpr(lambda s, b: step(s, b))(state, batch)
    totals, counts = {}, {}

    def walk(jx):
        for eq in jx.eqns:
            if eq.primitive.name == "conv_general_dilated":
                p = eq.params
                dn = p["dimension_numbers"]
                rec = dict(lhs_shape=list(eq.invars[0].aval.shape),
                           rhs_shape=list(eq.invars[1].aval.shape),
                           window_strides=list(p["window_strides"]),
                           padding=[list(x) for x in p["padding"]],
                           lhs_dilation=list(p["lhs_dilation"]),
                           rhs_dilation=list(p["rhs_dilation"]),
                           dimension_numbers=[list(dn.lhs_spec), list(dn.rhs_spec),
                                              list(dn.out_spec)],
                           feature_group_count=int(p["feature_group_count"]))
                kind = ("wgrad" if tuple(dn.out_spec) == (2, 3, 0, 1)
                        else "dgrad" if tuple(dn.rhs_spec) == (2, 3, 0, 1) else "fwd")
                totals[kind] = totals.get(kind, 0.0) + flops(rec)
                counts[kind] = counts.get(kind, 0) + 1
            for v in eq.params.values():
                if hasattr(v, "eqns"):
                    walk(v)
                elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                    walk(v.jaxpr)

    walk(jaxpr.jaxpr)
    return totals, counts


def test_step_conv_population_matches_jax(restore_torch_precision):
    """dgrad and wgrad FLOPs equal; the forward differs by exactly one named
    set: the JAX VGG19 runs conv5_2..conv5_4 after its last tap (on the fake
    and the real image, 6 convs at (N, H/16, W/16, 512) 3x3 512 -> 512),
    which its jaxpr holds and XLA removes as dead code; the port's VGG19
    stops at relu5_1 (models/networks.Vgg19Features)."""
    args = argparse.Namespace(bs=TINY_BS, dtype="float32", smoke=True, gpu_ids="-1")
    opt, model, batch, cdt = rs.flagship(args)
    assert {k: getattr(opt, k) for k in TINY} == TINY
    doc = rs.collect(opt, model, batch, cdt)
    port_counts = {}
    for r in doc["convs"]:
        port_counts[r["kind"]] = port_counts.get(r["kind"], 0) + r["count"]
    totals, counts = jax_population()
    for kind in ("dgrad", "wgrad"):
        assert doc["conv_flops"][kind] == totals[kind], kind
        assert port_counts[kind] == counts[kind], kind
    h, w = TINY_HW[0] // 16, TINY_HW[1] // 16
    dead = 6 * 2.0 * TINY_BS * 512 * 512 * 9 * h * w
    assert totals["fwd"] - doc["conv_flops"]["fwd"] == dead
    assert counts["fwd"] - port_counts["fwd"] == 6
    # every spec carries its layouts and the module that ran it
    for r in doc["convs"]:
        assert r["input_layout"] in ("channels_last", "contiguous", "strided")
        assert r["sites"] and all(s.split(".")[0] in ("G", "D", "VGG") for s in r["sites"])


# ---------------------------------------------------- (c) the ConvT forms

def test_convt_forms_agree_and_match_jax():
    x, k = bench_convt.inputs(2, 5, 7, 6, 4, torch.float32, "cpu")
    outs = {n: f(x, k) for n, f in bench_convt.FORMS.items()}
    ref = outs["adjoint"]
    for n, y in outs.items():
        assert y.shape == (2, 10, 14, 4)
        assert float((y - ref).abs().max()) <= 1e-5, n
    jx = jnp.asarray(x.numpy())
    jw = jnp.asarray(k.numpy().transpose(2, 3, 0, 1))   # IOHW -> HWIO, no flip
    prec = jax.lax.Precision.HIGHEST
    want = {"adjoint": jnnops.conv_transpose2d(jx, jw, stride=2, padding=1, output_padding=1,
                                               precision=prec),
            "subpixel": jnnops.conv_transpose2d_subpixel(jx, jw, precision=prec),
            "d2s": jnnops.conv_transpose2d_d2s(jx, jw, precision=prec)}
    for n, y in outs.items():
        assert np.abs(y.numpy() - np.asarray(want[n])).max() <= 1e-5, n


# --------------------------------------------------- (g) the oracle's FLOPs

@pytest.mark.parametrize("shape", [(256, 512, {}), (128, 256, {}), (512, 1024, {}),
                                   (64, 128, dict(label_nc=8, ngf=8, n_down=2, n_blocks=1,
                                                  ndf=8, n_layers_D=2, num_D=1))])
def test_oracle_model_flops_equal_jax_tool(shape):
    h, w, kw = shape
    want = jax_tool("bench_torch_oracle").model_flops_per_image(h, w, **kw)
    assert bench_torch_oracle.model_flops_per_image(h, w, **kw) == want


# ------------------------------------------ (e) trace attribution, classes

FWD, BWD = 1, 2
def test_intercept_nests_and_forwards_counters():
    """kernels/calls.intercept: a wrapper call (on a CPU tensor) reaches each
    of two nested stand-ins once, innermost first, and returns the
    wrapper's result; a counter written through the stand-ins lands on the
    wrapper; a CPU call launches nothing."""
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import calls as kcalls
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin

    seen = []

    def on(tag):
        def call(name, orig, *a, **k):
            seen.append((tag, name))
            return orig(*a, **k)
        return call

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 5, 3).astype(np.float32))
    want = kin.instance_norm(x, "relu")
    before = kcalls.read_launches()
    with kcalls.intercept(on("outer")), kcalls.intercept(on("inner")):
        got = kin.instance_norm(x, "relu")
        kin.instance_norm.launches += 5
        assert kcalls.read_launches()["instance_norm"] == before["instance_norm"] + 5
    kin.instance_norm.launches -= 5
    assert seen == [("inner", "instance_norm"), ("outer", "instance_norm")]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kcalls.read_launches() == before


K_FPROP = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64"
           "_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn")
K_NHWC = "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>(...)"
K_DGRAD = "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64"
K_CUTLASS = "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn>"
K_IN_FWD = "void (anonymous namespace)::in_fwd_cluster_kernel<float>(float const*, float*)"
K_IN_BWD = "void in_bwd_cluster_kernel<float, 1>(Params)"
K_ADAM = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
          "(anonymous namespace)::TensorListMetadata<4>, FusedAdamMathFunctor<float, 4>>(...)")
K_FFT = "void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int)"
K_OTHER = "void some_mystery_kernel<float>()"


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def fixture_trace():
    """One step: a conv forward (cuDNN's fprop and a layout conversion) and
    the IN forward (a port kernel, launched by cuLaunchKernel) in their
    module ranges; their backward on another thread, linked by sequence
    numbers; Adam; a kernel of no known family."""
    ev = [
        _x("user_annotation", "module: G.res0.conv1", FWD, 0, 100),
        _x("cpu_op", "aten::convolution", FWD, 10, 50, **{"Sequence number": 5,
                                                           "Fwd thread id": 0}),
        _x("cpu_op", "aten::cudnn_convolution", FWD, 12, 40),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 15, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 20, 2, correlation=2),
        _x("user_annotation", "module: G.norm_in", FWD, 200, 50),
        _x("cpu_op", "_InstanceNormAct", FWD, 205, 30, **{"Sequence number": 7}),
        _x("cuda_driver", "cuLaunchKernel", FWD, 210, 2, correlation=3),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", BWD, 500, 100,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cpu_op", "aten::convolution_backward", BWD, 505, 90),
        _x("cuda_runtime", "cudaLaunchKernel", BWD, 510, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", BWD, 520, 2, correlation=5),
        _x("cpu_op", "autograd::engine::evaluate_function: _InstanceNormActBackward", BWD, 700,
           50, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cuda_driver", "cuLaunchKernel", BWD, 710, 2, correlation=6),
        _x("user_annotation", "Optimizer.step#Adam.step", FWD, 900, 100),
        _x("cpu_op", "aten::_fused_adam_", FWD, 910, 20),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 915, 2, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 1200, 2, correlation=8),
    ]
    for corr, (name, dur) in enumerate([(K_FPROP, 30), (K_NHWC, 4), (K_IN_FWD, 5), (K_DGRAD, 40),
                                        (K_CUTLASS, 20), (K_IN_BWD, 6), (K_ADAM, 10),
                                        (K_OTHER, 1)], start=1):
        ev.append(_x("kernel", name, 7, 2000 + 100 * corr, dur, correlation=corr))
    return ev


SITES = {K_FPROP: "G.res0.conv1 [aten::convolution]",
         K_NHWC: "G.res0.conv1 [aten::convolution]",
         K_IN_FWD: "G.norm_in [in_fwd_cluster_kernel]",
         K_DGRAD: "G.res0.conv1 [ConvolutionBackward0]",
         K_CUTLASS: "G.res0.conv1 [ConvolutionBackward0]",
         K_IN_BWD: "G.norm_in [in_bwd_cluster_kernel]",
         K_ADAM: "Optimizer.step#Adam.step [aten::_fused_adam_]",
         K_OTHER: "(top) [some_mystery_kernel]"}
CLASSES = {K_FPROP: "conv forward / other conv algorithms",
           K_NHWC: "layout conversion (cuDNN)",
           K_IN_FWD: "port kernels", K_DGRAD: "conv data gradient",
           K_CUTLASS: "conv forward / other conv algorithms", K_IN_BWD: "port kernels",
           K_ADAM: "Adam (multi-tensor)", K_FFT: "conv forward / other conv algorithms",
           K_OTHER: profile_decode.UNCLASSIFIED}


def test_trace_attribution_and_classes(tmp_path):
    import chip_smoke

    events = fixture_trace()
    got = {name: site for site, name, _ in trace_attrib.attribute(events)}
    assert got == SITES
    for name, cls in CLASSES.items():
        assert profile_decode.kernel_kind(name) == cls, name
        assert chip_smoke.kernel_kind(name) == cls, name   # one classification
    rows = {r["site"]: r for r in trace_attrib.site_rows(
        trace_attrib.attribute(events),
        flops_by_site={"G.res0.conv1 [fwd]": 3e9, "G.res0.conv1 [dgrad]": 2e9,
                       "G.res0.conv1 [wgrad]": 1e9})}
    assert rows["G.res0.conv1 [aten::convolution]"]["n_per_step"] == 2
    assert rows["G.res0.conv1 [aten::convolution]"]["tflops"] == pytest.approx(3e9 / 34e-6 / 1e12)
    assert rows["G.res0.conv1 [ConvolutionBackward0]"]["tflops"] == pytest.approx(
        3e9 / 60e-6 / 1e12)
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    report = profile_decode.main([str(tmp_path), "--out", str(tmp_path / "d.json")])
    assert report["unclassified_kernels"] == [{"name": K_OTHER, "ms_per_step": 0.001}]
    assert report["by_class_ms"]["port kernels"] == pytest.approx(0.011)
    assert report["unclassified_pct"] == pytest.approx(100 * 1 / 116)
    assert json.loads((tmp_path / "d.json").read_text())["trace"] == str(path)


def test_trace_attribution_by_the_ports_spans():
    """Kernels launched outside every module range are sited by the
    innermost span around the launch; a backward kernel whose forward op
    ran in no module by the span around that op; outside all, ``(top)``."""
    ev = [
        _x("user_annotation", "himan.step", FWD, 0, 1000),
        _x("user_annotation", "himan.step.cast", FWD, 10, 80),
        _x("cpu_op", "aten::_to_copy", FWD, 20, 30, **{"Sequence number": 9}),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 25, 2, correlation=1),
        _x("user_annotation", "himan.step.forward", FWD, 100, 300),
        _x("user_annotation", "module: G.conv", FWD, 110, 90),
        _x("cpu_op", "aten::convolution", FWD, 120, 30, **{"Sequence number": 10}),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 125, 2, correlation=2),
        _x("cpu_op", "aten::mse_loss", FWD, 300, 20),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 305, 2, correlation=3),
        _x("cpu_op", "autograd::engine::evaluate_function: ToCopyBackward0", BWD, 600, 50,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", BWD, 610, 2, correlation=4),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", BWD, 700,
           50, **{"Sequence number": 10, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", BWD, 710, 2, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", FWD, 2000, 2, correlation=6),
    ]
    names = ["copy_to_bf16", "fprop_conv", "mse_reduce", "copy_to_fp32", "dgrad_conv",
             "mystery"]
    ev += [_x("kernel", n, 7, 3000 + 100 * c, 5, correlation=c)
           for c, n in enumerate(names, start=1)]
    unmatched = {}
    got = {name: site for site, name, _ in trace_attrib.attribute(ev, 1, unmatched)}
    assert got == {"copy_to_bf16": "himan.step.cast [aten::_to_copy]",
                   "fprop_conv": "G.conv [aten::convolution]",
                   "mse_reduce": "himan.step.forward [aten::mse_loss]",
                   "copy_to_fp32": "himan.step.cast (backward) [ToCopyBackward0]",
                   "dgrad_conv": "G.conv [ConvolutionBackward0]",
                   "mystery": "(top) [mystery]"}
    # a backward sited by a span still lists its missing module
    assert list(unmatched) == [("ToCopyBackward0", "aten::_to_copy")]


# ------------------------------------------------------ (h) the recipes

SCRIPTS = ("train_mask2image_city.sh", "train_mask2image_city_1024p.sh",
           "train_box2mask_city.sh", "test_mask2image_city.sh", "test_box2mask_city.sh",
           "two_steps_demo_city.sh")


def script_argv(path):
    """(module, flags) of a recipe's python command, and its last word."""
    text = open(path).read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("python -m "))
    words = shlex.split(line, posix=True)
    return words[2], words[3:-1], words[-1]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_match_jax_and_parse(name, monkeypatch):
    jmod, jflags, jlast = script_argv(os.path.join(REPO, "scripts", name))
    pmod, pflags, plast = script_argv(os.path.join(REPO, PORT, "scripts", name))
    assert os.access(os.path.join(REPO, PORT, "scripts", name), os.X_OK)
    assert pmod == jmod.replace("neurips18_hierchical_image_manipulation_tpu.",
                                f"{PORT}.") and pmod.startswith(f"{PORT}.cli.")
    assert pflags == jflags and jlast == plast == "$@"
    seen = []
    orig_known = argparse.ArgumentParser.parse_known_args

    def known(self, args=None, namespace=None):
        ns, rest = orig_known(self, args, namespace)
        seen.append(rest)
        raise _Parsed(ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", known)
    cli = importlib.import_module(pmod)
    with pytest.raises(_Parsed):
        cli.main(pflags)
    assert seen == [[]], f"flags the port's parser does not know: {seen}"

"""The port's measurement tools on the CPU at the test widths (``--gpu_ids
-1 --smoke``): roofline_step, trace_attrib, byte_ledger and profile_decode
write their reports' keys to ``--out``; every tool asks for a card by
default and raises without one; bench_ablate's variants are the flagship
objective less their term; byte_ledger's saved ledger counts each buffer
once. The bench tools end to end: ``test_torch_tools_measure_bench.py``."""

import argparse
import json
import os

import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_ablate
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_all
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_convt
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_torch_oracle
from neurips18_hierchical_image_manipulation_tpu_torch.tools import byte_ledger
from neurips18_hierchical_image_manipulation_tpu_torch.tools import profile_decode
from neurips18_hierchical_image_manipulation_tpu_torch.tools import roofline_step
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


SMOKE = ["--smoke", "--bs", "2", "--gpu_ids", "-1"]
VARIANT_RTOL = 1e-6   # fp32: the same terms summed without one of them


def _args(dtype="float32"):
    return argparse.Namespace(bs=2, dtype=dtype, smoke=True, gpu_ids="-1")


# ------------------------------------------------- (d) the ablate variants

@pytest.mark.parametrize("variant,term", [("no_vgg", "G_VGG"), ("no_fm", "G_GAN_Feat")])
def test_ablate_variant_is_full_less_its_term(variant, term, restore_torch_precision):
    _, model, batch, cdt = bench_ablate.build("full", _args())
    total, metrics, _ = model.losses(batch)
    _, vmodel, vbatch, _ = bench_ablate.build(variant, _args())
    got = float(bench_ablate.variant_loss(variant, vmodel, vbatch, cdt))
    want = float(total) - float(metrics[term])
    assert float(metrics[term]) > 0
    assert abs(got - want) <= VARIANT_RTOL * abs(want), (got, want)


# ------------------------------------------------ (f) the saved ledger

def test_saved_ledger_dedupes_views(monkeypatch, restore_torch_precision):
    """The tool's total is the sum over the distinct storages its hooks saw
    (a spy beside them); the step saves views of one buffer more than
    once, and each buffer counts once."""
    packed = []
    real = torch.autograd.graph.saved_tensors_hooks

    def spy(pack, unpack):
        def pack_spy(t):
            packed.append(t)
            return pack(t)
        return real(pack_spy, unpack)

    monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", spy)
    args = argparse.Namespace(**vars(_args("bfloat16")), remat=False, remat_policy=None)
    rep = byte_ledger.saved_ledger(args)
    storages = {}
    for t in packed:
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    assert rep["n_residuals"] == len(packed) > rep["n_storages"] == len(storages)
    assert rep["total_mb"] == pytest.approx(sum(storages.values()) / 1e6, rel=1e-12)
    assert rep["all_rows_mb"] == pytest.approx(rep["total_mb"], rel=1e-12)
    naive = sum(t.untyped_storage().nbytes() for t in packed)
    assert sum(storages.values()) < naive
    assert rep["activation_mb_total"] + rep["argument_mb_total"] == pytest.approx(
        rep["total_mb"], rel=1e-12)
    assert all(r["dtype"] in ("bfloat16", "float32", "int64", "bool") for r in rep["rows"])


# ---------------------------------------------- (i) every tool, end to end

def _run(tmp_path, name, fn, argv, env=None, monkeypatch=None):
    out = tmp_path / f"{name}.json"
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    fn(argv + ["--out", str(out)])
    return json.loads(out.read_text())


def test_roofline_trace_ledger_tools_write_their_keys(tmp_path, restore_torch_precision):
    specs, trace = str(tmp_path / "specs.json"), str(tmp_path / "trace")
    rl = _run(tmp_path, "roofline", roofline_step.main,
              ["--collect", "--bench", "--iters", "1", "--specs", specs, "--trace_dir", trace,
               *SMOKE])
    for k in ("attainable_step_ms", "conv_standalone_ms", "conv_fusion_tax_ms",
              "nonconv_bound_ms", "headroom_pct", "convs", "convs_by_tflops",
              "conv_sites_in_graph", "measured_step_ms", "stream_bw_gbs_measured", "device"):
        assert k in rl, k
    assert rl["device"] == "cpu" and rl["convs"] and rl["measured_step_ms"] > 0
    doc = json.loads(open(specs).read())
    assert doc["port_kernel_calls"]["instance_norm"] > 0 and doc["nonconv_bytes"] > 0
    ta = _run(tmp_path, "ta", trace_attrib.main, [trace, "5", "--steps", "1", *SMOKE])
    for k in ("rows", "by_class_ms", "unclassified_pct", "unclassified_kernels",
              "device_ms_per_step", "measured_step_ms", "device"):
        assert k in ta, k
    bl = _run(tmp_path, "bl", byte_ledger.main,
              ["--saved", "--trace", trace, "--steps", "1", "--specs", specs, *SMOKE])
    assert set(bl) == {"device", "saved_residuals", "trace_nonconv"}
    assert bl["trace_nonconv"]["nonconv_gb_per_step"] == pytest.approx(doc["nonconv_bytes"] / 1e9)
    pd = _run(tmp_path, "pd", profile_decode.main, [trace])
    assert {"by_class_ms", "unclassified_pct", "unclassified_kernels", "top_kernels"} <= set(pd)


TOOLS = {"roofline_step": (roofline_step.main, ["--collect"]),
         "trace_attrib": (trace_attrib.main, []), "byte_ledger": (byte_ledger.main, ["--saved"]),
         "bench_all": (bench_all.main, []), "bench_ablate": (bench_ablate.main, []),
         "bench_convt": (bench_convt.main, []), "bench_torch_oracle": (bench_torch_oracle.main, [])}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_a_card_by_default(tool, tmp_path):
    """--gpu_ids defaults to 0; with no card the tool raises before it runs
    anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fn, argv = TOOLS[tool]
    with pytest.raises(RuntimeError, match="--gpu_ids -1"):
        fn(argv + ["--out", str(tmp_path / "x.json")])
    assert not os.path.exists(tmp_path / "x.json")

"""The port's bench tools (bench_all, bench_ablate, bench_convt,
bench_torch_oracle) end to end on the CPU at the test widths (``--gpu_ids
-1 --smoke``): each writes its report's keys to ``--out``; the oracle
launches no port kernel."""

import json

import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_ablate
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_all
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_convt
from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_torch_oracle
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Beside the other test workers, torch's intra-op thread pool
    oversubscribes the cores and spins: one thread a test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(tmp_path, name, fn, argv, env=None, monkeypatch=None):
    out = tmp_path / f"{name}.json"
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    fn(argv + ["--out", str(out)])
    return json.loads(out.read_text())


def test_bench_tools_write_their_keys(tmp_path, monkeypatch, restore_torch_precision):
    ba = _run(tmp_path, "all", bench_all.main,
              ["--smoke", "--bs", "2", "--iters", "1", "--gpu_ids", "-1", "--with_1024p"])
    assert [r["metric"] for r in ba["configs"]] == [
        "g_forward_256x128", "structure_forward_128", "two_step_edit_512x256",
        "train_1024x512_local_enhancer"]
    assert all(set(r) == {"metric", "value", "unit"} and r["value"] > 0 for r in ba["configs"])
    ab = _run(tmp_path, "ablate", bench_ablate.main, ["--smoke", "--gpu_ids", "-1"],
              env={"HIMAN_BENCH_BS": "2", "HIMAN_BENCH_ITERS": "1"}, monkeypatch=monkeypatch)
    assert [r["variant"] for r in ab["variants"]] == list(bench_ablate.VARIANTS)
    assert all({"ms_per_step", "img_per_s", "peak_memory_gb"} <= set(r) for r in ab["variants"])
    cv = _run(tmp_path, "convt", bench_convt.main,
              ["--smoke", "--bs", "2", "--iters", "1", "--gpu_ids", "-1"])
    assert all({"shape", "adjoint_ms", "subpixel_ms", "d2s_ms"} <= set(r) for r in cv["rows"])
    orc = _run(tmp_path, "oracle", bench_torch_oracle.main,
               ["--smoke", "--iters", "1", "--gpu_ids", "-1"])
    assert set(orc["cpu_img_per_s"]) == {"tf32_default", "tf32_off"}
    assert orc["model_tflop_per_img_512x256"] == pytest.approx(1.178800750592)
    assert set(orc["port_kernel_launches"].values()) == {0}

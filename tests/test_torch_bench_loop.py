"""``tools/bench_loop.py`` on the CPU at a tiny width: the dataroot it makes
from its seed, and the input paths (threads, grain, prefetched, fused)
measured the same way, in mirrored order, with the epoch's first batch
apart."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import torch

from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_loop

TINY = ["--label_nc", "35", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_layers_D", "2", "--fineSize", "32", "--min_box_size", "4",
        "--no_vgg_loss"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small ops a run: beside the other test workers, torch's
    intra-op thread pool oversubscribes the cores, so each test runs them
    on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_dataroot_is_a_function_of_seed_and_scene(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    bench_loop.write_dataroot(a, 3, seed=5, threads=3)
    bench_loop.write_dataroot(b, 3, seed=5, threads=1)
    for sub in ("train_label", "train_inst", "train_img"):
        names = sorted(os.listdir(os.path.join(a, sub)))
        assert names == ["00000.png", "00001.png", "00002.png"]
        for n in names:
            x, y = (np.asarray(Image.open(os.path.join(r, sub, n))) for r in (a, b))
            assert x.shape[:2] == bench_loop.SCENE_HW and np.array_equal(x, y)
    inst = np.asarray(Image.open(os.path.join(a, "train_inst", "00000.png")))
    assert (inst >= 24000).any()   # three objects with class*1000+k ids


def test_bench_loop_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    bench_loop.main(["--gpu_ids", "-1", "--scenes", "4", "--steps", "2", "--warmup", "1",
                     "--reps", "2", "--dtype", "float32", "--bs", "1", "2", "--grain_workers",
                     "--out", out, *TINY])
    with open(out) as f:
        report = json.load(f)
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(report)
    assert report["device"] == "cpu" and report["train_flags"] == TINY
    assert [(r["dtype"], r["bs"]) for r in report["rows"]] == [("float32", 1), ("float32", 2)]
    for row in report["rows"]:
        assert len(row["streamed"]) == len(row["prefetched"]) == len(row["fused"]) == 2
        assert row["batches_an_epoch"] >= row["warmup"] + row["steps"] + 1
        for r in row["streamed"] + row["prefetched"]:
            assert r["ms_per_step"] > 0 and r["first_batch_wait_ms"] > 0
            assert 0 <= r["wait_ms_mean"] <= r["wait_ms_max"]
        assert all(r["ms_per_step"] > 0 for r in row["fused"])
        assert row["streamed_batch_bytes"] > 0 and row["resident_sample_ms_per_batch"] > 0
        assert row["fused_h2d_bytes_per_step"] == 0


def test_bench_loop_grain_paths(tmp_path, capsys):
    """The grain pipeline's streamed paths and, with --controls, the cached
    control and each worker count's no-decode and prefetched controls, in
    mirrored order, with the core count; worker counts above the cores are
    left out; the in-line paths time their copy."""
    bench_loop.main(["--gpu_ids", "-1", "--scenes", "4", "--steps", "2", "--warmup", "1",
                     "--reps", "2", "--dtype", "float32", "--bs", "1", "--grain_workers", "0",
                     "1", "100000", "--controls", *TINY])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["cores"] == len(os.sched_getaffinity(0))
    row = report["rows"][0]
    assert [k for k in row if isinstance(row[k], list) and k != "window"] == [
        "streamed", "cached", "grain0", "grain1", "grain1_nodecode", "grain1_prefetched",
        "prefetched", "fused"]
    for path in ("streamed", "cached", "grain0", "grain1", "grain1_nodecode"):
        for r in row[path]:
            assert r["ms_per_step"] > 0 and r["first_batch_wait_ms"] > 0
            assert 0 <= r["wait_ms_mean"] <= r["wait_ms_max"] and 0 <= r["idle_share"] <= 1
            assert r["copy_ms_mean"] >= 0
    for path in ("grain1_prefetched", "prefetched"):
        assert all("copy_ms_mean" not in r for r in row[path])


def test_predecoded_repeats_its_first_samples():
    ds = bench_loop.Predecoded([{"x": np.full(2, i)} for i in range(5)], 3)
    assert len(ds) == 5 and len(ds.samples) == 3
    assert [int(ds[i]["x"][0]) for i in range(5)] == [0, 1, 2, 0, 1]
    assert len(bench_loop.Predecoded([{}], 3).samples) == 1


def test_bench_loop_refuses_an_epoch_too_short(tmp_path):
    with pytest.raises(SystemExit, match="need more --scenes"):
        bench_loop.main(["--gpu_ids", "-1", "--scenes", "1", "--steps", "50", "--reps", "1",
                         "--dtype", "float32", "--bs", "1", *TINY])

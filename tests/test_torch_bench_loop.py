"""``tools/bench_loop.py`` on the CPU at a tiny width: the dataroot it makes
from its seed, and the three input paths measured the same way, in
mirrored order, with the epoch's first batch apart."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_loop

TINY = ["--label_nc", "35", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_layers_D", "2", "--fineSize", "32", "--min_box_size", "4",
        "--no_vgg_loss"]


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
                     "--reps", "2", "--dtype", "float32", "--bs", "1", "2", "--out", out, *TINY])
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


def test_bench_loop_refuses_an_epoch_too_short(tmp_path):
    with pytest.raises(SystemExit, match="need more --scenes"):
        bench_loop.main(["--gpu_ids", "-1", "--scenes", "1", "--steps", "50", "--reps", "1",
                         "--dtype", "float32", "--bs", "1", *TINY])

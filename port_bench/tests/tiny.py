"""Tiny configurations and cells for the CPU tests: the published layer
lists at small widths, small scenes and objects, a few rows a batch."""

from __future__ import annotations

import copy
import json
import os

import torch

from port_bench import common, run

_SHARED = ("label_nc", "ngf", "n_downsample_global", "n_blocks_global", "ndf", "n_layers_D",
           "num_D", "lr", "beta1")
_M2I = (dict(label_nc=35, ngf=8, n_downsample_global=2, n_blocks_global=1, ndf=8, n_layers_D=2,
             num_D=2, lambda_feat=10.0, lr=0.0002, beta1=0.5, fineSize=64),
        dict(name="tiny-m2i", model="pix2pixHD", train_options="MaskToImageTrainOptions",
             test_options="MaskToImageTestOptions", lambda_feat=10.0))
# {model: (the port's options, the configuration)}
_CONFIGS = {
    "pix2pixHD": _M2I,
    "box2mask": (dict(label_nc=35, ngf=8, n_downsample_global=3, n_blocks_global=1, ndf=8,
                      n_layers_D=2, num_D=1, lambda_recon=10.0, lr=0.0002, beta1=0.5,
                      fineSize=32),
                 dict(name="tiny-b2m", model="box2mask", train_options="BoxToMaskTrainOptions",
                      test_options="BoxToMaskTestOptions", lambda_recon=10.0)),
    # the test-only model of models/twin.py: pix2pixHD under another name
    "pix2pixHD-twin": (_M2I[0], dict(_M2I[1], name="tiny-twin", model="pix2pixHD-twin")),
}
# where the test-only model's module is found (a package directory, not reference/)
MODEL_DIRS = (os.path.join(os.path.dirname(os.path.abspath(__file__)), "models"),)


def config(model: str):
    if model not in _CONFIGS:
        raise KeyError(f"no tiny configuration of model {model!r}: one of {sorted(_CONFIGS)}")
    o, c = (dict(x) for x in _CONFIGS[model])
    o.update(loadSize=256, contextMargin=2.0, min_box_size=4)
    c.update({k: o[k] for k in _SHARED})
    c.update(scene_hw=[128, 256], objects_per_scene=3, object_h=[12, 40], object_w=[16, 60],
             options=o)
    return c


TRAIN = dict(kind="train_resident", dtype="float32", batch=4, scenes=6, check_steps=3,
             warmup_steps=1, trace_steps=1, ref_block=2)
SERVE = dict(kind="serve_closed_loop", dtype="float32", batch=1, clients=1, scenes=6, pool=6,
             warmup_requests=1, trace_requests=2, check_requests=3, check_of=4)
# fp32 on the CPU: the port and the reference agree to about 1e-6
LIMITS = {"train": {"loss": 1e-4, "grad": 1e-4, "change": 1e-3}, "serve": {"image": 1e-4}}


def bench_and_files(dtype="float32"):
    """(a BENCHMARK.json of five tiny cells, the files they name)."""
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    bench = {"workloads": [
        {"name": "m2i", "config": "tiny-m2i", "traffic": "train", "chips": 1},
        {"name": "b2m", "config": "tiny-b2m", "traffic": "train", "chips": 1},
        {"name": "srv", "config": "tiny-m2i", "traffic": "serve", "chips": 1},
        {"name": "twin", "config": "tiny-twin", "traffic": "train", "chips": 1},
        {"name": "twin-srv", "config": "tiny-twin", "traffic": "serve", "chips": 1}],
        "end_to_end": copy.deepcopy(real["end_to_end"]),
        "per_layer": copy.deepcopy(real["per_layer"])}
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    files = {"configs": {c["name"]: c for c in map(config, _CONFIGS)},
             "traffic": {"train": dict(TRAIN, dtype=dtype), "serve": dict(SERVE)},
             "limits": {"m2i": LIMITS["train"], "b2m": LIMITS["train"], "srv": LIMITS["serve"],
                        "twin": LIMITS["train"], "twin-srv": LIMITS["serve"]},
             "models": MODEL_DIRS}
    return bench, files


def execute(workload, trace=0, fault="none", dtype="float32", seed=2**31 + 11):
    """-> (result, Run) of a tiny cell on the CPU."""
    bench, files = bench_and_files(dtype)
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
            "--trace", str(trace)]
    return run.execute(argv, bench=bench, require_cuda=False, device=torch.device("cpu"),
                           fault=fault, files=files)

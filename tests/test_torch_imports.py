"""The port imports neither JAX nor any module of the JAX package, nor the
grain or TensorFlow packages (its grain pipeline is its own copy)."""

import os
import subprocess
import sys

import pytest

PORT = "neurips18_hierchical_image_manipulation_tpu_torch"
JAX_PKG = "neurips18_hierchical_image_manipulation_tpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = f"""
import importlib, pkgutil, sys
import {PORT} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "flax", "optax", "orbax", "grain", "tensorflow")
    or m.startswith(("jax.", "flax.", "optax.", "orbax.", "grain.", "tensorflow."))
    or m == "{JAX_PKG}" or m.startswith("{JAX_PKG}.")
)
print("COUNT", len(names))
print("BAD", ",".join(bad))
"""


def run_script(code, cwd):
    # the tests directory too: the multi-process tests' rank module lives there
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=cwd,
        env=env, timeout=120,
    )


def test_port_imports_no_jax(tmp_path):
    proc = run_script(SCRIPT, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = dict(ln.split(" ", 1) for ln in proc.stdout.splitlines() if " " in ln)
    assert int(lines["COUNT"]) >= 80   # the tools of the procedural world among them
    assert lines["BAD"] == "", f"the port pulled in: {lines['BAD']}"


@pytest.mark.parametrize(
    "module",
    ["chip_smoke", f"{PORT}.cli.mask2image_test", f"{PORT}.kernels.encode",
     f"{PORT}.cli.mask2image_train", f"{PORT}.kernels.losses", f"{PORT}.kernels.reflect_pad",
     f"{PORT}.kernels.conv_in", f"{PORT}.tools.roofline_resblock", f"{PORT}.train.loop",
     f"{PORT}.utils.checkpoint", f"{PORT}.utils.image_pool", f"{PORT}.cli.box2mask_train",
     f"{PORT}.cli.box2mask_test", f"{PORT}.models.box2mask", f"{PORT}.losses.layout",
     f"{PORT}.cli.two_step_demo", f"{PORT}.cli.evaluate", f"{PORT}.eval.two_step",
     f"{PORT}.eval.metrics", f"{PORT}.eval.features", f"{PORT}.tools.encode_features",
     f"{PORT}.tools.precompute_feature_maps", f"{PORT}.data.device_resident",
     f"{PORT}.data.native", f"{PORT}.train.prefetch", f"{PORT}.train.profiler",
     f"{PORT}.train.steps", f"{PORT}.data.loader", f"{PORT}.tools.bench_loop",
     f"{PORT}.parallel", f"{PORT}.parallel.mesh", f"{PORT}.parallel.distributed",
     f"{PORT}.parallel.spatial", "torch_parallel_ranks", f"{PORT}.kernels.ops",
     f"{PORT}.tools.pix2pixhd_format", f"{PORT}.tools.convert_torch_checkpoint",
     f"{PORT}.tools.load_vgg_weights", f"{PORT}.tools.preprocess_city_bboxes",
     f"{PORT}.tools.parity_report", f"{PORT}.tools.export_inference",
     f"{PORT}.tools.train_dynamics", f"{PORT}.tools.train_dynamics_b2m",
     f"{PORT}.tools.two_step_gallery", f"{PORT}.tools.two_step_metrics",
     f"{PORT}.tools.train_dynamics_1024p", f"{PORT}.tools.roofline_step",
     f"{PORT}.tools.trace_attrib", f"{PORT}.tools.profile_decode", f"{PORT}.tools.byte_ledger",
     f"{PORT}.tools.bench_all", f"{PORT}.tools.bench_ablate", f"{PORT}.tools.bench_convt",
     f"{PORT}.tools.bench_torch_oracle", f"{PORT}.kernels.bounds", f"{PORT}.kernels.calls",
     f"{PORT}.tools.grad_audit", f"{PORT}.data.grain_pipeline"],
)
def test_entry_points_import_no_jax(tmp_path, module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'grain', 'tensorflow')"
        f" or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r})])\n"
    )
    proc = run_script(code, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"

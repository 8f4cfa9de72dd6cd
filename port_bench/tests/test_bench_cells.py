"""A CPU rehearsal of each kind of cell at tiny widths: the harness drives
the port end to end (the port's plain versions of its kernels), the plain
reference agrees with it, and a run with a fault planted under the timed
path comes out not correct."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import common
from port_bench.tests import tiny


@pytest.mark.parametrize("workload", ["m2i", "b2m"])
def test_reference_agrees_with_the_port_on_a_train_step(workload):
    res, run = tiny.execute(workload)
    assert res["correct"], res["check"]
    # fp32 on the CPU: the losses, the first gradient and the change agree
    # to round-off
    assert run.readings["loss"] < 1e-5 and run.readings["grad"] < 1e-5
    assert res["attempted"] >= 1 and res["metrics"]["train_samples_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert list(res)[-1] == "check"


def test_reference_agrees_with_the_port_on_a_served_forward():
    res, run = tiny.execute("srv")
    assert res["correct"], res["check"]
    assert run.readings["image"] < 1e-5
    assert set(res["metrics"]) == {"serve_ms_p50", "serve_ms_p95", "setup_s"}
    assert res["metrics"]["serve_ms_p95"]["value"] >= res["metrics"]["serve_ms_p50"]["value"]


@pytest.mark.parametrize("workload,fault", [("m2i", "unchanged"), ("m2i", "half_batch"),
                                            ("b2m", "unchanged"), ("b2m", "half_batch"),
                                            ("srv", "altered")])
def test_a_planted_fault_comes_out_not_correct(workload, fault):
    res, _ = tiny.execute(workload, fault=fault)
    assert res["correct"] is False, res["check"]


def test_the_traced_run_reports_per_layer_metrics_and_device_times():
    res, _ = tiny.execute("b2m", trace=1)
    # the CPU has no device trace: only the metric read from the host clock
    assert set(res["metrics"]) == {"step_mfu.train"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_the_control_comes_out_not_correct():
    """The bf16 mask2image cell's limits at tiny widths: the port's bf16
    tier within them, the fp8 control (the reference one precision below)
    not."""
    from port_bench import calibrate

    limits = common.load_json(common.named_file("limits", "m2i-train-bf16-b32"))
    _, run = tiny.execute("m2i", dtype="bfloat16")
    assert common.judge(run.readings, limits)[0], run.readings
    control = calibrate.control_readings(run)
    assert not common.judge(control, limits)[0], control


def test_no_jax_module_after_a_rehearsal():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from port_bench.tests import tiny\n"
            "from port_bench import common\n"
            "tiny.execute('srv')\n"
            "print(json.dumps(common.loaded_forbidden()))\n") % common.ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=common.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_refuses_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(common.HERE, "run.py"), "--workload",
                          "m2i-train-bf16-b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=common.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_in_a_checkout_without_the_port(tmp_path):
    import shutil

    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # past the look for a card: the run refuses because the port is missing
    code = ("import sys, torch; sys.path.insert(0, %r)\n"
            "from port_bench import run\n"
            "try:\n"
            "    run.execute(['--workload', 'm2i-train-bf16-b32', '--seed', '1', '--seconds', "
            "'1'], require_cuda=False, device=torch.device('cpu'))\n"
            "except run.Refused as e:\n"
            "    print(e, file=sys.stderr); sys.exit(2)\n") % str(tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 2 and "not in this checkout" in out.stderr, out.stderr[-2000:]

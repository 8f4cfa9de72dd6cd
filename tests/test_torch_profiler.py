"""``train/profiler.py`` (``trace``, ``ThroughputMeter``, ``measure_steps``)
and the train CLIs' newly ported flags on the CPU: ``--profile_dir`` writes
a trace of the 21st step, ``--device_resident_data`` (with and without
``--uint8_transfer``, fused or, under the image pool or
``--no-fused_resident_step``, through the streamed path) trains and resumes
exactly, and the combinations still refused name their ROADMAP section."""

import glob
import json
import os
import re

import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_train, mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTrainOptions,
    check_train_options,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import CreateDataLoader
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop
from neurips18_hierchical_image_manipulation_tpu_torch.train.profiler import (
    ThroughputMeter,
    measure_steps,
    trace,
)
from torch_port_helpers import restore_torch_precision  # noqa: F401  (fixture)
from test_torch_box2mask_cli import TRAIN, dataroot  # noqa: F401  (fixture)

M2I = ["--label_nc", "8", "--ngf", "8", "--ndf", "8", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_layers_D", "2", "--fineSize", "32", "--min_box_size", "4",
       "--gpu_ids", "-1", "--nThreads", "1", "--niter_decay", "0", "--no_vgg_loss"]


def test_trace_writes_a_trace(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
    with trace(""):   # off: nothing written, nothing raised
        pass


def test_throughput_meter(monkeypatch):
    clock = iter([10.0, 11.0, 15.0])   # read at a window's start and end only
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    m = ThroughputMeter(batch_size=4, window=2)
    assert m.tick() == 0.0     # starts the window
    assert m.tick() == 0.0     # 1 of 2
    assert m.tick() == 4 * 2 / 1.0
    assert m.tick() == 8.0     # the last full window's rate until the next ends
    assert m.tick() == 4 * 2 / 4.0


def test_measure_steps():
    calls = []
    dt = measure_steps(lambda s, b: calls.append(1), None, None, iters=5)
    assert len(calls) == 6 and dt >= 0


def test_profile_dir_traces_the_21st_step(dataroot, tmp_path, restore_torch_precision):  # noqa: F811
    prof = str(tmp_path / "prof")
    traced = []
    orig = loop.trace

    def spy(logdir):
        traced.append(bool(logdir))
        return orig(logdir)

    loop.trace, saved = spy, loop.trace
    try:
        state = box2mask_train.main(["--name", "p", "--dataroot", dataroot, "--checkpoints_dir",
                                     str(tmp_path / "ck"), "--niter", "6", "--print_freq", "100",
                                     "--profile_dir", prof, *TRAIN])
    finally:
        loop.trace = saved
    assert state.step == 24
    assert traced.index(True) == 20 and traced.count(True) == 1
    assert len(glob.glob(os.path.join(prof, "*.pt.trace.json"))) == 1


def loss_terms(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch: ")]
    return [{k: v for k, v in re.findall(r"(\w+): (-?[0-9.]+|nan|inf)", ln.split(") ", 1)[1])
             if k != "img_per_s_per_chip"} for ln in lines]


@pytest.mark.parametrize("extra", [["--uint8_transfer"], ["--pool_size", "2"],
                                   ["--dtype", "bfloat16", "--display_freq", "2"],
                                   ["--no-fused_resident_step"]])
def test_resident_train_cli(dataroot, tmp_path, capsys, extra, restore_torch_precision):  # noqa: F811
    """The resident mask2image CLI: the fused step (or, where the image pool
    splits the step or ``--no-fused_resident_step`` asks, the resident
    loader's batches through the streamed path, as in the JAX loop) for two
    epochs,
    every loss finite, two runs the same weights bit for bit, the visuals
    showing the batch."""
    ckpt = str(tmp_path / "ck")
    argv = ["--dataroot", dataroot, "--checkpoints_dir", ckpt, "--niter", "2", "--print_freq",
            "1", "--device_resident_data", "--save_epoch_freq", "100", *M2I, *extra]
    fused = []
    orig = loop.make_resident_train_step

    def spy(*a, **k):
        fused.append(1)
        return orig(*a, **k)

    loop.make_resident_train_step, saved = spy, loop.make_resident_train_step
    try:
        runs = [mask2image_train.main(["--name", name, *argv]) for name in ("a", "b")]
    finally:
        loop.make_resident_train_step = saved
    terms = loss_terms(capsys.readouterr().out)
    assert [r.step for r in runs] == [8, 8] and len(terms) == 16
    assert all(float(v) == float(v) and abs(float(v)) < 1e6 for t in terms for v in t.values())
    assert terms[:8] == terms[8:]
    streamed = "--pool_size" in extra or "--no-fused_resident_step" in extra
    assert len(fused) == (0 if streamed else 2)
    a, b = (torch.load(os.path.join(ckpt, n, "ckpt", "latest", "state.pt"), weights_only=False)
            for n in ("a", "b"))
    for net in ("G", "D"):
        for k, t in a["params"][net].items():
            assert torch.equal(b["params"][net][k], t), (net, k)
    if "--display_freq" in extra:
        with open(os.path.join(ckpt, "a", "web", "index.html")) as f:
            html = f.read()
        assert "real_image" in html and "input_label" in html


def test_resident_mid_epoch_resume_is_exact(dataroot, tmp_path, capsys,  # noqa: F811
                                            restore_torch_precision):
    """A fused resident run stopped after 6 of 8 steps (its mid-epoch
    latest) and continued equals the straight run: the stream is a
    function of (seed, step), the shuffle included."""
    ckpt = str(tmp_path / "ck")
    argv = ["--dataroot", dataroot, "--checkpoints_dir", ckpt, "--niter", "2", "--print_freq",
            "1", "--device_resident_data", "--save_epoch_freq", "100", *M2I]
    mask2image_train.main(["--name", "a", *argv])
    full = loss_terms(capsys.readouterr().out)
    saves = []
    orig = loop.CheckpointManager.save

    def save_then_stop(self, label, model, state, epoch, it):
        orig(self, label, model, state, epoch, it)
        saves.append(state.step)
        if state.step == 6:
            raise KeyboardInterrupt

    loop.CheckpointManager.save, saved = save_then_stop, loop.CheckpointManager.save
    try:
        with pytest.raises(KeyboardInterrupt):
            mask2image_train.main(["--name", "b", *argv, "--save_latest_freq", "3"])
    finally:
        loop.CheckpointManager.save = saved
    with open(os.path.join(ckpt, "b", "iter.txt")) as f:
        assert f.read() == "2,2"
    capsys.readouterr()
    resumed = mask2image_train.main(["--name", "b", *argv, "--continue_train"])
    tail = loss_terms(capsys.readouterr().out)
    assert resumed.step == 8 and tail == full[6:]
    a = torch.load(os.path.join(ckpt, "a", "ckpt", "latest", "state.pt"), weights_only=False)
    b = torch.load(os.path.join(ckpt, "b", "ckpt", "latest", "state.pt"), weights_only=False)
    for net in ("G", "D"):
        for k, t in a["params"][net].items():
            assert torch.equal(b["params"][net][k], t), (net, k)


@pytest.mark.parametrize("flag", [["--device_resident_data"], ["--device_prefetch", "2"],
                                  ["--use_dropout"], ["--profile_dir", "p"],
                                  ["--device_resident_data", "--no-fused_resident_step"],
                                  ["--mesh_devices", "4"], ["--remat"],
                                  ["--remat_policy", "conv_out"], ["--debug_nans"]])
def test_lifted_flags_accepted(flag, tmp_path):
    opt = loop_opt(tmp_path, flag)
    check_train_options(opt)


@pytest.mark.parametrize("flag,section", [(["--netG", "local", "--remat"], "§C.11"),
                                          (["--netG", "local", "--remat_policy", "block"],
                                           "§C.11"),
                                          (["--netG", "local", "--remat_policy", "conv_out"],
                                           "§C.11"),
                                          # the id it had while grain was refused
                                          pytest.param(["--data_backend", "grain"], None,
                                                       id="flag3-§A.2")])
def test_refused_flags_name_their_section(flag, section, tmp_path):
    """What stays refused: remat of the LocalEnhancer (the JAX package
    ignores it there). The grain backend, refused before its port, is
    accepted: the train options pass and CreateDataLoader builds its loader
    (here over a dataroot with no scenes)."""
    opt = loop_opt(tmp_path, flag)
    if "--data_backend" in flag:
        check_train_options(opt)
        opt.dataroot = str(tmp_path / "city")
        for sub in ("train_label", "train_inst"):
            os.makedirs(os.path.join(opt.dataroot, sub))
        loader = CreateDataLoader(opt)
        assert type(loader).__name__ == "GrainLoader" and len(loader) == 0
    else:
        with pytest.raises(ValueError, match=section):
            check_train_options(opt)


def loop_opt(tmp_path, flag):
    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import parse_cli

    opt = parse_cli(MaskToImageTrainOptions, ["--checkpoints_dir", str(tmp_path), *flag])
    for k in ("device_resident_data", "use_dropout", "debug_nans", "remat"):
        if f"--{k}" in flag:
            assert getattr(opt, k) is True
    return opt

"""``train/profiler.py`` (``trace``, ``ThroughputMeter``, ``measure_steps``,
the spans) and the train CLIs' newly ported flags on the CPU:
``--profile_dir`` writes a trace of the 21st step and its spans; a span
with no profiler records nothing and enters no ``record_function``; under
a profiler each train path's step records its phases' spans (names,
parents, counts) into the table and the trace; ``--device_resident_data``
(with and without ``--uint8_transfer``, fused or, under the image pool or
``--no-fused_resident_step``, through the streamed path) trains and resumes
exactly, and the combinations still refused name their ROADMAP section."""

import contextlib
import glob
import json
import os
import re
import time

import pytest
import torch

from neurips18_hierchical_image_manipulation_tpu_torch.cli import box2mask_train, mask2image_train
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTrainOptions,
    MaskToImageTrainOptions,
    check_train_options,
    parse_cli,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import CreateDataLoader
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop, profiler, steps
from neurips18_hierchical_image_manipulation_tpu_torch.train.prefetch import to_device
from neurips18_hierchical_image_manipulation_tpu_torch.train.profiler import (
    ThroughputMeter,
    measure_steps,
    trace,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
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
    # the traced step's spans: box2mask's streamed step, one of each
    with open(os.path.join(prof, "spans.json")) as f:
        spans = json.load(f)
    assert {k: (v["count"], v["parent"]) for k, v in spans.items()} == {
        "himan.step": (1, None), **{f"himan.step.{p}": (1, "himan.step")
                                    for p in ("forward", "backward", "optimizer")},
        "himan.step.forward.encode": (1, "himan.step.forward"),
        "himan.step.forward.G": (1, "himan.step.forward"),
        "himan.step.forward.D": (2, "himan.step.forward")}
    assert all(v["host_s"] > 0 and v["device_s"] is None for v in spans.values())


# -------------------------------------------------------------- the spans

STEP, FWD = "himan.step", "himan.step.forward"


def _phases(*names, counts=None):
    """{span: (count, parent)} of one step with the phases ``names``
    (``forward.*`` under the forward, the rest under the step)."""
    counts = counts or {}
    out = {STEP: (1, None)}
    for n in names:
        name = f"{STEP}.{n}"
        out[name] = (counts.get(n, 1), FWD if n.startswith("forward.") else STEP)
    return out


M2I_FWD = ("forward", "forward.encode", "forward.G", "forward.D", "forward.VGG")
B2M_FWD = ("forward", "forward.encode", "forward.G", "forward.D")


def _model_and_state(dataroot, tmp_path, stage, extra=()):
    """(opt, loader, model, state) of a tiny stage over ``dataroot``; the
    mask2image one computes the VGG term."""
    cls, argv = ((MaskToImageTrainOptions, [a for a in M2I if a != "--no_vgg_loss"])
                 if stage == "m2i" else (BoxToMaskTrainOptions, TRAIN))
    opt = parse_cli(cls, ["--dataroot", dataroot, "--checkpoints_dir", str(tmp_path), *argv,
                          *extra])
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    return opt, loader, model, make_optimizers(opt, model, max(len(loader), 1))


def _profiled(fn):
    """fn() under a CPU profiler -> (the span table, the profiler)."""
    profiler.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return profiler.span_table(), prof


def _fused(dataroot, tmp_path, stage, dtype):
    opt, loader, model, state = _model_and_state(
        dataroot, tmp_path, stage, ["--device_resident_data", "--dtype", dtype])
    sample_fn, data = loader.fused_sampler()
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    step, _ = steps.make_resident_train_step(model, sample_fn, loader.n_samples, opt.batchSize,
                                             cdt, seed=opt.seed)
    return lambda: step(state, data)


def _streamed(dataroot, tmp_path, stage, extra=()):
    opt, loader, model, state = _model_and_state(dataroot, tmp_path, stage, extra)
    step = loop.make_step_fn(opt, model)
    batch = to_device(next(iter(loader)), model.device)
    return lambda: step(state, batch)


def _dp_world_1(dataroot, tmp_path, stage):
    """The DP step over a gloo group of one rank."""
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import make_mesh

    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    opt, loader, model, state = _model_and_state(dataroot, tmp_path, stage)
    step = steps.make_dp_train_step(model, make_mesh((1,), ("data",)))
    batch = to_device(next(iter(loader)), model.device)
    return lambda: step(state, batch)


PATHS = {
    "fused-m2i-bf16": (lambda d, t: _fused(d, t, "m2i", "bfloat16"),
                       _phases("sample", "cast", *M2I_FWD, "backward", "optimizer",
                               counts={"forward.D": 2})),
    "fused-b2m": (lambda d, t: _fused(d, t, "b2m", "float32"),
                  _phases("sample", *B2M_FWD, "backward", "optimizer",
                          counts={"forward.D": 2})),
    "streamed-m2i": (lambda d, t: _streamed(d, t, "m2i"),
                     _phases(*M2I_FWD, "backward", "optimizer", counts={"forward.D": 2})),
    # G's step (D on the fake and, for feature matching, on the real) and
    # D's step on the pool's fake: two forwards, backwards and optimizer
    # steps, the bf16 casts of both batches and of the pool's fake
    "pooled-m2i-bf16": (lambda d, t: _streamed(d, t, "m2i", ["--pool_size", "2", "--dtype",
                                                             "bfloat16"]),
                        _phases("cast", *M2I_FWD, "backward", "optimizer",
                                counts={"cast": 3, "forward": 2, "forward.encode": 2,
                                        "forward.D": 3, "backward": 2, "optimizer": 2})),
    "dp-world-1": (lambda d, t: _dp_world_1(d, t, "m2i"),
                   _phases(*M2I_FWD, "backward", "all_reduce", "optimizer",
                           counts={"forward.D": 2})),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_step_of_each_path_records_its_spans(path, dataroot, tmp_path,  # noqa: F811
                                                 restore_torch_precision):
    make, want = PATHS[path]
    try:
        step = make(dataroot, tmp_path)
        profiler.reset_spans()
        step()      # with no profiler: nothing recorded
        assert profiler.span_table() == {}
        table, prof = _profiled(step)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert {k: (v["count"], v["parent"]) for k, v in table.items()} == want
    # no card: host times only
    assert all(v["host_s"] > 0 and v["device_s"] is None for v in table.values())
    assert table[STEP]["host_s"] >= sum(v["host_s"] for k, v in table.items()
                                        if v["parent"] == STEP)
    trace_path = str(tmp_path / "t.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith("himan.")}
    assert annotated == set(want)


def test_spans_off_record_nothing_and_cost_under_a_microsecond(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiler, "record_function", refused)
    profiler.reset_spans()
    for _ in range(3):
        with profiler.span("himan.step", timed=True), profiler.span("himan.step.forward"):
            torch.ones(2) + 1
    assert profiler.span_table() == {}

    def per_enter(make, n=20000):
        """The best of 10 rounds of ``with make():``, seconds each."""
        best = float("inf")
        for _ in range(10):
            t0 = time.perf_counter()
            for _ in range(n):
                with make():
                    pass
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    off = per_enter(lambda: profiler.span("himan.step", timed=True))
    bare = per_enter(contextlib.nullcontext)
    # 1 us, or on a machine so loaded that a bare context manager costs
    # more than an eighth of that, 8 of those
    assert off <= max(1e-6, 8 * bare), (off, bare)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: each ``record``
    reads a clock that advances 1 ms a record."""
    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self):
        self.at = self.clock[0]
        self.clock[0] += 1.0

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_only_timed_spans_record_event_pairs(monkeypatch):
    """As on a card (``torch.cuda`` stood in for): only a ``timed`` span
    records a pair of events, and its device time is theirs; while the
    stream captures a graph no span records."""
    made = []

    def event(enable_timing=False):
        made.append(_Event(enable_timing))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", event)

    def requests():
        for _ in range(2):
            with profiler.span("himan.infer", timed=True), profiler.span("himan.infer.encode"):
                pass

    table, _ = _profiled(requests)
    assert {k: (v["count"], v["device_s"]) for k, v in table.items()} == {
        "himan.infer": (2, pytest.approx(2e-3)), "himan.infer.encode": (2, None)}
    assert len(made) == 4 and all(e.at is not None for e in made)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    table, _ = _profiled(requests)
    assert table == {} and len(made) == 4


def test_spans_record_under_a_profiler_and_reset(monkeypatch):
    entered = []
    orig = profiler.record_function

    def spy(name):
        entered.append(name)
        return orig(name)

    monkeypatch.setattr(profiler, "record_function", spy)
    table, _ = _profiled(lambda: [_nested() for _ in range(2)])
    assert entered == ["himan.infer", "himan.infer.G"] * 2
    assert {k: (v["count"], v["parent"], v["device_s"]) for k, v in table.items()} == {
        "himan.infer": (2, None, None), "himan.infer.G": (2, "himan.infer", None)}
    assert list(table) == ["himan.infer", "himan.infer.G"]      # first entered first
    profiler.reset_spans()
    assert profiler.span_table() == {}


def _nested():
    with profiler.span("himan.infer"):
        with profiler.span("himan.infer.G"):
            torch.ones(4, 4) @ torch.ones(4, 4)


def test_write_spans(tmp_path):
    table, _ = _profiled(_nested)
    path = str(tmp_path / "spans.json")
    profiler.write_spans(path)
    with open(path) as f:
        assert json.load(f) == table


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

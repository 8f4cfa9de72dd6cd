"""The train loop's two input paths at steady state on one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.bench_loop \\
        [--scenes 400] [--steps 250] [--warmup 8] [--reps 2] [--dtype float32 bfloat16] \\
        [--bs 1 4] [--grain_workers 0 2 4 8] [--controls] [--seed 0] [--gpu_ids 0] \\
        [--out FILE] [train flags ...]

Counterpart of ``tools/bench_loop.py`` in the JAX package: the loop with
its real input pipeline. A Cityscapes-format dataroot of ``--scenes``
1024x512 scenes is made from ``--seed`` (label ids, instance ids of three
objects a scene, random RGB; PNG), and the flagship mask2image train
config at full width (bbox windows at fineSize 512; any other flag goes to
the train options) trains on it these ways:

  * streamed: the threaded loader (``nThreads 2``: PIL decode, windows
    and transforms on the host) and a copy a step from pageable memory,
    which waits for the card's queue to drain (``--device_prefetch 0``);
  * grain{W}: streamed likewise, the batches from the grain pipeline
    (``--data_backend grain --grain_workers W``, ``data/grain_pipeline.py``)
    for each W of ``--grain_workers`` up to the process's cores
    (``os.sched_getaffinity``): W decode processes, each batch back in
    shared memory (W = 0: decoded in the loop's own process);
  * prefetched: the same loader, each batch staged 2 batches ahead from
    pinned memory on a side stream (``--device_prefetch 2``);
  * fused resident: the dataset uploaded once, each batch sampled on the
    card inside the step (``train/steps.make_resident_train_step``).

``--controls`` adds paths that take one cost away at a time:

  * cached: streamed, over the first 8 batches of an epoch of the threaded
    loader decoded once and handed out in a cycle (no decode beside the
    loop, the same buffers every 8 steps);
  * grain{W}_nodecode, for each W > 0: grain's W workers stack 8 batches'
    samples decoded once in the parent into a new shared-memory batch each
    step, as grain{W} does (grain's handoff with no decode);
  * grain{W}_prefetched, for each W > 0: grain{W}'s batches staged as the
    prefetched path stages the threaded loader's.

For each ``--dtype`` and ``--bs``, each path is measured ``--reps`` times
in the order streamed, cached, then each grain{W} with its controls,
prefetched, fused, then the mirror of it, and each measurement is the ms
a step over ``--steps`` steps after ``--warmup`` steps, by
``train/profiler.measure_steps`` (the card synchronized before each clock
reading), so all paths are timed the same way. A loader measurement
starts a new epoch: its first batch, whose decode nothing hides, is
reported apart, and so is the loop's wait in ``next()`` over the timed
steps (for the loader's batch, or for the staged one; not the in-line
copy), and the in-line copy's ms a step (host clock, the card
synchronized first: a copy from pageable memory waits for the queue to
drain all the same, so the step is unchanged and the copy is timed alone
on the launching thread, with the card idle). Beside them: the resident
sampler's ms a batch (the same clock), the bytes one step of each path
copies host to device (``torch.profiler``'s Memcpy HtoD events) and its
kernels' device ms, hence each measurement's idle share, 1 - device ms /
ms a step (every loader path's device ms is the streamed path's: the same
step on batches of the same shapes). The report prints as JSON (and goes
to ``--out`` when given) with the card's name and power limit and the
process's core count.
``--gpu_ids -1`` runs it on the CPU (no copies, no device time: a test).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..configs.options import MaskToImageTrainOptions, parse_cli
from ..data.grain_pipeline import GrainLoader
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..train import loop as train_loop
from ..train.prefetch import H2DStager, device_prefetch, ready, to_device
from ..train.profiler import measure_steps
from ..train.state import make_optimizers
from ..train.steps import make_resident_train_step
from .roofline_resblock import card_line

SCENE_HW = (512, 1024)


def write_scene(root, i, seed, phase="train"):
    """Scene i of a Cityscapes-like dataroot, from (seed, i) alone: label
    ids (road, sky, a building or vegetation band, a stray band of any id),
    three objects (person, car, bicycle) with instance ids class*1000+k
    (mode 'I'), random RGB."""
    from PIL import Image

    h, w = SCENE_HW
    rng = np.random.RandomState([seed, i])
    label = np.full((h, w), 7, np.uint8)
    label[: h // 3] = 23
    label[h // 3 : h // 2] = rng.choice([11, 21])
    label[h // 2 : h // 2 + 8] = rng.randint(0, 35)
    inst = label.astype(np.int32)
    for k in range(3):
        cls = rng.choice([24, 26, 33])
        bh, bw = rng.randint(48, 160), rng.randint(64, 240)
        y0, x0 = rng.randint(h // 3, h - bh), rng.randint(0, w - bw)
        label[y0 : y0 + bh, x0 : x0 + bw] = cls
        inst[y0 : y0 + bh, x0 : x0 + bw] = cls * 1000 + k
    img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
    Image.fromarray(label).save(os.path.join(root, f"{phase}_label", f"{i:05d}.png"))
    Image.fromarray(inst, mode="I").save(os.path.join(root, f"{phase}_inst", f"{i:05d}.png"))
    Image.fromarray(img).save(os.path.join(root, f"{phase}_img", f"{i:05d}.png"))


def write_dataroot(root, n, seed=0, threads=8, phase="train"):
    """n scenes of ``write_scene`` under root, written on ``threads`` threads."""
    for sub in (f"{phase}_label", f"{phase}_inst", f"{phase}_img"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(lambda i: write_scene(root, i, seed, phase), range(n)))


def h2d_profile(fn, tmp, dev):
    """One call of fn() under torch.profiler -> (bytes of its Memcpy HtoD
    events, their count, its kernels' device ms)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(tmp, f"h2d_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
    return sum(int(e.get("args", {}).get("bytes", 0)) for e in copies), len(copies), kernels


def train_argv(dataroot, checkpoints_dir, bs, dtype, gpu_ids="0", extra=()):
    """The flagship mask2image train config's flags (full width unless
    ``extra`` overrides it)."""
    return ["--gpu_ids", gpu_ids, "--dataroot", dataroot, "--batchSize", str(bs),
            "--nThreads", "2", "--dtype", dtype, "--checkpoints_dir", checkpoints_dir,
            "--name", "bench_loop", *extra]


def resident_sampler(argv):
    """(sample_fn, data, n_samples) of the resident loader of ``argv``."""
    with contextlib.redirect_stdout(io.StringIO()):
        loader = CreateDataLoader(parse_cli(MaskToImageTrainOptions,
                                            argv + ["--device_resident_data"]))
    sample_fn, data = loader.fused_sampler()
    return sample_fn, data, loader.n_samples


def loader_ms(loader, step, state, dev, warmup, steps, depth):
    """One measurement of the loader's batches over a new epoch, staged
    ``depth`` batches ahead (0: copied in line) -> (ms a step, the first
    batch's wait, the waits over the timed steps, the in-line copies' ms
    over the timed steps, the last host batch). The wait is the loop's in
    ``next()``: for the loader, or for the staged batch; an in-line copy is
    not part of it."""
    src, waits, copies, last = iter(loader), [], [], {}
    it = None
    if depth > 0:
        stage = H2DStager(dev) if dev.type == "cuda" else (lambda hb: to_device(hb, dev))
        it = device_prefetch(src, stage, depth)

    def one(st, _):
        t = time.perf_counter()
        staged, last["hb"] = next(it) if it is not None else (None, next(src))
        waits.append((time.perf_counter() - t) * 1e3)
        if it is not None:
            return step(st, ready(staged))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        batch = to_device(last["hb"], dev)
        copies.append((time.perf_counter() - t) * 1e3)
        return step(st, batch)

    try:
        for _ in range(warmup):
            one(state, None)
        first = waits[0]
        del waits[:], copies[:]
        ms = measure_steps(one, state, None, iters=steps, device=dev) * 1e3
    finally:
        (it if it is not None else src).close()
    return ms, first, waits[1:], copies[1:], last["hb"]


CONTROL_BATCHES = 8   # the batches a control decodes once


class CachedBatches:
    """A loader stand-in: the first ``n`` batches of one epoch of ``loader``,
    decoded once, handed out in a cycle."""

    def __init__(self, loader, n=CONTROL_BATCHES):
        src = iter(loader)
        self.batches = list(itertools.islice(src, n))
        src.close()

    def __iter__(self):
        return (b for b in itertools.cycle(self.batches))


class Predecoded:
    """A dataset stand-in of ``dataset``'s length whose item i is its sample
    i % n, the first n decoded once here (forked workers inherit them)."""

    def __init__(self, dataset, n):
        self.size = len(dataset)
        self.samples = [dataset[i] for i in range(min(n, len(dataset)))]

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        return self.samples[i % len(self.samples)]


def cores() -> int:
    return len(os.sched_getaffinity(0))


def measure(argv, resident, dev, tmp, warmup, steps, reps, grain_workers=(),
            controls=False):
    """The paths of the config ``argv`` (its --batchSize and --dtype) ->
    a report row. ``resident``: ``resident_sampler``'s triple;
    ``grain_workers``: the grain paths' worker counts (those above the
    cores are left out); ``controls``: add the control paths."""
    opt = parse_cli(MaskToImageTrainOptions, argv)
    loader = CreateDataLoader(opt)
    if len(loader) < warmup + steps + 1:
        raise SystemExit(f"bench_loop: an epoch holds {len(loader)} batches of {opt.batchSize}; "
                         f"--warmup {warmup} + --steps {steps} need more --scenes")
    # path -> (loader, staging depth)
    paths = {"streamed": (loader, 0)}
    if controls:
        paths["cached"] = (CachedBatches(CreateDataLoader(opt)), 0)
    for w in [w for w in grain_workers if w <= cores()]:
        ld = CreateDataLoader(parse_cli(MaskToImageTrainOptions, argv + [
            "--data_backend", "grain", "--grain_workers", str(w)]))
        paths[f"grain{w}"] = (ld, 0)
        if controls and w > 0:
            ds = Predecoded(ld.dataset, CONTROL_BATCHES * opt.batchSize)
            paths[f"grain{w}_nodecode"] = (GrainLoader(ds, opt.batchSize, shuffle=False,
                                                       num_workers=w), 0)
            paths[f"grain{w}_prefetched"] = (ld, 2)
    paths["prefetched"] = (loader, 2)
    model = create_model(opt)
    step = train_loop.make_step_fn(opt, model)
    state = make_optimizers(opt, model, len(loader))
    sample_fn, data, n_samples = resident
    fused, _ = make_resident_train_step(
        model, sample_fn, n_samples, opt.batchSize,
        torch.bfloat16 if opt.dtype == "bfloat16" else None, seed=opt.seed)

    def fused_ms():
        for _ in range(warmup):
            fused(state, data)
        return measure_steps(fused, state, data, iters=steps, device=dev) * 1e3

    runs = {p: [] for p in [*paths, "fused"]}
    hb = None
    order = list(runs) + ([] if reps == 1 else list(runs)[::-1])
    for path in order * max(reps // 2, 1):
        if path != "fused":
            ld, depth = paths[path]
            ms, first, waits, copies, hb = loader_ms(ld, step, state, dev, warmup, steps, depth)
            runs[path].append(dict(ms_per_step=ms, first_batch_wait_ms=first,
                                   wait_ms_mean=float(np.mean(waits)),
                                   wait_ms_max=float(np.max(waits)),
                                   **({} if depth else {"copy_ms_mean": float(np.mean(copies))})))
        else:
            runs[path].append(dict(ms_per_step=fused_ms()))
    g = torch.Generator(dev).manual_seed(opt.seed)
    idx = torch.randperm(n_samples, device=dev, generator=g)[: opt.batchSize]
    sample_fn(data, idx, g)
    sample_ms = measure_steps(lambda *_: sample_fn(data, idx, g), None, None, iters=10,
                              device=dev) * 1e3
    s_bytes, s_copies, s_dev = h2d_profile(lambda: step(state, to_device(hb, dev)), tmp, dev)
    f_bytes, f_copies, f_dev = h2d_profile(lambda: fused(state, data), tmp, dev)
    for path in runs:
        for r in runs[path]:
            r["idle_share"] = max(0.0, 1.0 - (f_dev if path == "fused" else s_dev)
                                  / r["ms_per_step"])
    row = dict(dtype=opt.dtype, bs=opt.batchSize, window=[opt.fineSize, opt.fineSize],
               batches_an_epoch=len(loader), warmup=warmup, steps=steps, **runs,
               resident_sample_ms_per_batch=sample_ms,
               streamed_batch_bytes=sum(v.nbytes for v in hb.values()
                                        if isinstance(v, np.ndarray)),
               streamed_h2d_bytes_per_step=s_bytes, streamed_h2d_copies=s_copies,
               fused_h2d_bytes_per_step=f_bytes, fused_h2d_copies=f_copies,
               streamed_device_ms=s_dev, fused_device_ms=f_dev)
    del model, state, step, fused, loader, paths
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", type=int, default=400)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2, help="1, or an even number")
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--bs", nargs="+", type=int, default=[1, 4])
    ap.add_argument("--grain_workers", nargs="*", type=int, default=[0, 2, 4, 8],
                    help="the grain paths' decode processes (none: no grain path)")
    ap.add_argument("--controls", action="store_true",
                    help="add the cached, grain{W}_nodecode and grain{W}_prefetched paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpu_ids", default="0", help="0: the card; -1: the CPU")
    ap.add_argument("--out", default="", help="also write the report to this JSON file")
    args, extra = ap.parse_known_args(argv)
    if args.reps != 1 and args.reps % 2:
        sys.exit("bench_loop: --reps is 1 or even (each path twice, in mirrored order)")
    if args.gpu_ids == "-1":
        dev, card, kind = torch.device("cpu"), "cpu", "cpu"
    else:
        if not torch.cuda.is_available():
            sys.exit("bench_loop: no CUDA device (torch.cuda.is_available() is False)")
        dev, card, kind = torch.device("cuda", 0), card_line(), torch.cuda.get_device_name(0)
    report = dict(card=card, device=kind, cores=cores(), scenes=args.scenes,
                  scene_hw=list(SCENE_HW), seed=args.seed, train_flags=extra, rows=[])
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "city")
        t = time.perf_counter()
        write_dataroot(root, args.scenes, args.seed)
        report["dataroot_s"] = time.perf_counter() - t
        ckpt = os.path.join(tmp, "ckpt")
        t = time.perf_counter()
        resident = resident_sampler(train_argv(root, ckpt, 1, "float32", args.gpu_ids, extra))
        report["resident_upload_s"] = time.perf_counter() - t
        for dtype in args.dtype:
            for bs in args.bs:
                row = measure(train_argv(root, ckpt, bs, dtype, args.gpu_ids, extra),
                              resident, dev, tmp, args.warmup, args.steps, args.reps,
                              args.grain_workers, args.controls)
                print(json.dumps(row), flush=True)
                report["rows"].append(row)
    print(json.dumps(report))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's mask2image serving path on one CUDA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (any failure raises and the script exits non-zero):
  1. device   needs a CUDA card; prints its name and power limit
  2. build    compiles csrc/*.cu with nvcc for sm_90a (one nvcc per source,
              all at once) and prints the -Xptxas -v register/smem lines
  3. kernels  at the serving shapes (512x256, bs 1 and 8; fp32 and bf16)
              each kernel against its plain PyTorch version on the card:
              encode bit-exact in both pad modes, IN at the 5 generator
              shapes x 3 acts x residual within the stated tolerance;
              CUDA-event times of kernel, plain version and, for IN, the
              library call F.instance_norm (a yardstick only)
  4. serving  the port's mask2image_test CLI end to end at full width
              (label_nc 35, ngf 64, 4 downs, 9 resblocks at 1024 channels,
              bbox-crop windows at fineSize 512) on a seeded synthetic PNG
              dataroot of 4 images at 1024x512; launch counters are zeroed
              just before and read just after
  5. model    Pix2PixHDModel.inference at 512x256 fp32 (bs 1 and 8): kernel
              path vs plain path (max |diff| of the tanh output), ms/image,
              images/s, peak memory; one --norm batch forward at 256x128
              (the pad-0 encode mode)
The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from neurips18_hierchical_image_manipulation_tpu_torch.cli import mask2image_test
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import _build
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.models.pix2pixhd import Pix2PixHDModel

PKG = "neurips18_hierchical_image_manipulation_tpu_torch"
JAX_PKG = "neurips18_hierchical_image_manipulation_tpu"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# kernel vs plain version on the card
IN_FP32_ATOL = 1e-4         # Welford/Chan vs two-pass fp32 statistics
IN_BF16_RTOL = 2.0**-7      # one bf16 rounding of the same fp32 value may
IN_BF16_ATOL = 2.0**-7      # land one ulp apart when the stats differ
MODEL_ATOL = 1e-3           # tanh output after 27 IN sites, full-fp32 convs
SHAPES_512x256 = [(256, 512, 64), (128, 256, 128), (64, 128, 256), (32, 64, 512),
                  (16, 32, 1024)]


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over iters launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20):
    """Device time of fn() without host gaps: fn is captured once into a
    CUDA graph (after a warm-up on a side stream) and the replay is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, iters)


def same_bits(a, b):
    v = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(v), b.view(v))


# ---------------------------------------------------------------- bounds

def encode_bytes(b, h, w, nc, pad, itemsize):
    c = nc + 1 + 3
    read = b * h * w * (4 + 4 + 3 * itemsize) + b * 16
    write = b * (h + 2 * pad) * (w + 2 * pad) * c * itemsize
    return read + write, b * (h + 2 * pad) * (w + 2 * pad) * c


def in_bytes(n, hw, c, itemsize, residual):
    elems = n * hw * c
    return elems * itemsize * (2 + int(residual)) + 2 * n * c * 4, 8 * elems


def bound(bytes_, ops):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------- phases

def phase_build():
    t = time.time()
    _build.build_all(["encode", "instance_norm"])
    log(f"[build] nvcc sm_90a, 2 sources in parallel: {time.time() - t:.1f} s")
    for name in ("encode", "instance_norm"):
        info = _build.ptxas_info.get(name, "(already built)")
        for line in info.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                log(f"[build:{name}] {line.strip()}")


def encode_inputs(bs, h, w, dev, seed=0):
    batch = synthetic_batch(np.random.RandomState(seed), bs, hw=(h, w), label_nc=35)
    batch["label"][0, 0, :3] = [-1, 35, 200]  # out-of-range ids: zero rows
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def phase_kernels(dev, results):
    """Kernel vs plain on the card at the serving shapes, and times."""
    enc_rows, in_rows = [], []
    for bs in (1, 8):
        inp = encode_inputs(bs, 256, 512, dev)
        for dt in (torch.float32, torch.bfloat16):
            img = inp["image"].to(dt)
            for pad in (0, 3):
                args = (inp["label"], inp["inst"], img, inp["boxes"], 35)
                got = kenc.encode(*args, pad=pad)
                want = kenc.encode_plain(*args, pad=pad)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise AssertionError(f"encode mismatch bs{bs} {dt} pad{pad}")
                ms = graph_ms(lambda: kenc.encode(*args, pad=pad))
                pms = graph_ms(lambda: kenc.encode_plain(*args, pad=pad))
                nbytes, ops = encode_bytes(bs, 256, 512, 35, pad, img.element_size())
                bms, by = bound(nbytes, ops)
                row = dict(bs=bs, dtype=str(dt).split(".")[-1], pad=pad, ms=ms,
                           plain_ms=pms, bound_ms=bms, bound_by=by, bit_exact=True)
                enc_rows.append(row)
                log(f"[kernels] encode 512x256 {row}")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for bs in (1, 8):
        for h, w, c in SHAPES_512x256:
            x32 = torch.randn((bs, h, w, c), generator=gen, device=dev) * 2 + 0.5
            r32 = torch.randn((bs, h, w, c), generator=gen, device=dev)
            for dt in (torch.float32, torch.bfloat16):
                x, r = x32.to(dt), r32.to(dt)
                name = str(dt).split(".")[-1]
                for act in ("none", "relu", "lrelu"):
                    for res in (None, r):
                        y, mean, rstd = kin.instance_norm(x, act, res)
                        yp, mp, rp = kin.instance_norm_plain(x, act, res)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(mean, mp, atol=1e-5, rtol=1e-5)
                        torch.testing.assert_close(rstd, rp, atol=1e-5, rtol=1e-5)
                        err = (y.float() - yp.float()).abs().max().item()
                        if dt == torch.float32:
                            ok = err <= IN_FP32_ATOL
                        else:
                            ok = bool(((y.float() - yp.float()).abs()
                                       <= IN_BF16_ATOL + IN_BF16_RTOL * yp.float().abs()).all())
                        if not ok:
                            raise AssertionError(
                                f"IN mismatch {(bs, h, w, c)} {name} {act} "
                                f"res={res is not None}: max|diff| {err}")
                        max_err[name] = max(max_err[name], err)
                ms = graph_ms(lambda: kin.instance_norm(x, "relu"))
                pms = graph_ms(lambda: kin.instance_norm_plain(x, "relu"))
                lms = graph_ms(lambda: F.instance_norm(x.permute(0, 3, 1, 2), eps=1e-5))
                nbytes, ops = in_bytes(bs, h * w, c, x.element_size(), False)
                bms, by = bound(nbytes, ops)
                row = dict(shape=[bs, h, w, c], dtype=name, act="relu", ms=ms, plain_ms=pms,
                           library_ms=lms, bound_ms=bms, bound_by=by)
                in_rows.append(row)
                log(f"[kernels] instance_norm {row}")
    log(f"[kernels] IN max|kernel - plain|: {max_err} (fp32 limit {IN_FP32_ATOL})")
    results["kernel_rows"] = {"encode": enc_rows, "instance_norm": in_rows}
    results["in_max_err"] = max_err


def write_dataroot(root, n=4, h=512, w=1024, seed=0):
    """Cityscapes-like scenes: label ids 0..34 (uint8), inst = class id for
    stuff and class*1000+k for things (mode 'I'), random RGB."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("test_label", "test_inst", "test_img"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        label = np.full((h, w), 7, np.uint8)               # road
        label[: h // 3] = 23                               # sky
        label[h // 3 : h // 2] = rng.choice([11, 21])      # building / vegetation
        label[h // 2 : h // 2 + 8] = rng.randint(0, 35)    # a stray band of any id
        inst = label.astype(np.int32)
        for k in range(3):
            cls = rng.choice([24, 26, 33])                 # person, car, bicycle
            bh, bw = rng.randint(48, 160), rng.randint(64, 240)
            y0, x0 = rng.randint(h // 3, h - bh), rng.randint(0, w - bw)
            label[y0 : y0 + bh, x0 : x0 + bw] = cls
            inst[y0 : y0 + bh, x0 : x0 + bw] = cls * 1000 + k
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(label).save(os.path.join(root, "test_label", f"{i}.png"))
        Image.fromarray(inst, mode="I").save(os.path.join(root, "test_inst", f"{i}.png"))
        Image.fromarray(img).save(os.path.join(root, "test_img", f"{i}.png"))


def phase_serving(tmp, results):
    """The main path: the port's CLI end to end on the card."""
    root = os.path.join(tmp, "city")
    write_dataroot(root)
    outputs, sites = [], []
    orig_inference = Pix2PixHDModel.inference

    def checked_inference(self, batch):
        out = orig_inference(self, batch)
        outputs.append((tuple(out.shape), bool(torch.isfinite(out).all())))
        return out

    per_forward, arch = [], {}

    def record_site(module, args, kwargs, _out):
        if len(sites) < per_forward[0]:
            sites.append((tuple(args[0].shape), module.act, kwargs.get("residual") is not None))

    hooks = []
    orig_create = mask2image_test.create_model

    def create_and_hook(opt):
        model = orig_create(opt)
        g = model.netG
        per_forward.append(1 + 2 * g.n_downsampling + 2 * g.n_blocks)  # 27 at full width
        arch.update(ngf=g.conv_in.weight.shape[0], n_down=g.n_downsampling,
                    n_blocks=g.n_blocks)
        log(f"[serving] GlobalGenerator {sum(p.numel() for p in g.parameters())} params, "
            f"input_nc {model.generator_input_nc()}, {per_forward[0]} IN sites per forward")
        for m in g.modules():
            if isinstance(m, networks.NormAct):
                hooks.append(m.register_forward_hook(record_site, with_kwargs=True))
        return model

    argv = ["--name", "smoke", "--dataroot", root,
            "--checkpoints_dir", os.path.join(tmp, "ckpt"),
            "--results_dir", os.path.join(tmp, "results"),
            "--gpu_ids", "0", "--how_many", "4"]
    kenc.encode.launches = 0
    kin.instance_norm.launches = 0
    t = time.time()
    with mock.patch.object(Pix2PixHDModel, "inference", checked_inference), \
            mock.patch.object(mask2image_test, "create_model", create_and_hook):
        mask2image_test.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"encode": kenc.encode.launches, "instance_norm": kin.instance_norm.launches}
    for h in hooks:
        h.remove()
    web = os.path.join(tmp, "results", "smoke", "test_latest")
    with open(os.path.join(web, "index.html")) as f:
        rows = f.read().count("<h3>")
    # gallery files are named after the source image, so crops of one
    # image share a name; the page keeps one row per result
    synth = [n for n in os.listdir(os.path.join(web, "images"))
             if n.endswith("_synthesized_image.png")]
    log(f"[serving] CLI wall {wall:.1f} s (incl. model init + data), outputs {outputs}")
    log(f"[serving] launches {launches}; {rows} gallery rows, {len(synth)} image files")
    if rows != 4 or not synth:
        raise AssertionError(f"gallery incomplete: {rows} rows, files {synth}")
    if len(outputs) != 4 or not all(f for _, f in outputs):
        raise AssertionError(f"non-finite or missing outputs: {outputs}")
    if launches["encode"] < 1 or launches["instance_norm"] != per_forward[0] * len(outputs):
        raise AssertionError(f"launch counts off the serving path: {launches}")
    if len(sites) != per_forward[0]:
        raise AssertionError(f"expected {per_forward[0]} IN sites per forward, saw {len(sites)}")
    if sites != generator_sites(*outputs[0][0][:3], **arch):
        raise AssertionError(f"IN sites off the architecture: {sites}")
    results["serving"] = dict(wall_s=wall, outputs=outputs, launches=launches)
    results["launches"] = launches
    results["sites"] = sites
    return sites, outputs[0][0]


@contextlib.contextmanager
def plain_path():
    """Route the model through the plain versions (comparison only)."""
    with mock.patch.object(kenc, "encode", kenc.encode_plain), \
            mock.patch.object(kin, "instance_norm", kin.instance_norm_plain):
        yield


def generator_sites(bs, h, w, ngf=64, n_down=4, n_blocks=9):
    """(shape, act, residual?) of every IN site of one GlobalGenerator
    forward, in order: stem, downs, 2 per resblock, ups (27 at full width)."""
    sites = [((bs, h, w, ngf), "relu", False)]
    sites += [((bs, h >> i, w >> i, ngf << i), "relu", False) for i in range(1, n_down + 1)]
    mid = (bs, h >> n_down, w >> n_down, ngf << n_down)
    for _ in range(n_blocks):
        sites += [(mid, "relu", False), (mid, "none", True)]
    sites += [((bs, h >> i, w >> i, ngf << i), "relu", False) for i in range(n_down - 1, -1, -1)]
    return sites


def time_in_sites(dev, sites, seed):
    """Run every IN site of a forward (each with its own fp32 tensors) through
    the kernel and the plain version; check them; time the whole sequence as
    device time (graph replay). library_ms: F.instance_norm on the same
    inputs, IN alone (it has no residual/activation epilogue)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    calls, nbytes, ops, err = [], 0, 0, 0.0
    for shape, act, has_res in sites:
        x = torch.randn(shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev) if has_res else None
        y = kin.instance_norm(x, act, r)[0]
        yp = kin.instance_norm_plain(x, act, r)[0]
        torch.cuda.synchronize()
        err = max(err, (y - yp).abs().max().item())
        calls.append((x, act, r))
        b, o = in_bytes(shape[0], shape[1] * shape[2], shape[3], 4, has_res)
        nbytes, ops = nbytes + b, ops + o
    if err > IN_FP32_ATOL:
        raise AssertionError(f"IN mismatch over the forward's sites: {err}")

    def run(fn):
        return lambda: [fn(x, a, r) for x, a, r in calls]

    bms, by = bound(nbytes, ops)
    return dict(
        max_abs_err=err,
        ms=graph_ms(run(kin.instance_norm)),
        eager_ms=cuda_ms(run(kin.instance_norm), 20),
        plain_ms=graph_ms(run(kin.instance_norm_plain)),
        library_ms=graph_ms(run(lambda x, a, r: F.instance_norm(x.permute(0, 3, 1, 2)))),
        bound_ms=bms, bound_by=by, bytes=nbytes,
        per=f"the {len(sites)} IN sites of one forward, fp32 "
            "(library_ms: IN alone, no epilogue)",
    )


def phase_forward_sites(dev, results):
    """IN over one 512x256 forward (27 launches) and encode (1 launch), bs 1
    and 8, fp32 — the table of PERF.md."""
    rows = []
    for bs in (1, 8):
        row = dict(bs=bs, **time_in_sites(dev, generator_sites(bs, 256, 512), seed=4))
        rows.append(row)
        log(f"[forward 512x256] instance_norm x27 {row}")
        inp = encode_inputs(bs, 256, 512, dev)
        args = (inp["label"], inp["inst"], inp["image"], inp["boxes"], 35)
        bms, by = bound(*encode_bytes(bs, 256, 512, 35, 3, 4))
        erow = dict(bs=bs, name="encode pad 3", ms=graph_ms(lambda: kenc.encode(*args, pad=3)),
                    plain_ms=graph_ms(lambda: kenc.encode_plain(*args, pad=3)),
                    bound_ms=bms, bound_by=by)
        rows.append(erow)
        log(f"[forward 512x256] {erow}")
    results["forward_512x256"] = rows


def phase_main_path_kernels(dev, sites, out_shape, results):
    """JSON rows: each kernel timed on the inputs the serving path gives it
    (one 512x512 bbox window, bs 1, fp32)."""
    h, w = out_shape[1:3]
    inp = encode_inputs(1, h, w, dev, seed=3)
    args = (inp["label"], inp["inst"], inp["image"], inp["boxes"], 35)
    got, want = kenc.encode(*args, pad=3), kenc.encode_plain(*args, pad=3)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("encode mismatch at the serving shape")
    err = (got - want).abs().max().item()
    nbytes, ops = encode_bytes(1, h, w, 35, 3, 4)
    bms, by = bound(nbytes, ops)
    enc = dict(
        name="encode", route="cuda", source=f"{PKG}/csrc/encode.cu",
        replaces=f"{JAX_PKG}/ops/pallas/encode.py:205",
        also_replaces=[f"{JAX_PKG}/ops/pallas/encode.py:142"],
        launches=results["launches"]["encode"], max_abs_err=err,
        ms=graph_ms(lambda: kenc.encode(*args, pad=3), 50),
        eager_ms=cuda_ms(lambda: kenc.encode(*args, pad=3), 50),
        plain_ms=graph_ms(lambda: kenc.encode_plain(*args, pad=3)),
        bound_ms=bms, bound_by=by, library_ms=None,
        per=f"one (1, {h}, {w}) bbox window, pad 3, fp32",
    )
    inn = dict(
        name="instance_norm", route="cuda", source=f"{PKG}/csrc/instance_norm.cu",
        replaces=f"{JAX_PKG}/ops/pallas/instance_norm.py:118",
        launches=results["launches"]["instance_norm"],
        **time_in_sites(dev, sites, seed=2),
    )
    for row in (enc, inn):
        row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
        log(f"[main-path kernel] {row}")
    return [enc, inn]


def phase_model(dev, results):
    opt = MaskToImageTestOptions(gpu_ids="0")
    model = create_model(opt)
    nparams = sum(p.numel() for p in model.netG.parameters())
    log(f"[model] GlobalGenerator params {nparams}, precision {model.conv_precision_resolved}")
    rows = []
    for bs, iters in ((1, 10), (8, 3)):
        batch = encode_inputs(bs, 256, 512, dev, seed=5)
        out = model.inference(batch)
        with plain_path():
            ref = model.inference(batch)
        torch.cuda.synchronize()
        diff = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or diff > MODEL_ATOL:
            raise AssertionError(f"model bs{bs}: kernel vs plain max|diff| {diff}")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            model.inference(batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            model.inference(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / iters * 1e3
        with plain_path():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                model.inference(batch)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t) / iters * 1e3
        row = dict(bs=bs, hw=[256, 512], dtype="float32", precision="highest",
                   ms_per_batch=ms, ms_per_image=ms / bs, images_per_s=bs * 1e3 / ms,
                   plain_ms_per_batch=plain, max_abs_diff_vs_plain=diff,
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        rows.append(row)
        log(f"[model] {row}")
    # TF32 convolutions (the --dtype bfloat16 / --conv_precision default tier)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    batch = encode_inputs(8, 256, 512, dev, seed=5)
    ms = cuda_ms(lambda: model.inference(batch), 3)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows.append(dict(bs=8, hw=[256, 512], dtype="float32", precision="default (TF32)",
                     ms_per_batch=ms, ms_per_image=ms / 8, images_per_s=8e3 / ms))
    log(f"[model] {rows[-1]}")
    del model
    # --norm batch: the unpadded (pad 0) encode mode, BASELINE config 1 size
    mb = create_model(MaskToImageTestOptions(gpu_ids="0", norm="batch"))
    batch = encode_inputs(1, 128, 256, dev, seed=6)
    before = kenc.encode.launches
    out = mb.inference(batch)
    launched = kenc.encode.launches - before
    with plain_path():
        ref = mb.inference(batch)
    torch.cuda.synchronize()
    diff = (out - ref).abs().max().item()
    if launched != 1 or not torch.isfinite(out).all() or diff > MODEL_ATOL:
        raise AssertionError(f"--norm batch forward: diff {diff}")
    log(f"[model] --norm batch 256x128: out {tuple(out.shape)}, max|diff| vs plain {diff}")
    results["model"] = rows
    results["norm_batch_max_abs_diff"] = diff


def phase_profile(dev, results):
    """Device time by kernel name over one bs-1 512x256 forward."""
    from torch.profiler import ProfilerActivity, profile

    model = create_model(MaskToImageTestOptions(gpu_ids="0"))
    batch = encode_inputs(1, 256, 512, dev, seed=7)
    for _ in range(2):
        model.inference(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.inference(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    log(table)
    results["profile_table"] = table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true", help="add a torch.profiler table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    results = {"card": card}
    t0 = time.time()
    phase_build()
    phase_kernels(dev, results)
    with tempfile.TemporaryDirectory() as tmp:
        sites, out_shape = phase_serving(tmp, results)
    kernels = phase_main_path_kernels(dev, sites, out_shape, results)
    phase_forward_sites(dev, results)
    phase_model(dev, results)
    if args.profile:
        phase_profile(dev, results)
    results["kernels"] = kernels
    results["seconds"] = time.time() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

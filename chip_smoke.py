"""Drive the PyTorch port's mask2image serving and training paths on one
CUDA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, run in the order 1-4, 9, 5, 6, 10, 11, 7, 8, 12 (any failure raises
and the script exits non-zero):
  1. device   needs a CUDA card; prints its name and power limit
  2. build    compiles every csrc/*.cu with nvcc for sm_90a (one nvcc per
              source, all at once) and prints the -Xptxas -v register/smem
              lines
  3. kernels  at the serving shapes (512x256, bs 1 and 8; fp32 and bf16)
              each serving kernel against its plain PyTorch version on the
              card: encode bit-exact in both pad modes, IN at the 5
              generator shapes (bs 1 and 8), the 6 discriminator shapes (N
              1 and 2) and three odd ones x 3 acts x residual within the
              stated tolerance, each call on the variant
              kernels/instance_norm._fwd_plan picks (cluster or split) and
              the same bits on a second run; CUDA-event times of kernel,
              plain version and, for IN, the library call F.instance_norm
              (a yardstick only)
  4. kernels (train)  each training kernel against its plain version, fp32
              and bf16: the IN backward at the 5 generator and 6
              discriminator shapes of a 512x256 step (N 1 and 2) and a tiny
              odd one x 3 acts x residual, each call on the variant
              kernels/instance_norm._bwd_plan picks (cluster or split) and
              the same bits on a second run, and the wrapper's host time a
              call (1000 calls); the reflect-pad backward at the resblock and head
              pads, one tile with overlapping mirrors and two odd channel
              counts, each on the variant kernels/reflect_pad._plan picks
              (bulk or gather), the same bits on a second run; MSE/L1 at the D-logit,
              FM-feature and VGG-tap sizes (each a group of one), encode_cond
              at 512x256; times beside the library call
  5. serving  (main path 1) the port's mask2image_test CLI end to end at
              full width (label_nc 35, ngf 64, 4 downs, 9 resblocks at 1024
              channels, bbox-crop windows at fineSize 512) on a seeded
              synthetic PNG dataroot of 4 images at 1024x512; launch
              counters are zeroed just before and read just after, the IN
              forward's per variant held to _fwd_plan
  6. train CLI  (main path 2) the port's mask2image_train CLI at full width
              (G as above, 2-scale 3-layer PatchGAN, VGG19, LSGAN + FM +
              VGG, Adam) on the same kind of dataroot, bs 1, one epoch;
              counters zeroed before and read after, and held to the
              per-step launch counts of the architecture (the loss kernel:
              terms reduced, and group launches, one a loss), the IN
              forward's, the IN backward's and the reflect-pad backward's
              per variant to their plans' split of the recorded calls; every loss
              finite; latest_params.npz loaded back into the serving model
              for one inference
  7. model    Pix2PixHDModel.inference at 512x256 fp32 (bs 1 and 8): kernel
              path vs plain path (max |diff| of the tanh output), ms/image,
              images/s, peak memory; one --norm batch forward at 256x128
              (the pad-0 encode mode)
  8. step     make_train_step at 512x256 fp32, bs 1 and 4: ms/step,
              images/s, peak memory, the plain path's ms/step, per-variant
              launches of one step against the plans (the loss groups
              against the architecture's count); from the same
              parameters one step's loss terms and every G/D gradient
              leaf on the kernel path against the plain path
  9. conv_in  the fused conv3x3 + IN kernel against its plain version, fp32
              and bf16, at the generator bottleneck (1, 16, 32, 1024) with
              and without residual and ReLU, an odd shape, the JAX test
              shape and the wgmma kernel's cases (CONV_IN_SHAPES), each call
              on the variant kernels/conv_in._plan picks; the same bits on a
              second run; its autograd gradient
              against the plain one; times beside the bound, the plain
              version and the library composition (reflect pad, cuDNN conv,
              F.instance_norm: no single PyTorch call computes it)
 10. train CLI bf16  (main path 3) the train CLI at full width under --dtype
              bfloat16 --pool_size 50 --display_freq 4 for one epoch, then
              --continue_train from its latest for a second; counters zeroed
              before and read after each run and held to the per-step counts
              of the pooled step, the loss groups among them; web/index.html,
              iter.txt
 11. roofline (main path 4) the port's resblock roofline tool at bs 32
              (tools/roofline_resblock.py, few iterations): counters zeroed
              before and read after; the fused kernel must have launched,
              every call as the wgmma variant, every pad's backward as the
              bulk variant
 12. step bf16  make_train_step in the bf16 tier at 512x256, bs 1 and 4:
              ms/step, images/s, peak memory, per-step launches of every
              kernel (per variant where a kernel has several); the IN
              forward, the reflect-pad backward and the loss groups timed
              over the calls of one bs-1 bf16 step
With --profile: torch.profiler tables of one serving forward and of train
steps at 512x256 bs 1.
The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from neurips18_hierchical_image_manipulation_tpu_torch.cli import (
    mask2image_test,
    mask2image_train,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import synthetic_batch
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import _build
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
from neurips18_hierchical_image_manipulation_tpu_torch.models.pix2pixhd import Pix2PixHDModel
from neurips18_hierchical_image_manipulation_tpu_torch.tools import roofline_resblock
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import make_train_step
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import restore_params
from neurips18_hierchical_image_manipulation_tpu_torch.utils.visualizer import Visualizer

PKG = "neurips18_hierchical_image_manipulation_tpu_torch"
JAX_PKG = "neurips18_hierchical_image_manipulation_tpu"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# kernel vs plain version on the card
IN_FP32_ATOL = 1e-4         # Welford/Chan vs two-pass fp32 statistics
IN_BF16_RTOL = 2.0**-7      # one bf16 rounding of the same fp32 value may
IN_BF16_ATOL = 2.0**-7      # land one ulp apart when the stats differ
MODEL_ATOL = 1e-3           # tanh output after 27 IN sites, full-fp32 convs
# training kernels vs their plain versions: the same fp32 arithmetic summed
# in another order (bf16: one rounding of nearly equal fp32 values)
IN_BWD_FP32_ATOL = 1e-5     # dx is O(1) here
PAD_FP32_ATOL = 1e-5        # sums of at most 9 O(1) values
LOSS_RTOL = 1e-5            # one fp32 sum of up to 8.4M terms, other order
BF16_RTOL = BF16_ATOL = 2.0**-7
# the whole step, kernel path vs plain path, from the same parameters, with
# full-fp32 deterministic convolutions (see compare_step):
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-4        # one backward kernel swapped for its plain version,
                            # of each gradient leaf's max |g| (measured <= 1e-5)
STEP_SENS_FACTOR = 2.0      # the whole path, against the 1-ulp sensitivity
# conv3x3_in_act vs its plain version: fp32, the same conv and two-pass
# statistics summed in another order (the JAX Pallas test's tolerance);
# bf16, two ulps of max(|y|, 1) against the plain version on the fp32 values
# of the same bf16 inputs (the plain version in bf16 rounds the pre-norm
# conv to bf16 before the statistics, which the kernel never does)
CONV_IN_ATOL, CONV_IN_RTOL = 3e-5, 1e-4
CONV_IN_BF16_ULPS = 2
# (N, H, W, Cin, Cout): the bottleneck at bs 1 (bf16: the mma.sync kernel;
# fp32: K split 8 ways, three launches), an odd shape (fp32: 2 tiles, the
# two-launch epilogue), the JAX test shape, channel counts that are
# not multiples of 8 (the mma kernel's scalar loads); for the wgmma kernel
# (kernels/conv_in._plan): the bottleneck at bs 4 (a 4-block cluster), H*W
# not a multiple of 128 with Cin not one of 64 (9x17, 96 -> 40: 2-block
# clusters), and H*W > 1024 (16 tiles: the two-launch epilogue, in fp32 too);
# channel counts that are not multiples of 4 (the fp32 kernel's 4-byte
# copies, a plane of one tile). The roofline path checks bs 32.
CONV_IN_SHAPES = [(1, 16, 32, 1024, 1024), (2, 9, 17, 96, 40), (2, 8, 16, 128, 128),
                  (1, 5, 7, 12, 20), (4, 16, 32, 1024, 1024), (64, 9, 17, 96, 40),
                  (16, 32, 48, 64, 64), (1, 6, 9, 7, 10)]
ROOFLINE_ARGV = ["--batch", "32", "--iters", "5", "--warmup", "2"]
SHAPES_512x256 = [(256, 512, 64), (128, 256, 128), (64, 128, 256), (32, 64, 512),
                  (16, 32, 1024)]
# the IN sites of one D apply at 512x256 (scale 0, then scale 1)
D_SHAPES_512x256 = [(65, 129, 128), (33, 65, 256), (34, 66, 512),
                    (33, 65, 128), (17, 33, 256), (18, 34, 512)]
STEP_HW = (256, 512)
DATAROOT_HW = (512, 1024)
GPU_IDS = "0"
ARCH = {}        # model overrides (empty: the full-width defaults)
ARCH_ARGV = []   # the same as CLI flags
ACTS = ("none", "relu", "lrelu")
TRAIN_KERNELS = ("encode_cond", "instance_norm_bwd", "mse_to_scalar", "l1_to_scalar",
                 "reflect_pad_bwd")


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
    CUDA graph (on the side stream of its warm-up) and the replay is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
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


def bound(bytes_, ops, ops_per_s=FP32_OPS_PER_S):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def in_bwd_bytes(shape, itemsize, act, want_dres):
    """x, g (and y for a masked act) read once, dx (and dres) written once,
    the fp32 mean/rstd read; ~12 operations an element."""
    n, h, w, c = shape
    elems = n * h * w * c
    return elems * itemsize * (3 + int(act != "none") + int(want_dres)) + 2 * n * c * 4, 12 * elems


def pad_bwd_bytes(dy_shape, pad, itemsize):
    n, hp, wp, c = dy_shape
    dy = n * hp * wp * c
    dx = n * (hp - 2 * pad) * (wp - 2 * pad) * c
    return (dy + dx) * itemsize, dy


def loss_bytes(numel, itemsize, two_operands):
    return numel * itemsize * (1 + int(two_operands)), 3 * numel


def cond_bytes(b, h, w, width, itemsize):
    """label and inst (int32) read, the width-channel conditioning written."""
    return b * h * w * (8 + width * itemsize), b * h * w * width


def conv_in_bound(shape, dtype, residual):
    """x, w, b (fp32), the residual read once and y written once; the
    conv's multiply-adds at the dtype's peak (bf16 tensor cores, fp32
    outside them)."""
    n, h, w, cin, cout = shape
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = item * (n * h * w * (cin + cout * (1 + int(residual))) + 9 * cin * cout) + 4 * cout
    ops = 2 * n * h * w * 9 * cin * cout
    return bound(nbytes, ops, BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S)


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    return {
        "encode": kenc.encode, "encode_cond": kenc.encode_cond,
        "instance_norm": kin.instance_norm, "instance_norm_bwd": kin.instance_norm_bwd,
        "mse_to_scalar": klosses.mse_to_scalar, "l1_to_scalar": klosses.l1_to_scalar,
        "reflect_pad_bwd": krp.reflect_pad_bwd, "conv3x3_in_act": kconv.conv3x3_in_act,
    }


def read_launches():
    return {k: f.launches for k, f in counters().items()}


def read_variants():
    """Launches per variant of the kernels that have several."""
    return {k: dict(f.variants) for k, f in counters().items() if hasattr(f, "variants")}


def zero_launches():
    for f in counters().values():
        f.launches = 0
        for v in getattr(f, "variants", {}):
            f.variants[v] = 0


def plan_variant(kind, call):
    """The variant the kernel's plan picks for one recorded call."""
    if kind == "reflect_pad_bwd":
        (n, hp, wp, c), dt, pad = call
        return krp._plan(n, hp - 2 * pad, wp - 2 * pad, c, pad, dt)["variant"]
    shape, dt = call[:2]
    plan = kin._fwd_plan if kind == "instance_norm" else kin._bwd_plan
    return plan(*shape, dt)["variant"]


def plan_variants(kind, calls, groups=()):
    """The launches per variant that the kernel's plan (kernels/instance_norm
    ._fwd_plan, ._bwd_plan, kernels/reflect_pad._plan) reckons for recorded
    calls of one kernel; for the loss kernel, the recorded groups that hold
    a term of its mode."""
    if kind in ("mse_to_scalar", "l1_to_scalar"):
        mode = "mse" if kind == "mse_to_scalar" else "l1"
        return {"group": sum(any(t[0] == mode for t in g) for g in groups)}
    want = {v: 0 for v in counters()[kind].variants}
    for call in calls:
        want[plan_variant(kind, call)] += 1
    return want


PLANNED = ("instance_norm", "instance_norm_bwd", "reflect_pad_bwd")


def expect_variants(calls, what, since=None):
    """Every kernel with a plan launched as its plan reckons for its
    recorded calls (per-variant counts since `since`, else since zero); the
    loss kernel's group launches, one for each recorded group."""
    got = read_variants()
    for kind, counts in got.items():
        if kind not in calls:
            continue
        if since is not None:
            counts = {k: v - since[kind][k] for k, v in counts.items()}
        expect_launches(counts, plan_variants(kind, calls[kind], calls.get("loss_group", ())),
                        f"{what}, {kind} variants")
    return got


def twice_on(kind, variant, fn, what):
    """fn() twice -> both results, after checking that the two launches of
    `kind` both went to `variant` (its plan's pick)."""
    before = read_variants()[kind]
    results = fn(), fn()
    after = read_variants()[kind]
    if {k: after[k] - before[k] for k in after} != dict({k: 0 for k in after}, **{variant: 2}):
        raise AssertionError(f"{what}: variants {before} -> {after}, plan {variant}")
    return results


def expect_launches(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


@contextlib.contextmanager
def recording():
    """Record the arguments' shapes of every call of a training kernel's
    wrapper (a call on a CPU tensor too), by kernel name."""
    calls = {k: [] for k in ("instance_norm", "loss_group") + TRAIN_KERNELS}

    class Recorder:
        """Stands in for a wrapper; a wrapper finds its own launch counter
        through its module's global name, so ``launches`` is forwarded."""

        def __init__(self, name, orig, describe):
            self.name, self.orig, self.describe = name, orig, describe

        def __call__(self, *a, **k):
            calls[self.name].append(self.describe(*a, **k))
            return self.orig(*a, **k)

        @property
        def launches(self):
            return self.orig.launches

        @launches.setter
        def launches(self, n):
            self.orig.launches = n

        @property
        def variants(self):
            return self.orig.variants

    def rec(mod, name, describe):
        return mock.patch.object(mod, name, Recorder(name, getattr(mod, name), describe))

    reduce_group = klosses.reduce_group

    def rec_group(terms):
        """One loss launch: its terms (mode, shape, dtype, scalar target or
        None), and each term as a call of mse_to_scalar / l1_to_scalar."""
        table = [(m, tuple(a.shape), a.dtype, None if torch.is_tensor(t) else float(t))
                 for m, a, t in terms]
        calls["loss_group"].append(table)
        for m, shape, dt, t in table:
            if m == "mse":
                calls["mse_to_scalar"].append((shape, dt, t))
            else:
                calls["l1_to_scalar"].append((shape, dt))
        return reduce_group(terms)

    with rec(kin, "instance_norm",
             lambda x, act="none", residual=None, eps=kin.EPS:
             (tuple(x.shape), x.dtype, act, residual is not None)), \
            rec(kin, "instance_norm_bwd",
             lambda x, y, g, mean, rstd, act="none", want_dres=False:
             (tuple(x.shape), x.dtype, act, bool(want_dres))), \
            rec(krp, "reflect_pad_bwd", lambda dy, pad: (tuple(dy.shape), dy.dtype, pad)), \
            mock.patch.object(klosses, "reduce_group", rec_group), \
            rec(kenc, "encode_cond",
                lambda label, inst, nc, dtype=torch.float32:
                (tuple(label.shape), inst is not None, nc, dtype)):
        yield calls


# ---------------------------------------------------------------- phases

def phase_build():
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    t = time.time()
    _build.build_all(sources)
    log(f"[build] nvcc sm_90a, {len(sources)} sources in parallel ({', '.join(sources)}): "
        f"{time.time() - t:.1f} s")
    for name in sources:
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
    # the generator's sites at bs 1 and 8 (timed), the discriminator's at N
    # 1 and 2, a tiny one and channel counts off the 16-byte vectors
    shapes = [(bs, *sh) for bs in (1, 8) for sh in SHAPES_512x256] + [
        (n, *sh) for n in (1, 2) for sh in D_SHAPES_512x256] + [(1, 5, 7, 48), (2, 5, 7, 3),
                                                                 (1, 9, 11, 100)]
    for shape in shapes:
        bs, h, w, c = shape
        x32 = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        r32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), r32.to(dt)
            name = str(dt).split(".")[-1]
            variant = kin._fwd_plan(*shape, dt)["variant"]
            for act in ("none", "relu", "lrelu"):
                for res in (None, r):
                    what = f"IN {shape} {name} {act} res={res is not None}"
                    (y, mean, rstd), again = twice_on(
                        "instance_norm", variant, lambda: kin.instance_norm(x, act, res), what)
                    yp, mp, rp = kin.instance_norm_plain(x, act, res)
                    torch.cuda.synchronize()
                    if not all(same_bits(a, b) for a, b in zip((y, mean, rstd), again)):
                        raise AssertionError(f"{what}: two runs differ")
                    torch.testing.assert_close(mean, mp, atol=1e-5, rtol=1e-5)
                    torch.testing.assert_close(rstd, rp, atol=1e-5, rtol=1e-5)
                    err = (y.float() - yp.float()).abs().max().item()
                    if dt == torch.float32:
                        ok = err <= IN_FP32_ATOL
                    else:
                        ok = bool(((y.float() - yp.float()).abs()
                                   <= IN_BF16_ATOL + IN_BF16_RTOL * yp.float().abs()).all())
                    if not ok:
                        raise AssertionError(f"{what}: max|diff| {err}")
                    max_err[name] = max(max_err[name], err)
            if shape[1:] not in SHAPES_512x256 or bs not in (1, 8):
                continue
            ms = graph_ms(lambda: kin.instance_norm(x, "relu"))
            pms = graph_ms(lambda: kin.instance_norm_plain(x, "relu"))
            lms = graph_ms(lambda: F.instance_norm(x.permute(0, 3, 1, 2), eps=1e-5))
            nbytes, ops = in_bytes(bs, h * w, c, x.element_size(), False)
            bms, by = bound(nbytes, ops)
            row = dict(shape=[bs, h, w, c], dtype=name, act="relu", ms=ms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by,
                       plan=kin._fwd_plan(*shape, dt))
            in_rows.append(row)
            log(f"[kernels] instance_norm {row}")
    log(f"[kernels] IN max|kernel - plain|: {max_err} (fp32 limit {IN_FP32_ATOL})")
    results["kernel_rows"] = {"encode": enc_rows, "instance_norm": in_rows}
    results["in_max_err"] = max_err


def check_close(got, want, dt, fp32_atol, what, rtol=0.0):
    """max |got - want| within fp32_atol (+ rtol*|want|) in fp32, one bf16
    rounding apart in bf16; returns the max |diff|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dt == torch.float32:
        ok = bool((diff <= fp32_atol + rtol * want.abs()).all())
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    err = diff.max().item()
    if not ok:
        raise AssertionError(f"{what}: kernel vs plain max|diff| {err}")
    return err


def library_in_bwd(x, gy):
    """The library yardstick: the backward of F.instance_norm (IN alone, no
    activation or residual) on the same x and cotangent, as the one aten
    call its autograd makes, on the NCHW (1, N*C, H, W) view instance_norm
    takes (called directly: an autograd backward would run on the
    forward's stream, outside a graph captured on another)."""
    n, h, w, c = x.shape
    xr = x.permute(0, 3, 1, 2).contiguous().view(1, n * c, h, w)
    gr = gy.permute(0, 3, 1, 2).contiguous().view(1, n * c, h, w)
    _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(
        xr, None, None, None, None, True, 0.0, 1e-5)
    return lambda: torch.ops.aten.native_batch_norm_backward(
        gr, xr, None, None, None, save_mean, save_invstd, True, 1e-5, [True, False, False])


def library_pad_bwd(dy, pad):
    n, hp, wp, c = dy.shape
    x = torch.empty((n, hp - 2 * pad, wp - 2 * pad, c), dtype=dy.dtype, device=dy.device)
    return lambda: torch.ops.aten.reflection_pad2d_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), [pad] * 4)


def in_bwd_host_us(dev, calls=1000):
    """Host time of one IN backward call at the generator bottleneck (relu),
    fp32 and bf16: the host clock over `calls` calls after a sync (the
    enqueue rate; the kernel itself takes less)."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 16, 32, 1024), device=dev).to(dt)
        gy = torch.randn_like(x)
        y, mean, rstd = kin.instance_norm(x, "relu")
        kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")
        out[str(dt)[6:]] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    return out


def phase_train_kernels(dev, results):
    """Each training kernel against its plain version on the card, fp32 and
    bf16, and its times beside the library call (one site at a time)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    errs, rows = {}, []

    def keep(name, dt, err):
        key = f"{name}/{str(dt).split('.')[-1]}"
        errs[key] = max(errs.get(key, 0.0), err)

    # the 5 generator sites (among them the cluster of 16 at 64x128x256 fp32
    # and the split sites 256x512x64, 128x256x128), the 12 discriminator
    # sites and a tiny odd one
    in_shapes = [(1, *sh) for sh in SHAPES_512x256] + [
        (n, *sh) for n in (1, 2) for sh in D_SHAPES_512x256] + [(1, 5, 7, 48)]
    for shape in in_shapes:
        x32 = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        r32 = torch.randn(shape, generator=gen, device=dev)
        g32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, r, gy = x32.to(dt), r32.to(dt), g32.to(dt)
            for act in ACTS:
                for res in (None, r):
                    y, mean, rstd = kin.instance_norm(x, act, res)
                    what = f"IN bwd {shape} {dt} {act} res={res is not None}"
                    got, again = twice_on(
                        "instance_norm_bwd", kin._bwd_plan(*shape, dt)["variant"],
                        lambda: kin.instance_norm_bwd(x, y, gy, mean, rstd, act, res is not None),
                        what)
                    want = kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, act, res is not None)
                    if not same_bits(got[0], again[0]):
                        raise AssertionError(f"{what}: two runs differ")
                    keep("instance_norm_bwd", dt, check_close(got[0], want[0], dt,
                                                              IN_BWD_FP32_ATOL, what))
                    if res is not None:
                        keep("instance_norm_bwd", dt, check_close(got[1], want[1], dt,
                                                                  IN_BWD_FP32_ATOL, what))
            y, mean, rstd = kin.instance_norm(x, "relu")
            bms, by = bound(*in_bwd_bytes(shape, x.element_size(), "relu", False))
            row = dict(kernel="instance_norm_bwd", shape=list(shape), dtype=str(dt)[6:],
                       act="relu",
                       ms=graph_ms(lambda: kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")),
                       plain_ms=graph_ms(
                           lambda: kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, "relu")),
                       library_ms=graph_ms(library_in_bwd(x, gy)), bound_ms=bms, bound_by=by)
            row["variant"] = kin._bwd_plan(*shape, dt)
            rows.append(row)
            log(f"[kernels train] {row}")
    results["in_bwd_host_us"] = in_bwd_host_us(dev)
    log(f"[kernels train] IN backward wrapper, host time a call: {results['in_bwd_host_us']}")
    # the resblock and head pads (bulk), one tile with overlapping mirrors
    # (h <= 2p), and channel counts whose pixels are not 16-byte multiples
    # (gather), h <= 2p too
    for shape, pad in (((1, 16, 32, 1024), 1), ((1, 256, 512, 64), 3), ((2, 2, 3, 8), 1),
                       ((1, 4, 5, 16), 3), ((1, 5, 7, 3), 1), ((1, 4, 5, 3), 3)):
        n, h, w, c = shape
        dy32 = torch.randn((n, h + 2 * pad, w + 2 * pad, c), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            dy = dy32.to(dt)
            what = f"reflect-pad bwd {shape} p{pad} {dt}"
            got, again = twice_on("reflect_pad_bwd", krp._plan(*shape, pad, dt)["variant"],
                                  lambda: krp.reflect_pad_bwd(dy, pad), what)
            want = krp.reflect_pad_bwd_plain(dy, pad)
            if not same_bits(got, again):
                raise AssertionError(f"{what}: two runs differ")
            keep("reflect_pad_bwd", dt, check_close(got, want, dt, PAD_FP32_ATOL, what))
            bms, by = bound(*pad_bwd_bytes(tuple(dy.shape), pad, dy.element_size()))
            row = dict(kernel="reflect_pad_bwd", shape=list(shape), pad=pad,
                       dtype=str(dt)[6:], plan=krp._plan(*shape, pad, dt),
                       ms=graph_ms(lambda: krp.reflect_pad_bwd(dy, pad)),
                       plain_ms=graph_ms(lambda: krp.reflect_pad_bwd_plain(dy, pad)),
                       library_ms=graph_ms(library_pad_bwd(dy, pad)), bound_ms=bms, bound_by=by)
            rows.append(row)
            log(f"[kernels train] {row}")
    # the D logits of both scales, the FM features, the VGG taps at 512x256
    loss_shapes = [(1, 35, 67, 1), (1, 19, 35, 1), (1, 129, 257, 64), (1, 65, 129, 128),
                   (1, 34, 66, 512), (1, 256, 512, 64), (1, 128, 256, 128), (1, 64, 128, 256),
                   (1, 32, 64, 512), (1, 16, 32, 512)]
    for shape in loss_shapes:
        a32 = torch.randn(shape, generator=gen, device=dev)
        b32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            a, b = a32.to(dt), b32.to(dt)
            t = torch.ones((), dtype=dt, device=dev).expand_as(a)
            for name, fn, plain, lib, two in (
                ("mse_to_scalar", lambda: klosses.mse_to_scalar(a, 1.0),
                 lambda: klosses.mse_to_scalar_plain(a, 1.0), lambda: F.mse_loss(a, t), False),
                ("l1_to_scalar", lambda: klosses.l1_to_scalar(a, b),
                 lambda: klosses.l1_to_scalar_plain(a, b), lambda: F.l1_loss(a, b), True),
            ):
                keep(name, dt, check_close(fn(), plain(), torch.float32, 0.0,
                                           f"{name} {shape} {dt}", rtol=LOSS_RTOL))
                bms, by = bound(*loss_bytes(a.numel(), a.element_size(), two))
                row = dict(kernel=name, shape=list(shape), dtype=str(dt)[6:], ms=graph_ms(fn),
                           plain_ms=graph_ms(plain), library_ms=graph_ms(lib),
                           bound_ms=bms, bound_by=by)
                rows.append(row)
                log(f"[kernels train] {row}")
    for bs in (1, 2):
        inp = encode_inputs(bs, *STEP_HW, dev)
        for dt in (torch.float32, torch.bfloat16):
            args = (inp["label"], inp["inst"], 35, dt)
            got, want = kenc.encode_cond(*args), kenc.encode_cond_plain(*args)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"encode_cond mismatch bs{bs} {dt}")
            bms, by = bound(*cond_bytes(bs, *STEP_HW, got.shape[-1], got.element_size()))
            row = dict(kernel="encode_cond", shape=[bs, *STEP_HW], dtype=str(dt)[6:],
                       ms=graph_ms(lambda: kenc.encode_cond(*args)),
                       plain_ms=graph_ms(lambda: kenc.encode_cond_plain(*args)),
                       library_ms=None, bound_ms=bms, bound_by=by, bit_exact=True)
            rows.append(row)
            log(f"[kernels train] {row}")
    log(f"[kernels train] max|kernel - plain|: {errs}")
    results["train_kernel_rows"] = rows
    results["train_kernel_max_err"] = errs


def two_bf16_ulps(got, want):
    """|got - want| within CONV_IN_BF16_ULPS bf16 ulps of max(|want|, 1)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1.0))) - 7)
    return bool(((got.float() - want.float()).abs() <= CONV_IN_BF16_ULPS * ulp).all())


def library_conv_in(x, w3x3, b, relu=False, residual=None):
    """The library composition (a yardstick only): reflect pad, cuDNN conv
    and F.instance_norm on the channels-last NCHW view."""
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                 w3x3.permute(3, 2, 0, 1), b.to(x.dtype))
    y = F.instance_norm(y, eps=1e-5)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    return F.relu(y) if relu else y


def conv_in_inputs(shape, dt, dev, gen, residual):
    n, h, w, cin, cout = shape
    x = (torch.randn((n, h, w, cin), generator=gen, device=dev) * 0.5).to(dt)
    w3 = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (9 * cin) ** -0.5).to(dt)
    b = torch.randn((cout,), generator=gen, device=dev).to(dt)
    r = torch.randn((n, h, w, cout), generator=gen, device=dev).to(dt) if residual else None
    return x, w3, b, r


def check_conv_in(x, w3, b, relu, r, what):
    """Kernel vs plain (fp32) or vs the plain version on the fp32 values
    (bf16), the same bits on a second run -> (max |kernel - gate|, max
    |kernel - plain version in x's dtype|)."""
    y, again = twice_on("conv3x3_in_act", kconv._plan(*x.shape, w3.shape[3], x.dtype)["variant"],
                        lambda: kconv.conv3x3_in_act(x, w3, b, relu=relu, residual=r),
                        f"conv3x3_in_act {what}")
    plain = kconv.conv3x3_in_act_plain(x, w3, b, relu=relu, residual=r)
    torch.cuda.synchronize()
    if not same_bits(y, again):
        raise AssertionError(f"conv3x3_in_act {what}: two runs differ")
    diff_plain = (y.float() - plain.float()).abs().max().item()
    if x.dtype == torch.float32:
        ok = bool(((y - plain).abs() <= CONV_IN_ATOL + CONV_IN_RTOL * plain.abs()).all())
        return ok, diff_plain, diff_plain
    f = [t.float() if t is not None else None for t in (x, w3, b, r)]
    want = kconv.conv3x3_in_act_plain(f[0], f[1], f[2], relu=relu, residual=f[3])
    return two_bf16_ulps(y, want.to(x.dtype)), (y.float() - want).abs().max().item(), diff_plain


def phase_conv_in(dev, results):
    """conv3x3_in_act against its plain version on the card, fp32 and bf16,
    its gradient against the plain gradient, and its times."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, errs = [], {}
    for shape in CONV_IN_SHAPES:
        flags = ([(relu, res) for relu in (False, True) for res in (False, True)]
                 if shape == CONV_IN_SHAPES[0] else [(True, False), (False, True)])
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            for relu, res in flags:
                x, w3, b, r = conv_in_inputs(shape, dt, dev, gen, res)
                with torch.no_grad():
                    ok, err, diff_plain = check_conv_in(x, w3, b, relu, r, f"{shape} {name}")
                if not ok:
                    raise AssertionError(f"conv3x3_in_act {shape} {name} relu={relu} "
                                         f"res={res}: max|diff| {err}")
                errs[name] = max(errs.get(name, 0.0), err)
                errs[f"{name} vs plain in {name}"] = max(
                    errs.get(f"{name} vs plain in {name}", 0.0), diff_plain)
            x, w3, b, r = conv_in_inputs(shape, dt, dev, gen, False)
            bms, by = conv_in_bound(shape, dt, False)
            with torch.no_grad():
                row = dict(kernel="conv3x3_in_act", shape=list(shape), dtype=name, relu=True,
                           ms=graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True)),
                           plain_ms=graph_ms(
                               lambda: kconv.conv3x3_in_act_plain(x, w3, b, relu=True)),
                           composition_ms=graph_ms(lambda: library_conv_in(x, w3, b, True)),
                           library_ms=None, bound_ms=bms, bound_by=by)
            row["tflops"] = 2 * math.prod(shape[:3]) * 9 * shape[3] * shape[4] / row["ms"] / 1e9
            row["plan"] = kconv._plan(*shape, dt)
            rows.append(row)
            log(f"[conv_in] {row}")
    # the autograd.Function's gradient (the recomputed plain composition)
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        x, w3, b, r = conv_in_inputs(CONV_IN_SHAPES[1], dt, dev, gen, True)
        leaves = [t.detach().requires_grad_() for t in (x, w3, b, r)]
        gy = torch.randn(r.shape, generator=gen, device=dev).to(dt)
        got, want = (torch.autograd.grad(fn(*leaves[:3], relu=True, residual=leaves[3]),
                                         leaves, gy)
                     for fn in (kconv.conv3x3_in_act, kconv.conv3x3_in_act_plain))
        grads[str(dt)[6:]] = max(check_close(a, p, dt, 1e-4, "conv3x3_in_act gradient",
                                             rtol=1e-4) for a, p in zip(got, want))
    log(f"[conv_in] max|kernel - gate| {errs} (fp32 {CONV_IN_ATOL} + {CONV_IN_RTOL}|y|, "
        f"bf16 {CONV_IN_BF16_ULPS} ulps); gradient vs plain max|diff| {grads}")
    results["conv_in"] = dict(rows=rows, max_err=errs, grad_max_diff=grads)


def site_inputs(kind, calls, dev, gen):
    """Fresh random inputs for each recorded call of one kernel, and the
    kernel / plain / library closures over the whole sequence with their
    bound and max |kernel - plain|."""
    kern, plain, lib, nbytes, ops, err = [], [], [], 0, 0, 0.0
    for call in calls:
        if kind == "instance_norm":
            shape, dt, act, has_res = call
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            r = torch.randn(shape, generator=gen, device=dev).to(dt) if has_res else None
            a = (x, act, r)
            kern.append(lambda a=a: kin.instance_norm(*a))
            plain.append(lambda a=a: kin.instance_norm_plain(*a))
            lib.append(lambda x=x: F.instance_norm(x.permute(0, 3, 1, 2), eps=kin.EPS))
            b, o = in_bytes(shape[0], shape[1] * shape[2], shape[3], x.element_size(), has_res)
            e = (kern[-1]()[0].float() - plain[-1]()[0].float()).abs().max().item()
        elif kind == "instance_norm_bwd":
            shape, dt, act, want_dres = call
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            gy = torch.randn(shape, generator=gen, device=dev).to(dt)
            y, mean, rstd = kin.instance_norm(x, act)
            a = (x, y, gy, mean, rstd, act, want_dres)
            kern.append(lambda a=a: kin.instance_norm_bwd(*a))
            plain.append(lambda a=a: kin.instance_norm_bwd_plain(*a))
            lib.append(library_in_bwd(x, gy))
            b, o = in_bwd_bytes(shape, x.element_size(), act, want_dres)
            e = (kern[-1]()[0].float() - plain[-1]()[0].float()).abs().max().item()
        elif kind == "reflect_pad_bwd":
            shape, dt, pad = call
            dy = torch.randn(shape, generator=gen, device=dev).to(dt)
            kern.append(lambda dy=dy, p=pad: krp.reflect_pad_bwd(dy, p))
            plain.append(lambda dy=dy, p=pad: krp.reflect_pad_bwd_plain(dy, p))
            lib.append(library_pad_bwd(dy, pad))
            b, o = pad_bwd_bytes(shape, pad, dy.element_size())
            e = (kern[-1]().float() - plain[-1]().float()).abs().max().item()
        elif kind == "encode_cond":
            shape, has_inst, nc, dt = call
            inp = encode_inputs(shape[0], shape[1], shape[2], dev, seed=len(kern))
            a = (inp["label"], inp["inst"] if has_inst else None, nc, dt)
            kern.append(lambda a=a: kenc.encode_cond(*a))
            plain.append(lambda a=a: kenc.encode_cond_plain(*a))
            lib = None
            out = kern[-1]()
            if not same_bits(out, plain[-1]()):
                raise AssertionError(f"encode_cond mismatch at {shape}")
            b, o = cond_bytes(*shape, out.shape[-1], out.element_size())
            e = 0.0
        else:
            raise ValueError(kind)
        nbytes, ops, err = nbytes + b, ops + o, max(err, e)

    def seq(fns):
        return lambda: [f() for f in fns]

    return seq(kern), seq(plain), (seq(lib) if lib is not None else None), nbytes, ops, err


def time_sites(kind, calls, dev, seed):
    """Device time of a kernel over the calls one step made of it, by
    CUDA-graph replay: kernel, plain version, library call, and the bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kern, plain, lib, nbytes, ops, err = site_inputs(kind, calls, dev, gen)
    torch.cuda.synchronize()
    bms, by = bound(nbytes, ops)
    return dict(launches_per_step=len(calls), max_abs_err=err, ms=graph_ms(kern),
                plain_ms=graph_ms(plain), library_ms=graph_ms(lib) if lib else None,
                bound_ms=bms, bound_by=by, bytes=nbytes)


def time_loss_groups(kind, groups, dev, seed):
    """Device time of the loss kernel over the launches of one mode that one
    step made (each recorded group replayed as one reduce_group, on fresh
    random operands of its terms' shapes), beside the plain version over
    the same groups, the library call (F.mse_loss / F.l1_loss) per term and
    the bound; each group the same bits as its terms alone, and within
    LOSS_RTOL of the plain version."""
    mode = "mse" if kind == "mse_to_scalar" else "l1"
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables, lib, nbytes, ops, err = [], [], 0, 0, 0.0
    for table in groups:
        if not any(m == mode for m, *_ in table):
            continue
        terms = []
        for m, shape, dt, t in table:
            a = torch.randn(shape, generator=gen, device=dev).to(dt)
            b = torch.randn(shape, generator=gen, device=dev).to(dt) if t is None else None
            terms.append((m, a, b if t is None else t))
            tt = b if t is None else torch.full((), t, dtype=dt, device=dev).expand_as(a)
            fn = F.mse_loss if m == "mse" else F.l1_loss
            lib.append(lambda a=a, tt=tt, fn=fn: fn(a, tt))
            nb, o = loss_bytes(a.numel(), a.element_size(), t is None)
            nbytes, ops = nbytes + nb, ops + o
        got, want = klosses.reduce_group(terms), klosses.reduce_group_plain(terms)
        alone = torch.cat([klosses.reduce_group([term]) for term in terms])
        torch.cuda.synchronize()
        if not same_bits(got, alone):
            raise AssertionError(f"{kind}: a term's bits differ alone and in its group {table}")
        check_close(got, want, torch.float32, 0.0, f"{kind} group {table}", rtol=LOSS_RTOL)
        err = max(err, (got - want).abs().max().item())
        tables.append(terms)
    bms, by = bound(nbytes, ops)
    return dict(
        launches_per_step=len(tables), terms_per_step=sum(len(t) for t in tables),
        max_abs_err=err, ms=graph_ms(lambda: [klosses.reduce_group(t) for t in tables]),
        plain_ms=graph_ms(lambda: [klosses.reduce_group_plain(t) for t in tables]),
        library_ms=graph_ms(lambda: [f() for f in lib]), bound_ms=bms, bound_by=by,
        bytes=nbytes)


def train_per_step(g_sites, opt):
    """Launches of each kernel in one train step of this architecture. With
    the image pool the D step encodes its conditioning again, and the G
    step runs D on the real image for feature matching on its own."""
    d_sites = opt.n_layers_D * opt.num_D      # IN sites of one D apply
    in_sites = g_sites + 2 * d_sites          # G, D on the fake for G, D on [real; fake]
    pooled = opt.pool_size > 0
    return {
        "encode": 1, "encode_cond": 2 if pooled else 1,
        "instance_norm": in_sites + (d_sites if pooled and not opt.no_ganFeat_loss else 0),
        "instance_norm_bwd": in_sites, "mse_to_scalar": 3 * opt.num_D,
        "l1_to_scalar": (opt.n_layers_D + 1) * opt.num_D + (0 if opt.no_vgg_loss else 5),
        "reflect_pad_bwd": 2 * opt.n_blocks_global + 1, "conv3x3_in_act": 0,
    }


def loss_groups_per_step(opt):
    """Loss-kernel launches of one train step (kernels/losses.reduce_group,
    one a loss): G's GAN term and D's real + fake terms (LSGAN), feature
    matching and VGG; the image pool splits the step, not a loss."""
    lsgan = not opt.no_lsgan
    return {"mse_to_scalar": 2 if lsgan else 0,
            "l1_to_scalar": int(not opt.no_ganFeat_loss) + int(not opt.no_vgg_loss)}


def expect_groups(groups, per_step, steps, what):
    """The loss groups launched (variants["group"] of each mode since
    zero or since `groups`) against the per-step count."""
    got = read_variants()
    for kind, n in per_step.items():
        expect_launches(got[kind]["group"] - groups.get(kind, 0), n * steps,
                        f"{what}, {kind} group launches")


def drive_train_cli(argv):
    """One run of the train CLI with the launch counters zeroed just before
    and read just after -> (state, model, loss lines, wall s, launches,
    per-step launches of its architecture)."""
    errors, models = [], []
    orig_print = Visualizer.print_current_errors
    orig_create = mask2image_train.create_model

    def record_errors(self, epoch, i, errs, t):
        errors.append(dict(errs))
        return orig_print(self, epoch, i, errs, t)

    def create_and_keep(opt):
        models.append(orig_create(opt))
        return models[-1]

    zero_launches()
    t = time.time()
    with mock.patch.object(Visualizer, "print_current_errors", record_errors), \
            mock.patch.object(mask2image_train, "create_model", create_and_keep):
        state = mask2image_train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_launches()
    model = models[0]
    g = model.netG
    per_step = train_per_step(1 + 2 * g.n_downsampling + 2 * g.n_blocks, model.opt)
    bad = [e for e in errors if not all(np.isfinite(v) for v in e.values())]
    if bad:
        raise AssertionError(f"non-finite losses: {bad}")
    return state, model, errors, wall, launches, per_step


def phase_train_cli(tmp, results):
    """Main path 2: the port's train CLI end to end on the card."""
    root = os.path.join(tmp, "city_train")
    write_dataroot(root, phase="train", seed=1)
    ckpt = os.path.join(tmp, "ckpt")
    argv = ["--name", "smoke_train", "--dataroot", root, "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--save_epoch_freq", "100", "--nThreads", "2", *ARCH_ARGV]
    with recording() as calls:
        state, model, errors, wall, launches, per_step = drive_train_cli(argv)
    steps = state.step
    log(f"[train CLI] {steps} steps in {wall:.1f} s (incl. model init, data, checkpoint "
        f"writes); launches {launches}; per step {per_step}")
    if steps < 1 or len(errors) != steps:
        raise AssertionError(f"{steps} steps, {len(errors)} loss lines")
    for k, n in per_step.items():
        expect_launches(launches[k], n * steps, f"train CLI {k}")
    expect_groups({}, loss_groups_per_step(model.opt), steps, "train CLI")
    variants = expect_variants(calls, "train CLI")
    log(f"[train CLI] losses, first step {errors[0]}, last step {errors[-1]}; "
        f"variants {variants}")
    # the checkpoint the CLI wrote, back into the serving model
    opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, name="smoke_train", checkpoints_dir=ckpt,
                                 **ARCH)
    serve = create_model(opt)
    if not restore_params(opt, serve):
        raise AssertionError("latest_params.npz not found")
    for (k, a), b in zip(serve.netG.state_dict().items(), model.netG.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"served G differs from the trained G at {k}")
    b, h, w = calls["encode_cond"][0][0]
    out = serve.inference(encode_inputs(1, h, w, serve.device, seed=9))
    torch.cuda.synchronize()
    if tuple(out.shape) != (1, h, w, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"served output {tuple(out.shape)} not finite")
    log(f"[train CLI] latest_params.npz served: output {tuple(out.shape)} finite")
    step_calls = {k: v[: len(v) // steps] for k, v in calls.items()}
    results["train_cli"] = dict(wall_s=wall, steps=steps, launches=launches,
                                per_step=per_step, losses=errors, window=[h, w],
                                variants=variants)
    del model, serve
    torch.cuda.empty_cache()
    return launches, step_calls, variants


def phase_train_cli_bf16(tmp, results):
    """Main path 3: the train CLI in the bf16 tier with the image pool and
    the HTML visuals for one epoch, then --continue_train from its latest
    for a second."""
    root = os.path.join(tmp, "city_train")
    ckpt = os.path.join(tmp, "ckpt_bf16")
    argv = ["--name", "smoke_bf16", "--dataroot", root, "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter_decay", "0", "--print_freq", "1",
            "--display_freq", "4", "--save_epoch_freq", "100", "--nThreads", "2",
            "--dtype", "bfloat16", "--pool_size", "50", *ARCH_ARGV]
    run_dir = os.path.join(ckpt, "smoke_bf16")
    runs, total = [], {k: 0 for k in counters()}
    total_variants = {k: {v: 0 for v in c} for k, c in read_variants().items()}
    done = 0
    for niter, extra in (("1", []), ("2", ["--continue_train"])):
        with recording() as calls:
            state, model, errors, wall, launches, per_step = drive_train_cli(
                argv + ["--niter", niter, *extra])
        variants = expect_variants(calls, f"bf16 train CLI epoch {niter}")
        steps = state.step - done
        done = state.step
        if steps < 1 or len(errors) != steps:
            raise AssertionError(f"bf16 train CLI: {steps} steps, {len(errors)} loss lines")
        for k, n in per_step.items():
            expect_launches(launches[k], n * steps, f"bf16 train CLI {k}")
        expect_groups({}, loss_groups_per_step(model.opt), steps, f"bf16 train CLI epoch {niter}")
        with open(os.path.join(run_dir, "web", "index.html")) as f:
            html = f.read()
        if f"epoch [{niter}]" not in html:
            raise AssertionError(f"web/index.html lacks epoch {niter}")
        with open(os.path.join(run_dir, "iter.txt")) as f:
            it = f.read()
        if it != f"{int(niter) + 1},0":
            raise AssertionError(f"iter.txt {it!r} after epoch {niter}")
        total = {k: total[k] + launches[k] for k in total}
        total_variants = {k: {v: n + variants[k][v] for v, n in c.items()}
                          for k, c in total_variants.items()}
        run = dict(niter=int(niter), continue_train=bool(extra), steps=steps, wall_s=wall,
                   launches=launches, per_step=per_step, variants=variants,
                   losses_first=errors[0],
                   losses_last=errors[-1])
        runs.append(run)
        log(f"[train CLI bf16] {run}")
        del model
        torch.cuda.empty_cache()
    results["train_cli_bf16"] = dict(runs=runs, launches=total, variants=total_variants)
    return total


def phase_roofline(tmp, results):
    """Main path 4: the port's resblock roofline tool; its JSON report."""
    out = os.path.join(tmp, "roofline.json")
    zero_launches()
    with recording() as rec:
        report = roofline_resblock.main(ROOFLINE_ARGV + ["--out", out])
    torch.cuda.synchronize()
    launches = read_launches()
    # the fused kernel: warm-up, timed calls and one compared with the plain
    # composition; the reflect-pad backward: the plain resblock's two pads
    # in each warm-up and timed forward + backward
    calls = report["iters"] + int(ROOFLINE_ARGV[ROOFLINE_ARGV.index("--warmup") + 1])
    expect_launches(launches, dict({k: 0 for k in launches}, conv3x3_in_act=calls + 1,
                                   reflect_pad_bwd=2 * calls), "roofline tool")
    # every call at bs 32 is the wgmma kernel (kernels/conv_in._plan)
    variants = read_variants()["conv3x3_in_act"]
    expect_launches(variants, dict({k: 0 for k in variants}, wgmma=calls + 1),
                    "roofline tool, conv3x3_in_act variants")
    # every pad of the plain resblock folds through the bulk form
    all_variants = expect_variants(rec, "roofline tool")
    pads = all_variants["reflect_pad_bwd"]
    expect_launches(pads, dict({k: 0 for k in pads}, bulk=2 * calls),
                    "roofline tool, reflect_pad_bwd variants")
    with open(out) as f:
        if json.load(f)["kernel_conv_in_relu_fwd"]["ms"] != report["kernel_conv_in_relu_fwd"]["ms"]:
            raise AssertionError("the roofline tool's --out differs from its report")
    log(f"[roofline] launches {launches}, conv3x3_in_act variants {variants}, "
        f"reflect_pad_bwd variants {pads}; report {json.dumps(report)}")
    results["roofline"] = dict(report=report, launches=launches, variants=variants,
                               pad_variants=pads, all_variants=all_variants)
    return launches


def conv_in_main_path_row(dev, results):
    """The JSON row of conv3x3_in_act, timed on the roofline tool's inputs
    (its shape, bf16, ReLU, no residual)."""
    report = results["roofline"]["report"]
    n, h, w, c = report["shape"]
    shape = (n, h, w, c, c)
    gen = torch.Generator(device=dev).manual_seed(14)
    x, w3, b, _ = conv_in_inputs(shape, torch.bfloat16, dev, gen, False)
    with torch.no_grad():
        ok, err, diff_plain = check_conv_in(x, w3, b, True, None, f"{shape} bf16")
        if not ok:
            raise AssertionError(f"conv3x3_in_act at the roofline shape: max|diff| {err}")
        bms, by = conv_in_bound(shape, torch.bfloat16, False)
        row = dict(
            name="conv3x3_in_act", route="cuda", source=f"{PKG}/csrc/conv_in.cu",
            replaces=f"{JAX_PKG}/ops/pallas/conv_in.py:127",
            launches=results["roofline"]["launches"]["conv3x3_in_act"], max_abs_err=err,
            max_abs_diff_vs_plain_bf16=diff_plain,
            ms=graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True)),
            plain_ms=graph_ms(lambda: kconv.conv3x3_in_act_plain(x, w3, b, relu=True)),
            bound_ms=bms, bound_by=by, library_ms=None,
            composition_ms=graph_ms(lambda: library_conv_in(x, w3, b, True)),
            per=f"one roofline-tool call, {list(shape)} bf16, ReLU (library_ms: no single "
                "PyTorch call computes it; composition_ms: reflect pad + cuDNN conv + "
                "F.instance_norm + ReLU)",
        )
    row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
    log(f"[main-path kernel] {row}")
    return row


def conv_in_fp32_row(results, path_variants):
    """The JSON row of conv3x3_in_act's fp32 form (the FMA kernel), timed
    at the bs-1 bottleneck in phase 9; launches: its "fma" launches counted
    on each main path (none: the roofline tool runs bf16, and no network
    calls the op)."""
    row = next(r for r in results["conv_in"]["rows"]
               if r["dtype"] == "float32" and tuple(r["shape"]) == CONV_IN_SHAPES[0])
    by_path = {p: v["conv3x3_in_act"]["fma"] for p, v in path_variants.items()}
    out = dict(
        name="conv3x3_in_act (fp32)", route="cuda", source=f"{PKG}/csrc/conv_in.cu",
        replaces=f"{JAX_PKG}/ops/pallas/conv_in.py:127", launches=sum(by_path.values()),
        launches_by_path=by_path,
        max_abs_err=results["conv_in"]["max_err"]["float32"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=None, composition_ms=row["composition_ms"], plan=row["plan"],
        per=f"one call at {row['shape']} fp32, ReLU; launches: the \"fma\" launches of the "
            "main paths; max_abs_err over the phase-9 fp32 checks "
            "(library_ms: no single PyTorch call computes it; composition_ms: reflect pad + "
            "cuDNN conv without TF32 + F.instance_norm + ReLU)")
    out["max_abs_diff"], out["kernel_ms"] = out["max_abs_err"], out["ms"]
    log(f"[kernel row] {out}")
    return out


def grads_of(model):
    return [(f"{net}.{n}", p.grad.clone() if p.grad is not None else None)
            for net, m in (("G", model.netG), ("D", model.netD))
            for n, p in m.named_parameters()]


def _grad_diff(a, b):
    """Worst leaf of |a - b| as max|diff| / max|b| and as ||diff|| / ||b||."""
    mx = nr = 0.0
    where = None
    for (name, x), (_, y) in zip(a, b):
        if x is None or y is None:
            if x is not None or y is not None:
                raise AssertionError(f"gradient present on one path only: {name}")
            continue
        d = (x - y).double()
        m = (d.abs().max() / y.abs().max().clamp_min(1e-30)).item()
        if m > mx:
            mx, where = m, name
        nr = max(nr, (d.norm() / y.double().norm().clamp_min(1e-30)).item())
    return mx, nr, where


def compare_step(model, batch):
    """One step's loss terms and G/D gradients, kernel path vs plain path,
    from the same parameters, with cuDNN deterministic so that repeated
    runs give the same bits. Each backward kernel is also swapped alone for
    its plain version. The gradient of this randomly initialized GAN step
    amplifies last-ulp differences of its forward (the IN forward kernel's
    statistics differ from the plain two-pass ones by about an ulp), so the
    whole-path difference is held to twice the gradient's own sensitivity,
    measured here: the change a 1-ulp nudge of the input image makes."""
    bumped = dict(batch)
    bumped["image"] = torch.nextafter(batch["image"], torch.full_like(batch["image"], 2.0))

    def run(ctx, b=batch):
        model.netG.zero_grad(set_to_none=True)
        model.netD.zero_grad(set_to_none=True)
        with ctx:
            total, metrics, _ = model.losses(b)
            total.backward()
        return {k: v.item() for k, v in metrics.items()}, grads_of(model)

    none = contextlib.nullcontext
    swaps = {
        "instance_norm_bwd": lambda: mock.patch.object(
            kin, "instance_norm_bwd", kin.instance_norm_bwd_plain),
        "reflect_pad_bwd": lambda: mock.patch.object(
            krp, "reflect_pad_bwd", krp.reflect_pad_bwd_plain),
        "losses": lambda: mock.patch.object(klosses, "reduce_group", klosses.reduce_group_plain),
    }
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = read_launches()
        mk, gk = run(none())
        mid = read_launches()
        if any(mid[k] == before[k] for k in TRAIN_KERNELS):
            raise AssertionError(f"a training kernel did not launch: {before} -> {mid}")
        mp, gp = run(plain_path())
        if read_launches() != mid:
            raise AssertionError("the plain path launched a kernel")
        repeat = _grad_diff(run(none())[1], gk)
        alone = {k: _grad_diff(run(ctx())[1], gk) for k, ctx in swaps.items()}
        sens_k = _grad_diff(run(none(), bumped)[1], gk)
        sens_p = _grad_diff(run(plain_path(), bumped)[1], gp)
    finally:
        torch.backends.cudnn.deterministic = prev
    loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mk)
    whole = _grad_diff(gk, gp)
    sens = (max(sens_k[0], sens_p[0]), max(sens_k[1], sens_p[1]))
    log(f"[step] kernel vs plain: losses {mk} vs {mp}, max rel {loss_rel:.3g}")
    log(f"[step] gradients (max|diff|/max|g|, ||diff||/||g||, worst leaf): kernel path "
        f"repeated {repeat}; one kernel plain at a time {alone}; whole plain path {whole}; "
        f"1-ulp image nudge, kernel path {sens_k}, plain path {sens_p}")
    if loss_rel > STEP_LOSS_RTOL or repeat[0] > STEP_GRAD_TOL:
        raise AssertionError(f"step: losses max rel {loss_rel}, repeat {repeat}")
    bad = {k: v for k, v in alone.items() if v[0] > STEP_GRAD_TOL}
    if bad:
        raise AssertionError(f"a backward kernel moves the gradients: {bad}")
    if whole[0] > STEP_SENS_FACTOR * sens[0] or whole[1] > STEP_SENS_FACTOR * sens[1]:
        raise AssertionError(f"kernel vs plain gradients {whole} beyond "
                             f"{STEP_SENS_FACTOR}x the 1-ulp sensitivity {sens}")
    return dict(losses_kernel=mk, losses_plain=mp, max_loss_rel=loss_rel, repeat=repeat,
                one_kernel_plain=alone, whole_plain_path=whole,
                one_ulp_sensitivity={"kernel": sens_k, "plain": sens_p},
                leaves=sum(g is not None for _, g in gk))


def phase_train_step(dev, results):
    """make_train_step at STEP_HW fp32: times (kernel and plain path), peak
    memory, the kernel-vs-plain step, and the calls one bs-1 step makes of
    each training kernel (for the per-step kernel table)."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, **ARCH)
    model = create_model(opt)
    step = make_train_step(model)
    rows = []
    for bs, iters in ((1, 10), (4, 4)):
        batch = encode_inputs(bs, *STEP_HW, dev, seed=8)
        state = make_optimizers(opt, model, 1000)
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(iters):
            metrics, _ = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / iters * 1e3
        peak = torch.cuda.max_memory_allocated()
        with plain_path():
            step(state, batch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(max(2, iters // 2)):
                step(state, batch)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t) / max(2, iters // 2) * 1e3
        row = dict(bs=bs, hw=list(STEP_HW), dtype="float32", precision="highest",
                   ms_per_step=ms, images_per_s=bs * 1e3 / ms, ms_per_image=ms / bs,
                   plain_ms_per_step=plain, peak_mem_bytes=peak,
                   losses={k: v.item() for k, v in metrics.items()})
        rows.append(row)
        log(f"[step] {row}")
    batch = encode_inputs(1, *STEP_HW, dev, seed=10)
    cmp = compare_step(model, batch)
    state = make_optimizers(opt, model, 1000)
    since = read_variants()
    with recording() as calls:
        step(state, batch)
    torch.cuda.synchronize()
    expect_groups({k: since[k]["group"] for k in ("mse_to_scalar", "l1_to_scalar")},
                  loss_groups_per_step(opt), 1, "fp32 step")
    got = expect_variants(calls, "fp32 step", since)
    variants = {k: {v: n - since[k][v] for v, n in c.items()} for k, c in got.items()}
    log(f"[step] variants per step {variants}")
    results["step"] = dict(rows=rows, kernel_vs_plain=cmp, variants_per_step=variants)
    del model
    torch.cuda.empty_cache()
    return calls


def phase_train_step_bf16(dev, results):
    """make_train_step in the bf16 tier at STEP_HW: times, peak memory and
    the launches of every kernel per step."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype="bfloat16", **ARCH)
    model = create_model(opt)
    step = make_train_step(model, torch.bfloat16)
    g = model.netG
    per_step = train_per_step(1 + 2 * g.n_downsampling + 2 * g.n_blocks, opt)
    rows = []
    for bs, iters in ((1, 10), (4, 4)):
        batch = encode_inputs(bs, *STEP_HW, dev, seed=8)
        state = make_optimizers(opt, model, 1000)
        with recording() as calls:
            step(state, batch)
        if bs == 1:
            step_calls = calls
        per_variant = {k: plan_variants(k, calls[k], calls["loss_group"])
                       for k in PLANNED + ("mse_to_scalar", "l1_to_scalar")}
        expect_launches({k: v["group"] for k, v in per_variant.items() if "group" in v},
                        loss_groups_per_step(opt), f"bf16 step bs {bs}, loss groups recorded")
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, vbefore = read_launches(), read_variants()
        t = time.perf_counter()
        for _ in range(iters):
            metrics, fake = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / iters * 1e3
        after = read_launches()
        for k, n in per_step.items():
            expect_launches(after[k] - before[k], n * iters, f"bf16 step bs {bs} {k}")
        vafter = read_variants()
        for kind, want in per_variant.items():
            expect_launches({k: vafter[kind][k] - vbefore[kind][k] for k in want},
                            {k: n * iters for k, n in want.items()},
                            f"bf16 step bs {bs}, {kind} variants")
        losses = {k: v.item() for k, v in metrics.items()}
        if fake.dtype != torch.bfloat16 or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"bf16 step bs {bs}: fake {fake.dtype}, losses {losses}")
        row = dict(bs=bs, hw=list(STEP_HW), dtype="bfloat16",
                   precision=model.conv_precision_resolved, ms_per_step=ms,
                   images_per_s=bs * 1e3 / ms, ms_per_image=ms / bs,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses,
                   launches_per_step=per_step, variants_per_step=per_variant)
        rows.append(row)
        log(f"[step bf16] {row}")
    results["step_bf16"] = rows
    del model
    torch.cuda.empty_cache()
    # the IN forward, the reflect-pad backward and the loss groups over the
    # calls of one bs-1 bf16 step
    table = []
    for i, name in enumerate(("instance_norm", "reflect_pad_bwd")):
        trow = dict(name=name, **time_sites(name, step_calls[name], dev, seed=60 + i))
        table.append(trow)
        log(f"[step bf16 {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    for i, name in enumerate(("mse_to_scalar", "l1_to_scalar")):
        trow = dict(name=name, **time_loss_groups(name, step_calls["loss_group"], dev, 62 + i))
        table.append(trow)
        log(f"[step bf16 {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    results["train_step_kernels_bf16"] = table


SOURCES = {
    "encode_cond": ("csrc/encode.cu", "ops/pallas/encode.py:104"),
    "instance_norm_bwd": ("csrc/instance_norm.cu", "ops/pallas/instance_norm.py:195"),
    "mse_to_scalar": ("csrc/losses.cu", "ops/pallas/losses.py:39"),
    "l1_to_scalar": ("csrc/losses.cu", "ops/pallas/losses.py:39"),
    "reflect_pad_bwd": ("csrc/reflect_pad.cu", "ops/pallas/reflect_pad.py:82"),
}


def phase_train_main_path_kernels(dev, cli_launches, cli_calls, cli_variants, step_calls,
                                  results):
    """JSON rows of the training kernels, each timed on the calls one step
    of the train CLI made of it (its bbox windows, bs 1, fp32), and the
    per-step table at STEP_HW bs 1 for PERF.md."""
    rows, table = [], []

    def timed(name, calls, seed):
        if name in ("mse_to_scalar", "l1_to_scalar"):
            return time_loss_groups(name, calls["loss_group"], dev, seed)
        return time_sites(name, calls[name], dev, seed)

    for i, name in enumerate(TRAIN_KERNELS):
        src, tpu = SOURCES[name]
        row = dict(name=name, route="cuda", source=f"{PKG}/{src}",
                   replaces=f"{JAX_PKG}/{tpu}", launches=cli_launches[name],
                   **timed(name, cli_calls, 20 + i))
        row["per"] = (f"the {row['launches_per_step']} calls one train-CLI step makes "
                      f"(bbox windows, bs 1, fp32)")
        if "terms_per_step" in row:
            # the loss kernel: launches are the groups, its .launches the terms
            row["launches"], row["terms"] = cli_variants[name]["group"], cli_launches[name]
            row["per"] = (f"the {row['terms_per_step']} terms in {row['launches_per_step']} "
                          "launches one train-CLI step makes (bbox windows, bs 1, fp32)")
        row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
        rows.append(row)
        log(f"[main-path kernel] {row}")
        trow = dict(name=name, **timed(name, step_calls, 40 + i))
        table.append(trow)
        log(f"[step {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    # the IN forward over the sites of the same step (library_ms: IN alone)
    trow = dict(name="instance_norm", **time_sites("instance_norm", step_calls["instance_norm"],
                                                    dev, seed=50))
    table.append(trow)
    log(f"[step {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    results["train_step_kernels"] = table
    return rows


# device-kernel names by kind, first match wins (the profile breakdown)
KERNEL_KINDS = (
    ("port kernels", ("in_fwd_", "in_bwd_", "reflect_pad_bwd_", "loss_group_kernel",
                      "encode_kernel")),
    ("conv weight gradient", ("wgrad",)),
    ("conv data gradient", ("dgrad",)),
    ("conv forward / other conv algorithms", ("fprop", "fft", "winograd", "sgemm",
                                              "gemv", "gemm", "conv")),
    ("layout conversion (cuDNN)", ("nhwcToNchw", "nchwToNhwc")),
    ("Adam (multi-tensor)", ("multi_tensor",)),
    ("aten reflection pad", ("reflection_pad",)),
    ("pools", ("pool",)),
    ("elementwise and copies", ("elementwise", "copy", "vectorized", "unrolled")),
    ("reductions", ("reduce",)),
)


def kernel_kind(name):
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def phase_profile_train(dev, results, bf16=False):
    """Device time by kernel over train steps at STEP_HW bs 1 (fp32, or the
    bf16 tier), grouped by kind; the idle share is that of the unprofiled
    step (phase 8 or 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype="bfloat16" if bf16 else "float32",
                                  **ARCH)
    model = create_model(opt)
    step = make_train_step(model, torch.bfloat16 if bf16 else None)
    state = make_optimizers(opt, model, 1000)
    batch = encode_inputs(1, *STEP_HW, dev, seed=12)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=40)
    log(table)
    kinds = {}
    for e in avgs:
        if e.device_type == DeviceType.CUDA:  # kernel rows only: no double count
            us = getattr(e, "self_device_time_total", 0) / n
            kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) + us / 1e3
    dev_ms = sum(kinds.values())
    step_ms = (results["step_bf16"][0] if bf16 else results["step"]["rows"][0])["ms_per_step"]
    kinds = dict(sorted(kinds.items(), key=lambda kv: -kv[1]))
    tag = "profile train bf16" if bf16 else "profile train"
    log(f"[{tag}] device ms per step by kind: "
        f"{ {k: round(v, 4) for k, v in kinds.items()} }")
    log(f"[{tag}] device busy {dev_ms:.3f} ms per step; unprofiled step "
        f"{step_ms:.3f} ms; idle share {max(0.0, 1 - dev_ms / step_ms):.3f}")
    results[tag.replace(" ", "_")] = dict(
        table=table, device_ms_per_step=dev_ms, by_kind=kinds, unprofiled_step_ms=step_ms,
        idle_share=max(0.0, 1 - dev_ms / step_ms))
    del model
    torch.cuda.empty_cache()


def write_dataroot(root, n=4, phase="test", seed=0):
    """Cityscapes-like scenes of DATAROOT_HW: label ids 0..34 (uint8), inst =
    class id for stuff and class*1000+k for things (mode 'I'), random RGB."""
    from PIL import Image

    h, w = DATAROOT_HW
    rng = np.random.RandomState(seed)
    for sub in (f"{phase}_label", f"{phase}_inst", f"{phase}_img"):
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
        Image.fromarray(label).save(os.path.join(root, f"{phase}_label", f"{i}.png"))
        Image.fromarray(inst, mode="I").save(os.path.join(root, f"{phase}_inst", f"{i}.png"))
        Image.fromarray(img).save(os.path.join(root, f"{phase}_img", f"{i}.png"))


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
            "--gpu_ids", GPU_IDS, "--how_many", "4", *ARCH_ARGV]
    zero_launches()
    t = time.time()
    with mock.patch.object(Pix2PixHDModel, "inference", checked_inference), \
            mock.patch.object(mask2image_test, "create_model", create_and_hook), \
            recording() as calls:
        mask2image_test.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_launches()
    all_variants = expect_variants(calls, "serving CLI")
    variants = all_variants["instance_norm"]
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
    log(f"[serving] launches {launches}, IN forward variants {variants}; {rows} gallery rows, "
        f"{len(synth)} image files")
    if rows != 4 or not synth:
        raise AssertionError(f"gallery incomplete: {rows} rows, files {synth}")
    if len(outputs) != 4 or not all(f for _, f in outputs):
        raise AssertionError(f"non-finite or missing outputs: {outputs}")
    expect_launches(launches, dict(
        {k: 0 for k in launches}, encode=len(outputs),
        instance_norm=per_forward[0] * len(outputs)), "serving CLI")
    if len(sites) != per_forward[0]:
        raise AssertionError(f"expected {per_forward[0]} IN sites per forward, saw {len(sites)}")
    if sites != generator_sites(*outputs[0][0][:3], **arch):
        raise AssertionError(f"IN sites off the architecture: {sites}")
    results["serving"] = dict(wall_s=wall, outputs=outputs, launches=launches, variants=variants,
                              all_variants=all_variants)
    results["launches"] = launches
    results["sites"] = sites
    return sites, outputs[0][0]


@contextlib.contextmanager
def plain_path():
    """Route the model through the plain versions (comparison only)."""
    with mock.patch.object(kenc, "encode", kenc.encode_plain), \
            mock.patch.object(kenc, "encode_cond", kenc.encode_cond_plain), \
            mock.patch.object(kin, "instance_norm", kin.instance_norm_plain), \
            mock.patch.object(kin, "instance_norm_act", kin.instance_norm_act_plain), \
            mock.patch.object(klosses, "reduce_group", klosses.reduce_group_plain), \
            mock.patch.object(krp, "reflect_pad", krp.reflect_pad_plain):
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
    opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, **ARCH)
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
    mb = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, norm="batch", **ARCH))
    batch = encode_inputs(1, 128, 256, dev, seed=6)
    before = kenc.encode.launches
    out = mb.inference(batch)
    launched = kenc.encode.launches - before
    with plain_path():
        ref = mb.inference(batch)
    torch.cuda.synchronize()
    diff = (out - ref).abs().max().item()
    expect_launches(launched, 1, "--norm batch forward, encode")
    if not torch.isfinite(out).all() or diff > MODEL_ATOL:
        raise AssertionError(f"--norm batch forward: diff {diff}")
    log(f"[model] --norm batch 256x128: out {tuple(out.shape)}, max|diff| vs plain {diff}")
    results["model"] = rows
    results["norm_batch_max_abs_diff"] = diff


def phase_profile(dev, results):
    """Device time by kernel name over one bs-1 512x256 forward."""
    from torch.profiler import ProfilerActivity, profile

    model = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, **ARCH))
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
    phase_train_kernels(dev, results)
    phase_conv_in(dev, results)
    with tempfile.TemporaryDirectory() as tmp:
        sites, out_shape = phase_serving(tmp, results)
        cli_launches, cli_calls, cli_variants = phase_train_cli(tmp, results)
        bf16_launches = phase_train_cli_bf16(tmp, results)
        roofline_launches = phase_roofline(tmp, results)
    kernels = phase_main_path_kernels(dev, sites, out_shape, results)
    phase_forward_sites(dev, results)
    phase_model(dev, results)
    step_calls = phase_train_step(dev, results)
    phase_train_step_bf16(dev, results)
    kernels += phase_train_main_path_kernels(dev, cli_launches, cli_calls, cli_variants,
                                             step_calls, results)
    # every kernel's launches per variant on each main path
    path_variants = {"serving": results["serving"]["all_variants"], "train": cli_variants,
                     "train_bf16_pool": results["train_cli_bf16"]["variants"],
                     "roofline": results["roofline"]["all_variants"]}
    kernels.append(conv_in_main_path_row(dev, results))
    kernels.append(conv_in_fp32_row(results, path_variants))
    # launches per variant on the main path of the row (the plan functions'
    # split, checked in phases 6 and 11)
    for row in kernels:
        if row["name"] == "instance_norm":
            row["variants"] = results["serving"]["variants"]
        if row["name"] in ("instance_norm_bwd", "reflect_pad_bwd"):
            row["variants"] = cli_variants[row["name"]]
        if row["name"] == "conv3x3_in_act":
            row["variants"] = results["roofline"]["variants"]
    for row in kernels:
        name = row["name"]
        if name == "conv3x3_in_act (fp32)":
            continue
        row["launches_by_path"] = {
            "serving": results["launches"][name], "train": cli_launches[name],
            "train_bf16_pool": bf16_launches[name], "roofline": roofline_launches[name]}
        if name in ("mse_to_scalar", "l1_to_scalar"):
            row["terms_by_path"] = row["launches_by_path"]
            row["launches_by_path"] = {p: v[name]["group"] for p, v in path_variants.items()}
    if args.profile:
        phase_profile(dev, results)
        phase_profile_train(dev, results)
        phase_profile_train(dev, results, bf16=True)
    results["kernels"] = kernels
    results["seconds"] = time.time() - t0
    log(f"[done] {results['seconds']:.1f} s")
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

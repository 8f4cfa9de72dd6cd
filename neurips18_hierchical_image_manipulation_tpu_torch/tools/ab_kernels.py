"""Time the redesigned kernels of one tree of the port on one CUDA card, so
that two trees can be compared on the same card in one session.

    python3 neurips18_hierchical_image_manipulation_tpu_torch/tools/ab_kernels.py \\
        --root DIR --out FILE

DIR is the root of a checkout (or a ``git archive`` of one) whose
``neurips18_hierchical_image_manipulation_tpu_torch`` package is imported:
the script is run as a file, so its own tree is not imported unless DIR is
it. Run it for the older and the newer tree in turns (old, new, new, old)
and compare. It measures, on that tree's public entry points only:

  1. ``conv3x3_in_act``, bf16, ReLU, 16x32, 1024 -> 1024 channels, at bs 32
     (the resblock roofline path) and bs 1: device time by CUDA-graph
     replay;
  2. ``instance_norm_bwd`` over the 39 sites of one 512x256 bs-1 train step
     (27 generator sites, the 6 of the discriminator on the fake at N 1 and
     on [real; fake] at N 2), fp32 and bf16, each site with its own inputs,
     device time by CUDA-graph replay;
  3. the host time of one ``instance_norm_bwd`` call at the bottleneck
     (relu): the host clock over 1000 calls after a sync;
  4. ``instance_norm`` (the forward) over the 27 sites of one 512x256
     generator forward at bs 1 and 8 (fp32), and over the 39 sites of one
     bs-1 step (the acts and residuals of the networks), fp32 and bf16,
     each site with its own inputs, device time by CUDA-graph replay; its
     host time a call at the bottleneck (relu);
  5. ``reflect_pad_bwd`` over the 19 pads of one bs-1 step (18 resblock pads
     of dy (1, 18, 34, 1024), the head pad of dy (1, 262, 518, 64)), fp32
     and bf16, device time by CUDA-graph replay; its host time a call at a
     resblock pad;
  6. the bf16 train step (``make_train_step``) at 512x256, full width, bs 1
     and 4: host clock per step after a sync.

Prints one JSON object (and writes it to ``--out``) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the tree whose package is measured")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
        MaskToImageTrainOptions,
    )
    from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import synthetic_batch
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
    from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import create_model
    from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
    from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import make_train_step

    if not torch.cuda.is_available():
        sys.exit("ab_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card_line(), "root": os.path.abspath(args.root),
              "package": os.path.dirname(kconv.__file__)}

    def cuda_ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def host_us(fn, calls=1000):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        return us

    def graph_ms(fn, iters=20):
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

    gen = torch.Generator(device=dev).manual_seed(0)
    conv = {}
    with torch.no_grad():
        for bs in (32, 1):
            x = (torch.randn((bs, 16, 32, 1024), generator=gen, device=dev) * 0.5).bfloat16()
            w3 = (torch.randn((3, 3, 1024, 1024), generator=gen, device=dev) / 96).bfloat16()
            b = torch.randn((1024,), generator=gen, device=dev).bfloat16()
            conv[f"bs{bs}"] = graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True))
    report["conv3x3_in_act_bf16_ms"] = conv

    g_sites = [((1, 256 >> i, 512 >> i, 64 << i), "relu") for i in range(5)]
    g_sites += [((1, 16, 32, 1024), a) for _ in range(9) for a in ("relu", "none")]
    g_sites += [((1, 256 >> i, 512 >> i, 64 << i), "relu") for i in range(3, -1, -1)]
    d_shapes = [(65, 129, 128), (33, 65, 256), (34, 66, 512),
                (33, 65, 128), (17, 33, 256), (18, 34, 512)]
    sites = g_sites + [((n, *s), "lrelu") for n in (1, 2) for s in d_shapes]
    assert len(sites) == 39
    bwd = {}
    for dt in (torch.float32, torch.bfloat16):
        calls = []
        for shape, act in sites:
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            gy = torch.randn(shape, generator=gen, device=dev).to(dt)
            y, mean, rstd = kin.instance_norm(x, act)
            calls.append((x, y, gy, mean, rstd, act))
        bwd[str(dt)[6:]] = graph_ms(lambda: [kin.instance_norm_bwd(*c) for c in calls])
        x, y, gy, mean, rstd, _ = calls[13]  # a bottleneck site, relu
        assert tuple(x.shape) == (1, 16, 32, 1024)
        bwd[f"host_us_{str(dt)[6:]}"] = host_us(
            lambda: kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu"))
    report["instance_norm_bwd_39_sites_ms"] = bwd

    def fwd_sites(sites, dt):
        """(shape, act) sites -> one graph of the forward over all of them;
        the resblocks' second IN ("none") adds the residual, as the
        networks do."""
        calls = []
        for shape, act in sites:
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            r = torch.randn(shape, generator=gen, device=dev).to(dt) if act == "none" else None
            calls.append((x, act, r))
        return graph_ms(lambda: [kin.instance_norm(*c) for c in calls])

    fwd = {}
    for bs in (1, 8):
        fwd[f"forward_27_sites_bs{bs}_float32"] = fwd_sites(
            [((bs, *s[1:]), a) for s, a in g_sites], torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        fwd[f"step_39_sites_{str(dt)[6:]}"] = fwd_sites(sites, dt)
        x = torch.randn((1, 16, 32, 1024), generator=gen, device=dev).to(dt)
        fwd[f"host_us_{str(dt)[6:]}"] = host_us(lambda: kin.instance_norm(x, "relu"))
    report["instance_norm_fwd_ms"] = fwd

    pads = {}
    for dt in (torch.float32, torch.bfloat16):
        dys = [(torch.randn((1, 18, 34, 1024), generator=gen, device=dev).to(dt), 1)
               for _ in range(18)]
        dys.append((torch.randn((1, 262, 518, 64), generator=gen, device=dev).to(dt), 3))
        pads[f"step_19_pads_{str(dt)[6:]}"] = graph_ms(
            lambda: [krp.reflect_pad_bwd(dy, p) for dy, p in dys])
        pads[f"head_pad_{str(dt)[6:]}"] = graph_ms(lambda: krp.reflect_pad_bwd(*dys[-1]))
        pads[f"host_us_{str(dt)[6:]}"] = host_us(lambda: krp.reflect_pad_bwd(*dys[0]))
    report["reflect_pad_bwd_ms"] = pads

    opt = MaskToImageTrainOptions(gpu_ids="0", dtype="bfloat16")
    model = create_model(opt)
    step = make_train_step(model, torch.bfloat16)
    steps = {}
    for bs, iters in ((1, 10), (4, 4)):
        raw = synthetic_batch(np.random.RandomState(8), bs, hw=(256, 512), label_nc=35)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        state = make_optimizers(opt, model, 1000)
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            step(state, batch)
        torch.cuda.synchronize()
        steps[f"bs{bs}"] = (time.perf_counter() - t) / iters * 1e3
    report["train_step_bf16_ms"] = steps
    text = json.dumps(report)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()

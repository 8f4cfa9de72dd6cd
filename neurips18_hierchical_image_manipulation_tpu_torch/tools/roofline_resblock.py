"""Roofline of the generator's resblock trunk on one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.roofline_resblock \\
        [--batch 32] [--iters 50] [--out FILE]

Counterpart of ``tools/roofline_resblock.py`` in the JAX package: the same
five measurements at the same shape and dtype (N = batch, 16x32, 1024
channels, bf16; x and the weights, N(0, 1) and N(0, 1) x 0.02, from
``np.random.RandomState(0)`` in the same order, so they are the JAX tool's
values), at the generator bottleneck where the 9 resblocks run. The
ceilings' matmul operands, whose values do not matter, are drawn on the
card:

  1. one (M, 9C) x (9C, C) ``torch.matmul``, M = N*H*W: the implicit-GEMM
     ceiling of any conv formulation that reads its inputs once;
  2. 9 (M, C) x (C, C) matmuls summed in fp32: the tap-loop ceiling;
  3. the plain conv + IN + ReLU composition
     (``kernels/conv_in.conv3x3_in_act_plain``: cuDNN conv, PyTorch IN);
  4. the port's fused kernel ``kernels/conv_in.conv3x3_in_act``;
  5. the plain resblock (two convs, two INs, the residual), forward and
     forward + backward.

Each is timed with CUDA events around ``--iters`` calls after a warm-up and
a sync. The report prints as JSON (and goes to ``--out`` when given), with
the card's name and power limit; its peak is the H100 datasheet's dense
bf16 rate. A kernel failure raises: nothing is caught.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..kernels import conv_in as kconv

PEAK_TFLOPS_BF16 = 989.0  # H100 SXM, dense, datasheet


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over iters calls, after warm-up and a sync."""
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
    CUDA graph (on the side stream of its warm-up) and the replay is timed
    by ``cuda_ms``: for work whose launch is shorter than its overhead."""
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


def conv_in_relu(x, w, b):
    return kconv.conv3x3_in_act_plain(x, w, b, relu=True)


def resblock(x, w1, b1, w2, b2):
    return kconv.conv3x3_in_act_plain(conv_in_relu(x, w1, b1), w2, b2, residual=x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--out", default="", help="also write the report to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("roofline_resblock: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    # the plain composition's convolutions in their own precision, no TF32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    bs, (h, w, c) = args.batch, (16, 32, 1024)
    dt = torch.bfloat16
    rng = np.random.RandomState(0)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape) * scale).to(dev, dt)

    x = draw(bs, h, w, c)
    w1, w2 = draw(3, 3, c, c, scale=0.02), draw(3, 3, c, c, scale=0.02)
    b1 = b2 = torch.zeros(c, dtype=dt, device=dev)
    conv_flops = 2.0 * bs * h * w * c * c * 9  # one 3x3 conv
    report = {
        "card": card_line(), "device": torch.cuda.get_device_name(0),
        "shape": [bs, h, w, c], "dtype": "bfloat16", "conv_flops": conv_flops,
        "peak_tflops_h100_bf16_dense_datasheet": PEAK_TFLOPS_BF16,
        "iters": args.iters,
    }

    def timed(key, fn, flops, note=None):
        ms = cuda_ms(fn, args.iters, args.warmup)
        report[key] = {"ms": ms, "tflops": flops / ms / 1e9,
                       "peak_share": flops / ms / 1e9 / PEAK_TFLOPS_BF16}
        if note:
            report[key]["note"] = note

    m = bs * h * w
    gen = torch.Generator(device=dev).manual_seed(0)

    def operand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    a, bmat = operand(m, 9 * c), operand(9 * c, c)
    timed("implicit_gemm_matmul", lambda: torch.matmul(a, bmat), conv_flops,
          "M=N*H*W K=9C N=C, one bf16 matmul (fp32 accumulation, bf16 out): the "
          "ceiling of any implicit-GEMM conv (ignores its im2col read amplification)")
    del a, bmat
    a2, taps = operand(m, c), operand(9, c, c)

    def mm9():
        acc = torch.zeros((m, c), dtype=torch.float32, device=dev)
        for t in range(9):
            acc += torch.matmul(a2, taps[t])
        return acc

    timed("tap_loop_matmuls", mm9, conv_flops,
          "9 K=C bf16 matmuls summed in fp32: the ceiling of the TPU kernel's "
          "tap-loop formulation")
    del a2, taps
    with torch.no_grad():
        timed("plain_conv_in_relu_fwd", lambda: conv_in_relu(x, w1, b1), conv_flops)
        kernel_out = kconv.conv3x3_in_act(x, w1, b1, relu=True)
        plain_out = conv_in_relu(x, w1, b1)
        report["kernel_vs_plain_max_abs_diff"] = (
            (kernel_out.float() - plain_out.float()).abs().max().item())
        timed("kernel_conv_in_relu_fwd",
              lambda: kconv.conv3x3_in_act(x, w1, b1, relu=True), conv_flops,
              "kernels/conv_in.conv3x3_in_act (csrc/conv_in.cu)")
        timed("plain_resblock_fwd", lambda: resblock(x, w1, b1, w2, b2), 2 * conv_flops)
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]

    def fwd_bwd():
        loss = resblock(*leaves).float().sum()
        return torch.autograd.grad(loss, leaves)

    # forward + backward ~ 3x the forward's conv FLOPs (data and weight
    # gradients of each conv)
    timed("plain_resblock_fwd_bwd", fwd_bwd, 6 * conv_flops)
    text = json.dumps(report, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()

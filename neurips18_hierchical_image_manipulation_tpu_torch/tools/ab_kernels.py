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
  6. the loss calls of one 512x256 bs-1 step, replayed through the public
     losses on prebuilt D outputs and VGG taps, fp32 and bf16: ``gan_loss``
     on D(fake) for G and ``discriminator_loss`` on the [real; fake] apply
     (the 6 MSE terms), ``feature_matching_loss`` and ``vgg_loss`` (the 13
     L1 terms), device time by CUDA-graph replay (the weighted sums
     included); where the tree has ``kernels.losses.reduce_group``, its
     launches alone over the same terms too;
  7. ``conv3x3_in_act`` in fp32, ReLU, 16x32, 1024 -> 1024 channels, at bs 1
     and 4 (the FMA kernel), beside the library composition (reflect pad,
     cuDNN conv without TF32, ``F.instance_norm``, ReLU);
  8. the bf16 train step (``make_train_step``) at 512x256, full width, bs 1
     and 4: host clock per step after a sync;
  9. the code of ``csrc/conv_in.cu``'s bf16 kernels as the tree builds it:
     each kernel's registers and shared memory (``cuobjdump -res-usage``),
     its SASS instruction count and a digest of its SASS with the
     addresses taken out, and the plans of the two bf16 calls of item 1,
     so that two trees' bf16 code and launches can be compared.

Prints one JSON object (and writes it to ``--out``) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

BF16_KERNELS = ("conv_wgmma_kernel", "conv_mma_kernel", "reflect_pad1_kernel",
                "transpose_kernel", "conv_in_normalize_kernel")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_code(lib_path, nvcc):
    """Registers, shared memory, SASS instructions and a SASS digest of
    each BF16_KERNELS kernel (each instantiation) in one built library."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib_path], capture_output=True, text=True,
                              check=True, timeout=300).stdout

    def short(mangled):
        # the anonymous namespace's name differs from build to build
        kind = next((k for k in BF16_KERNELS if k in mangled), None)
        if kind is None:
            return None
        return kind + ("<bf16>" if "bfloat16" in mangled else "<float>"
                       if kind == "conv_in_normalize_kernel" else "")

    code = {}
    for block in re.split(r"\n\s*Function : ", dump("-sass"))[1:]:
        name, body = block.split("\n", 1)
        key = short(name)
        if key is None:
            continue
        # the padding of a line follows the library's longest line: drop it
        ins = [" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split())
               for line in body.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
        code[key] = dict(sass_instructions=len(ins),
                         sass_sha256=hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16])
    key = None
    for line in dump("-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+?):", line)
        if m:
            key = short(m.group(1))
        if key in code:  # the fields follow the name, on its line or the next
            for field in ("REG", "SHARED"):
                f = re.search(rf"\b{field}:(\d+)", line)
                if f:
                    code[key][field.lower()] = int(f.group(1))
    return code


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
    import torch.nn.functional as F

    from neurips18_hierchical_image_manipulation_tpu_torch import losses as tlosses
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
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
        with torch.cuda.graph(g, stream=side):
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

    # the D features of both scales at 512x256 (the 3 strided layers and the
    # stride-1 one, then the logits), and the VGG taps relu1_1..relu5_1
    d_scales = [[(129, 257, 64), (65, 129, 128), (33, 65, 256), (34, 66, 512), (35, 67, 1)],
                [(65, 129, 64), (33, 65, 128), (17, 33, 256), (18, 34, 512), (19, 35, 1)]]
    taps = [(256, 512, 64), (128, 256, 128), (64, 128, 256), (32, 64, 512), (16, 32, 512)]
    losses = {}
    for dt in (torch.float32, torch.bfloat16):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        d_fake_g = [[rand(1, *sh) for sh in sc] for sc in d_scales]
        d_rf = [[rand(2, *sh) for sh in sc] for sc in d_scales]  # one apply on [real; fake]
        d_real = [[f[:1] for f in sc] for sc in d_rf]
        d_fake = [[f[1:] for f in sc] for sc in d_rf]
        fake_img, real_img = rand(1, 256, 512, 3), rand(1, 256, 512, 3)
        t_fake, t_real = [rand(1, *sh) for sh in taps], [rand(1, *sh) for sh in taps]

        def vgg(x):
            return t_fake if x is fake_img else t_real

        def mse_calls():
            tlosses.gan_loss(d_fake_g, True)
            tlosses.discriminator_loss(d_real, d_fake)

        def l1_calls():
            tlosses.feature_matching_loss(d_fake_g, d_real, n_layers_D=3, num_D=2,
                                          lambda_feat=10.0)
            tlosses.vgg_loss(vgg, fake_img, real_img)

        name = str(dt)[6:]
        with torch.no_grad():
            losses[f"mse_6_terms_{name}"] = graph_ms(mse_calls)
            losses[f"l1_13_terms_{name}"] = graph_ms(l1_calls)
            if hasattr(klosses, "reduce_group"):
                mse = [[("mse", sc[-1], 1.0) for sc in d_fake_g],
                       [("mse", sc[-1], 1.0) for sc in d_real]
                       + [("mse", sc[-1], 0.0) for sc in d_fake]]
                l1 = [[("l1", a, b) for sa, sb in zip(d_fake_g, d_real)
                       for a, b in zip(sa[:-1], sb[:-1])],
                      [("l1", a, b) for a, b in zip(t_fake, t_real)]]
                losses[f"mse_6_terms_{name}_kernel_only"] = graph_ms(
                    lambda: [klosses.reduce_group(g) for g in mse])
                losses[f"l1_13_terms_{name}_kernel_only"] = graph_ms(
                    lambda: [klosses.reduce_group(g) for g in l1])
        l1_bytes = sum(2 * math.prod(f.shape) * f.element_size()
                       for sc in d_fake_g for f in sc[:-1]) + sum(
            2 * math.prod(t.shape) * t.element_size() for t in t_fake)
        losses[f"l1_13_terms_{name}_bound"] = l1_bytes / 3.35e12 * 1e3
    report["loss_sites_ms"] = losses

    conv32 = {}
    with torch.no_grad():
        for bs in (1, 4):
            x = torch.randn((bs, 16, 32, 1024), generator=gen, device=dev) * 0.5
            w3 = torch.randn((3, 3, 1024, 1024), generator=gen, device=dev) / 96
            b = torch.randn((1024,), generator=gen, device=dev)
            conv32[f"bs{bs}"] = graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True))

            def composition():
                y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                             w3.permute(3, 2, 0, 1), b)
                return F.relu(F.instance_norm(y, eps=1e-5))

            conv32[f"bs{bs}_composition"] = graph_ms(composition)
    report["conv3x3_in_act_fp32_ms"] = conv32

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

    from neurips18_hierchical_image_manipulation_tpu_torch.kernels import _build

    kconv._lib()
    report["conv_in_bf16_code"] = dict(
        kernels=kernel_code(_build._lib_path("conv_in"), _build._nvcc()),
        plans={f"bs{bs}": kconv._plan(bs, 16, 32, 1024, 1024, torch.bfloat16)
               for bs in (32, 1)})
    text = json.dumps(report)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()

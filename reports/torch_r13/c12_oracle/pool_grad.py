"""Where the port's gradient leaves the reference on the card: the
multiscale discriminator's input gradient, and the one op in it that is
wrong there.

    python reports/torch_r13/c12_oracle/pool_grad.py --out FILE [--gpu_ids 0]

  1. The port's D (``models/networks.MultiscaleDiscriminator`` through
     ``Pix2PixHDModel``'s frozen-parameter call, fp32, TF32 off; its kernel
     path and its plain path) and the oracle's (``tools/bench_torch_oracle``:
     pix2pixHD's ``NLayerDiscriminatorT`` modules) at full width (ndf 64, 3
     layers), num_D 2 and 1, bs 4 at 512x256: the gradient of G's LSGAN
     term with respect to the fake image, against the oracle's modules
     run in fp64. Max |diff| over max |g|, and the median elementwise
     relative difference.
  2. The port's ``ops/nnops.avg_pool_3x3s2`` (since the C.12 repair,
     AvgPool2d(3, 2, 1, count_include_pad=False) on a contiguous NCHW copy
     of the NHWC tensor), the form it had before (the pool on the
     channels_last view of the NHWC tensor) and the shifted-slice form
     (the JAX package's ``_avg_pool_3x3s2_slices``), forward and input
     gradient, fp32 and bf16, against fp64 on the CPU.
  3. A repro in PyTorch alone (no module of the port): ``F.avg_pool2d``
     and ``F.max_pool2d`` on NCHW tensors in each memory format, with the
     output gradient in each memory format, fp32, against fp64 on the CPU;
     the memory format of the gradient that reaches the pool's backward
     through the port's ``permute(0, 2, 3, 1).contiguous()``.
  4. The three pool forms' device time, forward and backward, at the
     multiscale D's inputs of a bs-32 bf16 flagship step (the conditioning,
     36 channels, no gradient; [real; fake], 3 channels, 64 images; the
     fake, 3 channels, with its gradient), by CUDA events.

The report (JSON) carries the card's name and power limit and the torch
and cuDNN versions.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import functional_call  # noqa: E402

from chip_smoke import (  # noqa: E402
    channels_last_view_pool,   # the pool before the C.12 repair
    plain_path,                # the port's plain versions in its kernels' place
)

from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (  # noqa: E402
    MaskToImageTrainOptions,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import (  # noqa: E402
    create_model,
)
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops  # noqa: E402
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (  # noqa: E402
    bench_torch_oracle as bo,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (  # noqa: E402
    roofline_step as rs,
)


def rel(got, ref):
    d = (got.double().cpu() - ref.double().cpu()).abs()
    r = ref.double().cpu().abs()
    return {"max_over_max": float(d.max() / r.max()),
            "median_elementwise": float((d / r.clamp_min(1e-300)).median())}


def d_gradients(gpu_ids, num_D):
    opt = MaskToImageTrainOptions(gpu_ids=gpu_ids, batchSize=4, use_masked_image=False,
                                  label_nc=35, ngf=8, n_downsample_global=2, n_blocks_global=1,
                                  num_D=num_D)
    model = create_model(opt)   # fp32: TF32 off
    dev = model.device
    b = synthetic_batch(np.random.RandomState(0), 4, hw=(256, 512), label_nc=35)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    o = bo.Oracle(36, 36, opt.ngf, opt.n_downsample_global, opt.n_blocks_global, opt.ndf,
                  num_D=num_D, device=dev)
    bo.load_port_init(o, model)
    _, cond, real = bo.oracle_inputs(b, 35, masked_image=False)
    fake = torch.rand(real.shape, generator=torch.Generator(dev).manual_seed(1),
                      device=dev) * 2 - 1

    def oracle(ds, dt):
        o.Ds = ds
        fk = fake.to(dt).requires_grad_(True)
        out = o.d_forward(cond.to(dt), fk)
        loss = sum(((s[-1] - 1) ** 2).mean() for s in out)
        return torch.autograd.grad(loss, fk)[0]

    def port(use_plain):
        fk = fake.permute(0, 2, 3, 1).contiguous().requires_grad_(True)
        d = {k: v.detach() for k, v in model.netD.named_parameters()}
        with plain_path() if use_plain else contextlib.nullcontext():
            out = functional_call(model.netD, d, (cond.permute(0, 2, 3, 1).contiguous(), fk))
            loss = sum(((s[-1] - 1) ** 2).mean() for s in out)
        return torch.autograd.grad(loss, fk)[0].permute(0, 3, 1, 2)

    ds32 = o.Ds
    ref = oracle(copy.deepcopy(ds32).double(), torch.float64)
    return {"oracle_fp32": rel(oracle(ds32, torch.float32), ref),
            "port_fp32_kernel_path": rel(port(False), ref),
            "port_fp32_plain_path": rel(port(True), ref)}


def slices_pool(x):
    """The JAX package's ``_avg_pool_3x3s2_slices`` on NHWC (even H, W): the
    strided slices' sums, separable, times an fp32 inverse-count map."""
    ev, od = x[:, :, 0::2], x[:, :, 1::2]
    p = ev + od + F.pad(od[:, :, :-1], (0, 0, 1, 0))
    ev, od = p[:, 0::2], p[:, 1::2]
    s = ev + od + F.pad(od[:, :-1], (0, 0, 0, 0, 1, 0))
    h2, w2 = s.shape[1], s.shape[2]
    rows = torch.full((h2,), 3.0, device=x.device)
    rows[0] = 2.0
    cols = torch.full((w2,), 3.0, device=x.device)
    cols[0] = 2.0
    inv = (1.0 / (rows[:, None] * cols[None, :]))[None, :, :, None]
    return (s.to(torch.float32) * inv).to(x.dtype)


FORMS = {"nnops.avg_pool_3x3s2": nnops.avg_pool_3x3s2,
         "channels_last view (before the repair)": channels_last_view_pool,
         "shifted slices": slices_pool}


def pool_gradients(device):
    g = torch.Generator().manual_seed(0)
    out = {}
    for c in (3, 36):
        xh = torch.randn(4, 256, 512, c, generator=g)
        gy = torch.randn(4, 128, 256, c, generator=g)

        def run(dev, dt, fn):
            x = xh.to(dev, dt).clone().requires_grad_(True)
            y = fn(x)
            y.backward(gy.to(dev, dt))
            return y, x.grad

        ref = run("cpu", torch.float64, nnops.avg_pool_3x3s2)
        for dt in (torch.float32, torch.bfloat16):
            for name, fn in FORMS.items():
                y, dx = run(device, dt, fn)
                out[f"C{c} {str(dt)[6:]} {name}"] = {"forward": rel(y, ref[0]),
                                                      "input_gradient": rel(dx, ref[1])}
    return out


def torch_only_repro(device, shape=(4, 36, 256, 512)):
    """F.avg_pool2d(3, 2, 1, count_include_pad=False) (and AvgPool2d with
    the pad counted, and F.max_pool2d(2, 2)) on a (4, 36, 256, 512) NCHW
    tensor in each memory format, the output gradient in each, fp32 on
    ``device``, against fp64 on the CPU: max |diff| over max |ref| of the
    input gradient, with the formats the backward saw."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).double()   # fp32 values: no new ties in fp32
    ops = {"avg_pool2d(3, 2, 1, count_include_pad=False)":
           lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=False),
           "avg_pool2d(3, 2, 1, count_include_pad=True)": lambda t: F.avg_pool2d(t, 3, 2, 1),
           "avg_pool2d(2, 2)": lambda t: F.avg_pool2d(t, 2, 2),
           "max_pool2d(2, 2)": lambda t: F.max_pool2d(t, 2, 2)}
    fmts = {"contiguous": torch.contiguous_format, "channels_last": torch.channels_last}
    out = {}
    for name, op in ops.items():
        gy = torch.randn(op(x).shape, generator=g, dtype=torch.float64)
        ref_x = x.clone().requires_grad_(True)
        op(ref_x).backward(gy)
        for xf, xfmt in fmts.items():
            for gf, gfmt in fmts.items():
                xd = x.to(device, torch.float32).contiguous(memory_format=xfmt)
                xd.requires_grad_(True)
                y = op(xd)
                y.backward(gy.to(device, torch.float32).contiguous(memory_format=gfmt))
                d = (xd.grad.double().cpu() - ref_x.grad).abs().max() / ref_x.grad.abs().max()
                out[f"{name}, input {xf}, output gradient {gf}"] = {
                    "output_is_channels_last": y.is_contiguous(memory_format=torch.channels_last),
                    "input_gradient_max_over_max": float(d)}
    # the gradient the old port form handed the pool's backward
    seen = {}
    xd = x[:, :3].to(device, torch.float32).permute(0, 2, 3, 1).contiguous()
    xd.requires_grad_(True)
    y = F.avg_pool2d(xd.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=False)
    y.register_hook(lambda gr: seen.update(
        shape=list(gr.shape), stride=list(gr.stride()),
        channels_last=gr.is_contiguous(memory_format=torch.channels_last),
        contiguous=gr.is_contiguous()))
    y.permute(0, 2, 3, 1).contiguous().backward(torch.randn(
        y.permute(0, 2, 3, 1).shape, generator=g).to(device))
    out["grad_output reaching the old form's backward"] = seen
    return out


def pool_times(device, iters=20):
    """Device ms of each form, forward (and backward where the input takes a
    gradient), at the multiscale D's inputs of a bs-32 bf16 flagship step."""
    if device.type != "cuda":
        return None
    from neurips18_hierchical_image_manipulation_tpu_torch.tools.roofline_resblock import (
        cuda_ms,
    )
    g = torch.Generator(device).manual_seed(0)
    cases = {"cond (32, 256, 512, 36), no gradient": ((32, 256, 512, 36), False),
             "[real; fake] (64, 256, 512, 3), no gradient": ((64, 256, 512, 3), False),
             "fake (32, 256, 512, 3), forward + backward": ((32, 256, 512, 3), True)}
    out = {}
    for case, (shape, grad) in cases.items():
        x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
        x.requires_grad_(grad)
        gy = torch.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3], generator=g,
                         device=device).to(torch.bfloat16)
        for name, fn in FORMS.items():
            def run(fn=fn):
                y = fn(x)
                if grad:
                    torch.autograd.grad(y, x, gy)
            out[f"{case}, {name}"] = cuda_ms(run, iters, warmup=3)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpu_ids", default="0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    device = rs.device_of(args.gpu_ids)
    report = {"device": rs.device_line(device), "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version() if device.type == "cuda" else None,
              "d_input_gradient": {f"num_D {n}": d_gradients(args.gpu_ids, n) for n in (2, 1)},
              "avg_pool_3x3s2": pool_gradients(device),
              "torch_only_repro": torch_only_repro(device),
              "ms_bf16_bs32_d_inputs": pool_times(device)}
    rs.write_json(args.out, report)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

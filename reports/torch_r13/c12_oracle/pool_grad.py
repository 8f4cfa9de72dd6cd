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
  2. The port's ``ops/nnops.avg_pool_3x3s2`` (AvgPool2d(3, 2, 1,
     count_include_pad=False) on the channels_last view of an NHWC tensor),
     forward and input gradient, fp32 and bf16, against fp64 on the CPU; and
     the same pool on a contiguous NCHW copy.

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

from chip_smoke import plain_path  # noqa: E402  (the port's plain versions in its kernels' place)

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


def pool_gradients(device):
    g = torch.Generator().manual_seed(0)
    out = {}
    for c in (3, 36):
        xh = torch.randn(4, 256, 512, c, generator=g)
        gy = torch.randn(4, 128, 256, c, generator=g)

        def run(dev, dt, contiguous_copy):
            x = xh.to(dev, dt).clone().requires_grad_(True)
            if contiguous_copy:
                y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
                                 count_include_pad=False).permute(0, 2, 3, 1)
            else:
                y = nnops.avg_pool_3x3s2(x)
            y.backward(gy.to(dev, dt))
            return y, x.grad

        ref = run("cpu", torch.float64, True)
        for dt in (torch.float32, torch.bfloat16):
            for copy_ in (False, True):
                y, dx = run(device, dt, copy_)
                key = f"C{c} {str(dt)[6:]} {'NCHW copy' if copy_ else 'nnops.avg_pool_3x3s2'}"
                out[key] = {"forward": rel(y, ref[0]), "input_gradient": rel(dx, ref[1])}
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
              "avg_pool_3x3s2": pool_gradients(device)}
    rs.write_json(args.out, report)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

"""Ablation timing of the flagship GAN train step on one CUDA card.

    HIMAN_BENCH_BS=32 HIMAN_BENCH_ITERS=20 [HIMAN_ABLATE_ONLY=full,d_only] \\
    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.bench_ablate [--out FILE]

Counterpart of ``tools/bench_ablate.py`` in the JAX package: six variants of
the 512x256 step in the bf16 tier over fp32 masters, at bs
``HIMAN_BENCH_BS`` (default 32), through the port's ``train/steps.py`` and
``models/pix2pixhd.py``:

  full     the flagship step (``make_train_step``: G + 2-scale D + LSGAN +
           FM + VGG, both Adams)
  g_only   G forward + backward + Adam, loss = mean |fake| (the JAX tool's)
  no_vgg   full without the VGG perceptual term (``--no_vgg_loss``)
  no_fm    full without feature matching (``--no_ganFeat_loss``)
  g_vgg    G + VGG only, no D anywhere: loss = lambda_feat * VGG loss
  d_only   D on real and on a fixed (zero) fake, forward + backward + Adam

Each variant's step is timed by ``train/profiler.measure_steps`` over
``HIMAN_BENCH_ITERS`` steps after a warm-up step; one JSON line a variant
(``variant``, ``ms_per_step``, ``img_per_s``, ``peak_memory_gb``) and the
report to ``--out`` (default under ``reports/torch_r13/``), with the card's
name and power limit. ``variant_loss`` gives each variant's objective for
the CPU tests.
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import torch

from ..losses import discriminator_loss, vgg_loss
from ..train.profiler import measure_steps
from ..train.steps import _loss_inputs, cast_batch
from . import roofline_step as rs

VARIANTS = ("full", "g_only", "no_vgg", "no_fm", "g_vgg", "d_only")
# the option each variant's model is built with
OPTIONS = {"no_vgg": {"no_vgg_loss": True}, "no_fm": {"no_ganFeat_loss": True},
           "g_only": {"no_vgg_loss": True}, "d_only": {"no_vgg_loss": True}}


def build(name, args):
    """(opt, model, batch, compute_dtype) of a variant: the flagship with
    its option changes, seeded alike (G and D draw the same init)."""
    return rs.flagship(args, **OPTIONS.get(name, {}))


def _inputs(model, batch, compute_dtype, nets):
    """(params, batch) as the bf16 tier casts them, for ``nets`` only (the
    JAX tool's variants cast the networks they run); fp32: as they are."""
    if compute_dtype is None:
        return None, batch
    return ({n: {k: v.to(compute_dtype) if v.is_floating_point() else v
                 for k, v in model.nets()[n].named_parameters()} for n in nets},
            cast_batch(batch, compute_dtype))


def variant_loss(name, model, batch, compute_dtype):
    """The variant's objective at the model's parameters (fp32 scalar)."""
    if name in ("full", "no_vgg", "no_fm"):
        params, b = _loss_inputs(model, batch, compute_dtype)
        return model.losses(b, params)[0]
    if name == "d_only":
        params, b = _inputs(model, batch, compute_dtype, ("D",))
        fake = torch.zeros_like(b["image"])
        d_real, d_fake = model._d_pair(params, model._cond(b), b["image"], fake)
        return discriminator_loss(d_real, d_fake, True)[0]
    params, b = _inputs(model, batch, compute_dtype, ("G", "VGG") if name == "g_vgg" else ("G",))
    fake = model._apply(params, "G", model._g_input(b, params))
    if name == "g_only":
        return fake.abs().mean().to(torch.float32)
    if name == "g_vgg":
        return (model.opt.lambda_feat
                * vgg_loss(lambda x: model._apply(params, "VGG", x), fake, b["image"])
                ).to(torch.float32)
    raise ValueError(f"unknown variant {name!r}")


def variant_step(name, opt, model, compute_dtype):
    """(step(state, batch), state) of a variant."""
    if name in ("full", "no_vgg", "no_fm"):
        return rs.make_step(opt, model, compute_dtype)
    net = model.netD if name == "d_only" else model.netG
    adam = torch.optim.Adam(net.parameters(), lr=opt.lr, betas=(opt.beta1, 0.999))

    def step(state, batch):
        adam.zero_grad(set_to_none=True)
        loss = variant_loss(name, model, batch, compute_dtype)
        loss.backward()
        adam.step()
        return loss.detach()

    return step, SimpleNamespace(adam=adam)


def _frozen(model, name):
    """The networks a variant does not train take no gradient."""
    for net, m in model.nets().items():
        if net != "VGG":
            m.requires_grad_(not (name == "d_only" and net == "G")
                             and not (name in ("g_only", "g_vgg") and net == "D"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true", help="tiny widths and 64x128")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "bench_ablate.json"))
    args = p.parse_args(argv)
    args.bs = int(os.environ.get("HIMAN_BENCH_BS", "32"))
    args.dtype = "bfloat16"
    iters = int(os.environ.get("HIMAN_BENCH_ITERS", "20"))
    only = [v for v in os.environ.get("HIMAN_ABLATE_ONLY", "").split(",") if v]
    device = rs.device_of(args.gpu_ids)
    rows = []
    for name in VARIANTS:
        if only and name not in only:
            continue
        opt, model, batch, cdt = build(name, args)
        _frozen(model, name)
        step, state = variant_step(name, opt, model, cdt)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        dt = measure_steps(step, state, batch, iters, device)
        row = {"variant": name, "ms_per_step": dt * 1e3, "img_per_s": args.bs / dt,
               "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                  if device.type == "cuda" else None)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del model, step, state, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    report = {"device": rs.device_line(device), "bs": args.bs, "hw": list(
        rs.SMOKE_HW if args.smoke else rs.HW), "dtype": args.dtype, "iters": iters,
        "variants": rows}
    rs.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()

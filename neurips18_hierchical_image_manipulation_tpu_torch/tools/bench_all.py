"""Secondary benchmark harness: the non-headline BASELINE.json configs on
one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.bench_all \\
        [--bs 16] [--iters 50] [--with_1024p] [--out FILE]

Counterpart of ``tools/bench_all.py`` in the JAX package. It times:

  #1 ``g_forward_256x128``: the GlobalGenerator (label_nc 35, ngf 64, 4
     downs, 9 resblocks) forward at 256x128 with masked RGB, ``--bs``;
  #2 ``structure_forward_128``: the box2mask structure generator forward
     (ngf 64, 3 downs, 4 resblocks) on 128x128 crops, ``--bs``;
  #4 ``two_step_edit_512x256``: ``eval/two_step.TwoStepPipeline``'s add of
     class 26 into ``--bs`` 512x256 scenes, both stages above;
  ``--with_1024p``: the 1024p LocalEnhancer train step (ngf 32, one
     enhancer of 3 resblocks, 3-scale D) at 1024x512, bs 4, in the bf16
     tier (``train_1024x512_local_enhancer``).

The JAX tool ran its perf tier (convolutions at ``Precision.DEFAULT``).
The port's inference has no bf16 tier; its counterpart of that precision
is ``--conv_precision default``: fp32 weights and activations with TF32
convolutions, which every inference config here runs under (named in the
output's ``tier``); the 1024p step runs the bf16 tier. Each is timed by
``train/profiler.measure_steps`` (host clock, card synchronized) over
``--iters`` calls after a warm-up call. One JSON line a config (``metric``,
``value``, ``unit``), and the report to ``--out`` (default under
``reports/torch_r13/``), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..configs.options import (
    BoxToMaskTestOptions,
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
)
from ..data.synthetic import synthetic_batch, synthetic_box2mask_batch
from ..eval.two_step import TwoStepPipeline
from ..models.factory import create_model
from ..train.profiler import measure_steps
from . import roofline_step as rs

TIER = "fp32, TF32 convolutions (--conv_precision default)"
# the widths of each config, and the tiny ones of the CPU tests
M2I = dict(label_nc=35, ngf=64, n_downsample_global=4, n_blocks_global=9,
           use_masked_image=True)
B2M = dict(label_nc=35, ngf=64, n_downsample_global=3, n_blocks_global=4, fineSize=128)
LOCAL = dict(netG="local", ngf=32, n_downsample_global=4, n_blocks_global=9, n_blocks_local=3,
             n_local_enhancers=1, num_D=3, n_layers_D=3, label_nc=35, use_masked_image=True)
SMOKE = {"m2i": dict(M2I, ngf=8, n_downsample_global=2, n_blocks_global=1),
         "b2m": dict(B2M, ngf=8, n_downsample_global=2, n_blocks_global=1, fineSize=32),
         "local": dict(LOCAL, ngf=4, n_downsample_global=2, n_blocks_global=1, n_blocks_local=1,
                       num_D=1, n_layers_D=2, ndf=8)}


def _on(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def per_s(fn, n, iters, device):
    """n / seconds a call of fn."""
    return n / measure_steps(lambda s, b: fn(), None, None, iters, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "bench_all.json"))
    p.add_argument("--with_1024p", action="store_true",
                   help="include the 1024p LocalEnhancer train-step config")
    p.add_argument("--smoke", action="store_true", help="tiny widths and sizes (CPU tests)")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    device = rs.device_of(args.gpu_ids)
    bs = args.bs
    rng = np.random.RandomState(0)
    m2i_arch = SMOKE["m2i"] if args.smoke else M2I
    b2m_arch = SMOKE["b2m"] if args.smoke else B2M
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)

    # config #1: GlobalGenerator forward 256x128 label -> RGB
    m2i = create_model(MaskToImageTestOptions(gpu_ids=args.gpu_ids, conv_precision="default",
                                              **m2i_arch))
    b1 = _on(synthetic_batch(rng, bs, hw=(64, 128) if args.smoke else (128, 256),
                             label_nc=m2i_arch["label_nc"]), device)
    emit({"metric": "g_forward_256x128",
          "value": per_s(lambda: m2i.inference(b1), bs, args.iters, device),
          "unit": "images/sec/chip"})

    # config #2: structure generator forward on 128x128 crops
    b2m = create_model(BoxToMaskTestOptions(gpu_ids=args.gpu_ids, conv_precision="default",
                                            **b2m_arch))
    b2 = _on(synthetic_box2mask_batch(rng, bs, size=b2m_arch["fineSize"],
                                      label_nc=b2m_arch["label_nc"]), device)
    emit({"metric": "structure_forward_128",
          "value": per_s(lambda: b2m.inference(b2), bs, args.iters, device),
          "unit": "crops/sec/chip"})

    # config #4: the two-step add at 512x256
    pipe = TwoStepPipeline(b2m, m2i)
    scene = _on(synthetic_batch(rng, bs, hw=(128, 256) if args.smoke else (256, 512),
                                label_nc=m2i_arch["label_nc"]), device)
    cls = torch.full((bs,), 26, dtype=torch.int32, device=device)
    emit({"metric": "two_step_edit_512x256",
          "value": per_s(lambda: pipe.add_object(scene["image"], scene["label"], scene["inst"],
                                                 scene["boxes"], cls), bs, args.iters, device),
          "unit": "edits/sec/chip"})
    del pipe, m2i, b2m

    if args.with_1024p:
        bs1k = 4
        arch = SMOKE["local"] if args.smoke else LOCAL
        opt = MaskToImageTrainOptions(gpu_ids=args.gpu_ids, batchSize=bs1k, dtype="bfloat16",
                                      **arch)
        model = create_model(opt)
        b1k = _on(synthetic_batch(rng, bs1k, hw=(64, 128) if args.smoke else (512, 1024),
                                  label_nc=arch["label_nc"]), device)
        step, state = rs.make_step(opt, model, torch.bfloat16)
        n = max(args.iters // 5, 5)
        emit({"metric": "train_1024x512_local_enhancer",
              "value": bs1k / measure_steps(step, state, b1k, n, device),
              "unit": "images/sec/chip"})

    report = {"configs": results, "bs": bs, "iters": args.iters, "tier": TIER,
              "tier_1024p": "bf16 over fp32 masters", "device": rs.device_line(device)}
    rs.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()

"""Why the bf16 tier's Encoder gradient is far from the fp32 one (ROADMAP
§C.14): one ``--instance_feat`` train step in fp32 and in the bf16 tier
from the same parameters and batch (``tools/grad_audit.step_gradients``),
E's tensors compared (``tensor_diffs``), and for each instance of the
batch the feature-map gradient that ``segment_mean_2d`` sums over it:
|sum g| / sum |g| per channel (how far the sum cancels) in both tiers.

    python reports/torch_r14/encoder_bf16.py [--gpu_ids -1] [--ngf 8] \
        [--hw 256 512] [--out FILE]

The defaults are narrow widths at the flagship's 512x256 on the CPU;
``--ngf 64 --gpu_ids 0`` is the full-width step on the card.
"""

import argparse
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

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
from neurips18_hierchical_image_manipulation_tpu_torch.tools import grad_audit as ga  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpu_ids", default="-1")
    p.add_argument("--ngf", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=[256, 512])
    p.add_argument("--seed", type=int, default=382)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    narrow = {} if args.ngf >= 64 else dict(ngf=args.ngf, ndf=args.ngf, n_downsample_global=2,
                                            n_blocks_global=1, n_layers_D=2)
    arch = dict(narrow, instance_feat=True, feat_num=3, nef=16, n_downsample_E=4)
    m32 = create_model(MaskToImageTrainOptions(gpu_ids=args.gpu_ids, **arch))
    m16 = create_model(MaskToImageTrainOptions(gpu_ids=args.gpu_ids, dtype="bfloat16", **arch))
    ga.copy_params(m32, m16)
    b = synthetic_batch(np.random.RandomState(args.seed), 1, hw=tuple(args.hw), label_nc=35)
    batch = {k: torch.from_numpy(v).to(m32.device) for k, v in b.items()}

    seen = {}
    mean = nnops.segment_mean_2d

    def hooked(feat, ids, n):
        out = mean(feat, ids, n)
        if out.requires_grad:
            out.register_hook(lambda g: seen.__setitem__(str(feat.dtype), (g.double(), ids)))
        return out

    with mock.patch.object(nnops, "segment_mean_2d", hooked):
        _, g32 = ga.step_gradients(m32, batch)
        _, g16 = ga.step_gradients(m16, batch, torch.bfloat16)
    rows = {k: d for k, d in ga.tensor_diffs(g16, g32).items() if k.startswith("E.")}
    cancel = {}
    for dt, (g, ids) in seen.items():
        ids, g = ids.reshape(-1), g.reshape(-1, g.shape[-1])
        cancel[dt] = {int(s): {"pixels": int((ids == s).sum()),
                               "abs_sum_over_sum_abs": (g[ids == s].sum(0).abs()
                                                        / g[ids == s].abs().sum(0)).tolist()}
                      for s in ids.unique()}
    report = {"device": str(m32.device), "arch": arch, "hw": args.hw,
              "bf16_vs_fp32_E": rows, "segments": cancel}
    for k, d in rows.items():
        print(f"{k}: cosine {d['cos']:.4f}, ||g16|| / ||g|| {d['norm_ratio']:.4f}, "
              f"||diff|| / ||g|| {d['rel_l2']:.4f}, flipped {d['flips']:.4f}")
    for dt, segs in cancel.items():
        for s, v in segs.items():
            print(f"{dt} instance {s}: {v['pixels']} pixels, |sum g| / sum |g| "
                  + " ".join(f"{x:.5f}" for x in v["abs_sum_over_sum_abs"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

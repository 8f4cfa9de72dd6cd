"""1024p coarse-to-fine training dynamics on the procedural world.

Drives pix2pixHD's two-stage recipe through the port's train CLI at
1024x512:

  1. the global stage (GlobalGenerator, ngf 64) at 512x256;
  2. the hand-off: ``--load_pretrain`` loads the global run's trunk into
     the LocalEnhancer's ``global`` scope (``utils/checkpoint.
     load_pretrain_into``);
  3. the local stage (``--netG local``, ngf 32) at 1024x512, with
     ``--niter_fix_global`` freezing the trunk for the first ``fix_frac``
     of its epochs.

Draws both stages' loss curves and the local stage's gallery and writes a
summary with the loop's rates and the frozen / unfrozen phases.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.train_dynamics_1024p \\
        --out reports/torch_r12/dynamics_1024p [--gpu_ids -1 for the CPU]

Counterpart of ``tools/train_dynamics_1024p.py`` in the JAX package: its
flags, its CLI argv (``--gpu_ids`` added), its epoch and ``fix_frac``
arithmetic and its summary keys, plus ``device`` and ``wall_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

from ..cli import mask2image_train
from .train_dynamics import (REPORTS, all_finite, contact_sheet, device_line,
                             draw_loss_curves, g_d_panels, loss_keys, make_world,
                             parse_loss_log, resolve, scratch)

GLOBAL, LOCAL = "dyn1024_global", "dyn1024_local"


def stage_epochs(steps, n_images, bs):
    """(steps an epoch, epochs) of a stage: at least two epochs."""
    spe = n_images // bs
    return spe, max(steps // spe, 2)


def schedule(epochs):
    """--niter / --niter_decay: half the epochs constant, the rest decayed."""
    half = max(epochs // 2, 1)
    return ["--niter", str(half), "--niter_decay", str(epochs - half)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--global_steps", type=int, default=400)
    p.add_argument("--local_steps", type=int, default=400)
    p.add_argument("--global_bs", type=int, default=8)
    p.add_argument("--local_bs", type=int, default=4)
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--fix_frac", type=float, default=0.5,
                   help="fraction of local epochs with the global trunk "
                   "frozen (--niter_fix_global)")
    p.add_argument("--out", default=os.path.join(REPORTS, "dynamics_1024p"))
    p.add_argument("--dataroot", default=scratch("himan_dyn_world_1024p"))
    p.add_argument("--ckpt", default=scratch("himan_dyn_ckpt_1024p"))
    p.add_argument("--skip_global", action="store_true")
    p.add_argument("--skip_local", action="store_true")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    device = resolve(args.gpu_ids)
    t0 = time.time()

    if not os.path.exists(os.path.join(args.dataroot, "train_label")):
        print("building 1024x512 procedural world ...")
        make_world(args.dataroot, args.n_images, hw=(512, 1024))

    common = [
        "--dataroot", args.dataroot, "--checkpoints_dir", args.ckpt,
        "--label_nc", "35", "--ndf", "64", "--num_D", "2", "--n_layers_D", "3",
        "--no-use_bbox_dataset", "--no-use_masked_image",
        "--uint8_transfer", "--device_resident_data",
        "--dtype", "bfloat16", "--no_flip",
        "--save_epoch_freq", "1000000",
    ]

    # stage 1: the global generator at 512x256 (scale_width 512)
    spe_g, ep_g = stage_epochs(args.global_steps, args.n_images, args.global_bs)
    if not args.skip_global:
        shutil.rmtree(os.path.join(args.ckpt, GLOBAL), ignore_errors=True)
        mask2image_train.main([
            "--name", GLOBAL, *common,
            "--netG", "global", "--ngf", "64",
            "--n_downsample_global", "4", "--n_blocks_global", "9",
            "--resize_or_crop", "scale_width", "--loadSize", "512",
            "--batchSize", str(args.global_bs), *schedule(ep_g),
            "--print_freq", str(spe_g),
            "--display_freq", str(10 * spe_g),
            "--save_latest_freq", "1000000",  # the loop writes latest at its end
            "--gpu_ids", args.gpu_ids,
        ])

    # stage 2: the LocalEnhancer at 1024x512, the trunk handed off
    spe_l, ep_l = stage_epochs(args.local_steps, args.n_images, args.local_bs)
    fix = max(int(ep_l * args.fix_frac), 1)
    if not args.skip_local:
        shutil.rmtree(os.path.join(args.ckpt, LOCAL), ignore_errors=True)
        mask2image_train.main([
            "--name", LOCAL, *common,
            "--netG", "local", "--ngf", "32",
            "--n_local_enhancers", "1", "--n_blocks_local", "3",
            "--n_downsample_global", "4", "--n_blocks_global", "9",
            "--resize_or_crop", "none",
            "--load_pretrain", os.path.join(args.ckpt, GLOBAL),
            "--niter_fix_global", str(fix),
            "--batchSize", str(args.local_bs), *schedule(ep_l),
            "--print_freq", str(spe_l),
            "--display_freq", str(5 * spe_l),
            "--save_latest_freq", "1000000",
            "--gpu_ids", args.gpu_ids,
        ])

    # the report: both stages' curves, the local stage's gallery, the rates
    os.makedirs(args.out, exist_ok=True)
    summary = {"stages": {}}
    panels = []
    for name, title in ((GLOBAL, "global 512x256: "), (LOCAL, "local (enhancer) 1024x512: ")):
        rows = parse_loss_log(os.path.join(args.ckpt, name, "loss_log.txt"))
        assert rows, f"no loss rows for {name}"
        keys = loss_keys(rows)
        panels.append(g_d_panels(rows, keys, title))
        first, last = rows[0], rows[-1]
        rates = [r["img_per_s_per_chip"] for r in rows if "img_per_s_per_chip" in r]
        summary["stages"][name] = {
            "steps_logged": len(rows),
            "first": {k: first.get(k) for k in keys},
            "last": {k: last.get(k) for k in keys},
            "loop_img_per_s_median": round(float(np.median(rates)), 2) if rates else None,
            "finite": all_finite(rows, keys),
        }
        if name == LOCAL and len(rows) > fix:
            # while the pretrained trunk is frozen only the enhancer branch
            # trains; unfreezing it mid-GAN (fresh Adam moments, a warm D)
            # is a transient of its own, so the two phases are reported
            # apart
            froz, unfr = rows[:fix], rows[fix:]

            def med(rs, k):
                vs = [r[k] for r in rs if k in r]
                return round(float(np.median(vs)), 3) if vs else None

            summary["stages"][name]["phases"] = {
                "frozen_trunk_epochs": fix,
                "frozen": {k: {"first": froz[0].get(k),
                               "min": round(min(r[k] for r in froz if k in r), 3),
                               "median": med(froz, k)} for k in keys},
                "unfrozen_median": {k: med(unfr, k) for k in keys},
            }
    draw_loss_curves(os.path.join(args.out, "loss_curves.png"), panels,
                     "1024p coarse-to-fine dynamics: global -> load_pretrain -> local "
                     f"(niter_fix_global={fix} of {ep_l} epochs), x: print step")
    contact_sheet(os.path.join(args.ckpt, LOCAL, "web", "images"),
                  os.path.join(args.out, "gallery.png"), (512, 256))

    summary["handoff"] = (
        "stage 2 ran --load_pretrain {}/{} (+--niter_fix_global {}): see "
        "'load_pretrain: N leaves loaded' in the local stage's stdout \u2014 "
        "the GlobalGenerator trunk loads into the enhancer's global scope "
        "(utils/checkpoint.load_pretrain_into)".format(args.ckpt, GLOBAL, fix)
    )
    summary["device"] = device_line(device)
    summary["wall_s"] = time.time() - t0
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""Training-dynamics evidence for the structure generator (box2mask): the
second stage's counterpart of ``tools/train_dynamics.py``.

Trains box2mask through the port's train CLI on the same procedural world
(cars with instance ids on road / sky scenes), draws the loss curves and
measures layout mIoU and segmentation consistency with ``cli/evaluate``
twice: with the trained checkpoint and at random init (``--which_epoch
nonexistent``). The difference is the learning evidence.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.train_dynamics_b2m \\
        --steps 800 --out reports/torch_r12/dynamics_b2m [--gpu_ids -1 for the CPU]

Counterpart of ``tools/train_dynamics_b2m.py`` in the JAX package: its
flags, its CLI argv, its epochs from the object count of the port's
``BboxCropDataset``, and its summary keys, plus ``device`` and ``wall_s``.
Its ``--cpu`` is ``--gpu_ids -1`` here, passed to both CLIs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from ..cli import box2mask_train, evaluate
from ..configs.options import BoxToMaskTrainOptions
from ..data.bbox import BboxCropDataset
from .train_dynamics import (REPORTS, all_finite, device_line, draw_loss_curves, loss_keys,
                             make_world, parse_loss_log, resolve, scratch)

NAME = "dynamics_b2m"
HW = (128, 256)
# G architecture and dataset flags (valid for the train and the test options)
ARCH = [
    "--label_nc", "35", "--ngf", "32",
    "--n_downsample_global", "3", "--n_blocks_global", "3",
    "--fineSize", "64", "--min_box_size", "6",
    "--resize_or_crop", "none", "--no_flip",
]
# bg_box_prob: every 4th sample is a null-class background box, the
# supervision remove-mode edits read
TRAIN_ONLY = [
    "--ndf", "32", "--num_D", "1", "--n_layers_D", "2",
    "--bg_box_prob", "0.25", "--lambda_ctx_neg", "5.0",
]


def count_objects(dataroot, **opts):
    """Object records of the bbox-window dataset over the world's train
    split (several boxes an image)."""
    return len(BboxCropDataset(BoxToMaskTrainOptions(dataroot=dataroot, **opts)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--n_images", type=int, default=128)
    p.add_argument("--out", default=os.path.join(REPORTS, "dynamics_b2m"))
    p.add_argument("--dataroot", default=scratch("himan_dyn_world_b2m"))
    p.add_argument("--ckpt", default=scratch("himan_dyn_b2m_ckpt"))
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    p.add_argument("--skip_train", action="store_true")
    args = p.parse_args(argv)
    device = resolve(args.gpu_ids)
    t0 = time.time()
    gpu = ["--gpu_ids", args.gpu_ids]

    if not args.skip_train:
        if not os.path.exists(os.path.join(args.dataroot, "train_label")):
            print("building procedural world ...")
            make_world(args.dataroot, args.n_images, hw=HW)
        n_obj = count_objects(args.dataroot, fineSize=64, min_box_size=6,
                              resize_or_crop="none", no_flip=True)
        steps_per_epoch = max(n_obj // args.bs, 1)
        epochs = max(args.steps // steps_per_epoch, 2)
        shutil.rmtree(os.path.join(args.ckpt, NAME), ignore_errors=True)
        box2mask_train.main([
            "--name", NAME, "--dataroot", args.dataroot,
            "--checkpoints_dir", args.ckpt, *ARCH, *TRAIN_ONLY,
            "--batchSize", str(args.bs),
            "--niter", str(max(epochs // 2, 1)),
            "--niter_decay", str(epochs - max(epochs // 2, 1)),
            "--print_freq", str(steps_per_epoch),
            "--display_freq", str(20 * steps_per_epoch),
            "--save_epoch_freq", "1000000",
            "--save_latest_freq", "1000000",  # the loop writes latest at its end
            *gpu,
        ])

    run_dir = os.path.join(args.ckpt, NAME)
    os.makedirs(args.out, exist_ok=True)

    # layout mIoU of the trained checkpoint and at random init
    eval_flags = [
        "--name", NAME, "--dataroot", args.dataroot,
        "--checkpoints_dir", args.ckpt, *ARCH,
        "--phase", "train", "--how_many", "64",
        "--serial_batches", "--nThreads", "1", "--batchSize", "1", *gpu,
    ]
    trained = evaluate.main(["--stage", "box2mask"] + eval_flags)
    rand = evaluate.main(["--stage", "box2mask"] + eval_flags + ["--which_epoch", "nonexistent"])

    rows = parse_loss_log(os.path.join(run_dir, "loss_log.txt"))
    assert rows, "no loss rows parsed"
    keys = loss_keys(rows)
    draw_loss_curves(
        os.path.join(args.out, "loss_curves_b2m.png"),
        [[("losses", {k: [r.get(k, float("nan")) for r in rows] for k in sorted(keys)})]],
        "box2mask training dynamics (procedural world), x: print step; layout mIoU: random "
        f"{rand['value']:.3f} -> trained {trained['value']:.3f}")

    summary = {
        "steps": args.steps,
        "miou_random_init": rand["value"],
        "miou_trained": trained["value"],
        "seg_consistency_random": rand["segmentation_consistency"],
        "seg_consistency_trained": trained["segmentation_consistency"],
        "final_losses": {k: rows[-1][k] for k in keys},
        "finite": all_finite(rows, keys),
        "device": device_line(device),
        "wall_s": time.time() - t0,
    }
    with open(os.path.join(args.out, "summary_b2m.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

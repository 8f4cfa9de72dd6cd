"""The two-step demo's galleries on the procedural world.

Trains the mask2image stage (bbox windows and the masked image, sized like
the box2mask dynamics stage) through the port's train CLI on
``--device_resident_data``, then runs the port's ``cli/two_step_demo`` for
add, remove and swap with the box2mask run of ``train_dynamics_b2m`` and
copies each HTML gallery into ``--out``.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.train_dynamics_b2m
    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.two_step_gallery \\
        --out reports/torch_r12/two_step [--gpu_ids -1 for the CPU]

Counterpart of ``tools/two_step_gallery.py`` in the JAX package: its flags,
its CLI argv (``--gpu_ids`` added) and its summary keys, plus ``device``
and ``wall_s``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

from ..cli import mask2image_train, two_step_demo
from ..configs.options import MaskToImageTrainOptions
from ..data.bbox import BboxCropDataset
from .train_dynamics import REPORTS, device_line, make_world, resolve, scratch

EDITS = ("add", "remove", "swap")


def ensure_test_split(root, n=4):
    """two_step_demo reads the test split; the dynamics world writes
    train_* only. Copy the first n train scenes (an edit is conditioned on
    the scene's layout, so an identity split serves a gallery)."""
    for sub in ("label", "inst", "img"):
        os.makedirs(os.path.join(root, f"test_{sub}"), exist_ok=True)
        srcs = sorted(glob.glob(os.path.join(root, f"train_{sub}", "*")))[:n]
        for s in srcs:
            d = os.path.join(root, f"test_{sub}", os.path.basename(s))
            if not os.path.exists(d):
                shutil.copy(s, d)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--world", default=scratch("himan_dyn_world_b2m"))
    p.add_argument("--ckpt", default=scratch("himan_dyn_b2m_ckpt"))
    p.add_argument("--b2m_name", default="dynamics_b2m")
    p.add_argument("--m2i_name", default="gallery_m2i")
    p.add_argument("--m2i_steps", type=int, default=600)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--out", default=os.path.join(REPORTS, "two_step"))
    p.add_argument("--how_many", type=int, default=4)
    p.add_argument("--skip_m2i_train", action="store_true")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    device = resolve(args.gpu_ids)
    t0 = time.time()

    if not os.path.isdir(os.path.join(args.world, "train_label")):
        make_world(args.world, 128, hw=(128, 256))
    ensure_test_split(args.world)

    # the m2i stage: bbox windows and the masked RGB through the train CLI,
    # sized like the box2mask dynamics stage
    if not args.skip_m2i_train:
        probe = MaskToImageTrainOptions(
            name="probe", checkpoints_dir=scratch("himan_gal_probe"),
            dataroot=args.world, label_nc=35, fineSize=64, min_box_size=6,
            resize_or_crop="none", no_flip=True,
        )
        n_obj = len(BboxCropDataset(probe).records)
        spe = max(n_obj // args.bs, 1)
        epochs = max(args.m2i_steps // spe, 2)
        flags = [
            "--name", args.m2i_name,
            "--dataroot", args.world,
            "--checkpoints_dir", args.ckpt,
            "--label_nc", "35", "--ngf", "32", "--ndf", "32",
            "--n_downsample_global", "3", "--n_blocks_global", "3",
            "--num_D", "1", "--n_layers_D", "2",
            "--fineSize", "64", "--min_box_size", "6",
            "--resize_or_crop", "none", "--no_flip",
            "--batchSize", str(args.bs),
            "--device_resident_data",
            "--niter", str(max(epochs // 2, 1)),
            "--niter_decay", str(epochs - max(epochs // 2, 1)),
            "--print_freq", str(spe), "--display_freq", str(20 * spe),
            "--save_epoch_freq", "1000000",
            "--save_latest_freq", "1000000",  # the loop writes latest at its end
            "--no_vgg_loss", "--nThreads", "1",
            "--gpu_ids", args.gpu_ids,
        ]
        print(f"[gallery] training m2i: {n_obj} records, {epochs} epochs")
        mask2image_train.main(flags)

    # the demo CLI, one gallery an edit mode
    os.makedirs(args.out, exist_ok=True)
    results = os.path.join(args.ckpt, "demo_results")
    summary = {}
    for edit in EDITS:
        name = f"two_step_{edit}"
        two_step_demo.main([
            "--name", name,
            "--b2m_name", args.b2m_name,
            "--m2i_name", args.m2i_name,
            "--checkpoints_dir", args.ckpt,
            "--results_dir", results,
            "--dataroot", args.world,
            "--edit", edit, "--cls", "26",
            "--how_many", str(args.how_many),
            "--loadSize", "256",
            "--gpu_ids", args.gpu_ids,
        ])
        src = os.path.join(results, name)
        dst = os.path.join(args.out, name)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
        n_imgs = len(os.listdir(os.path.join(dst, "images")))
        summary[edit] = {"images": n_imgs, "gallery": f"{name}/index.html"}
        print(f"[gallery] {edit}: {n_imgs} images")

    report = {
        "world": "procedural label->RGB world (tools/train_dynamics.py)",
        "b2m_ckpt": args.b2m_name,
        "m2i_ckpt": args.m2i_name,
        "edits": summary,
        "demo_cli": "cli/two_step_demo.py (the port's CLI), one pipeline pass per edit",
        "device": device_line(device),
        "wall_s": time.time() - t0,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[gallery] wrote {args.out}")
    return report


if __name__ == "__main__":
    main()

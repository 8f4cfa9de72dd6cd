"""Two-step edit demo: load both stages' generators, run add / remove / swap
edits over the test scenes and write an HTML gallery of (original, input
label, completed label, edited photo).

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.two_step_demo \\
        --name demo --b2m_name b2m_city --m2i_name m2i_city \\
        --dataroot ./datasets/cityscapes --edit add --cls 26 [--gpu_ids -1 for the CPU]

Counterpart of ``cli/two_step_demo.py`` in the JAX package, with its flags
and ``--gpu_ids``. Each stage adopts its trained run's architecture from
``{checkpoints_dir}/{name}/config.json`` and restores G from
``ckpt/{which_epoch}_params.npz`` (written by either package); a run with
no checkpoint keeps its seeded init.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..configs.options import BoxToMaskTestOptions, MaskToImageTestOptions
from ..data.bbox import bboxes_from_instance_map
from ..data.cityscapes import AlignedDataset
from ..eval.two_step import TwoStepPipeline
from ..models.factory import create_model
from ..utils import html as html_mod
from ..utils.checkpoint import restore_params
from ..utils.imaging import save_image, tensor2im, tensor2label

# the keys a stage adopts from its trained run's config.json
ADOPTED = ("ngf", "n_downsample_global", "n_blocks_global", "label_nc", "fineSize", "norm",
           "netG", "no_instance", "n_local_enhancers", "n_blocks_local", "dtype")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="two_step_demo")
    p.add_argument("--b2m_name", default="box2mask_city")
    p.add_argument("--m2i_name", default="mask2image_city")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--dataroot", default="./datasets/cityscapes")
    p.add_argument("--edit", choices=["add", "remove", "swap"], default="add")
    p.add_argument("--cls", type=int, default=26, help="class for add/swap")
    p.add_argument("--how_many", type=int, default=8)
    p.add_argument("--label_nc", type=int, default=35)
    p.add_argument("--fineSize_b2m", type=int, default=128)
    p.add_argument("--fineSize_m2i", type=int, default=256)
    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)

    def stage_opt(cls_, name, fine_size, **kw):
        opt = cls_(name=name, checkpoints_dir=args.checkpoints_dir, dataroot=args.dataroot,
                   label_nc=args.label_nc, fineSize=fine_size, gpu_ids=args.gpu_ids, **kw)
        cfg_path = os.path.join(args.checkpoints_dir, name, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            # dtype too: a bf16-trained stage runs on its precision tier
            for k in ADOPTED:
                if k in cfg and hasattr(opt, k):
                    setattr(opt, k, cfg[k])
            print(f"[{name}] adopted architecture from {cfg_path}")
        return opt

    b2m_opt = stage_opt(BoxToMaskTestOptions, args.b2m_name, args.fineSize_b2m)
    m2i_opt = stage_opt(MaskToImageTestOptions, args.m2i_name, args.fineSize_m2i,
                        use_masked_image=True)
    b2m = create_model(b2m_opt)
    m2i = create_model(m2i_opt)
    restore_params(b2m_opt, b2m)
    restore_params(m2i_opt, m2i)
    pipe = TwoStepPipeline(b2m, m2i)
    dev = b2m.device

    # full scenes and their object boxes
    scenes = AlignedDataset(dataclasses.replace(m2i_opt, resize_or_crop="scale_width",
                                                loadSize=args.loadSize))
    web_dir = os.path.join(args.results_dir, args.name)
    webpage = html_mod.HTML(web_dir, f"two-step {args.edit} demo")

    done = 0
    for idx in range(len(scenes)):
        s = scenes[idx]
        recs = bboxes_from_instance_map(s["inst"], min_size=16)
        if not recs:
            continue
        image, label, inst = (torch.from_numpy(s[k][None]).to(dev)
                              for k in ("image", "label", "inst"))
        boxes = torch.tensor([recs[0]["bbox"]], dtype=torch.float32, device=dev)
        cls = torch.tensor([args.cls if args.edit != "remove" else 0], dtype=torch.int32,
                           device=dev)
        if args.edit == "add":
            out = pipe.add_object(image, label, inst, boxes, cls)
        elif args.edit == "remove":
            out = pipe.remove_object(image, label, inst, boxes)
        else:
            new_boxes = boxes.clone()
            new_boxes[:, 1] += 50.0
            out = pipe.swap_object(image, label, inst, boxes, new_boxes, cls)

        visuals = {
            "original": tensor2im(s["image"]),
            "input_label": tensor2label(s["label"], args.label_nc),
            "completed_label": tensor2label(out["completed_label"][0].cpu().numpy(),
                                            args.label_nc),
            "edited": tensor2im(out["edited_image"][0].to(torch.float32).cpu().numpy()),
        }
        name = os.path.splitext(os.path.basename(s["path"]))[0]
        webpage.add_header(f"{name} [{args.edit}]")
        ims = []
        for k, v in visuals.items():
            fn = f"{name}_{k}.png"
            save_image(v, os.path.join(webpage.get_image_dir(), fn))
            ims.append(fn)
        webpage.add_images(ims, list(visuals), ims)
        done += 1
        if done >= args.how_many:
            break
    webpage.save()
    print(f"wrote {done} edits to {web_dir}")
    return done


if __name__ == "__main__":
    main()

"""Quantitative two-step edit metrics on paired procedural scenes.

Runs the port's ``TwoStepPipeline`` (both stages restored from CLI-trained
runs, loaded as ``cli/two_step_demo`` loads them) over scenes whose edit
ground truth is known: ``train_dynamics.synth_scene(paired_car=True)``
renders every scene with and without its last-drawn car.

  * remove at car_box on the full scene: the completed layout in the box
    must match label_pre (context-restore accuracy);
  * add (class 26) at car_box on the pre scene: the completed layout in
    the box must match the full scene's (in-box accuracy, car IoU);
  * both: outside the edited box the label map and the photo must pass
    through bit for bit (``*_passthrough`` exactly 0).

Writes the numbers into ``{out}/summary.json`` (merged as
``edit_metrics``).

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.two_step_metrics \\
        --ckpt CKPT --b2m_name dynamics_b2m --m2i_name gallery_m2i \\
        --out reports/torch_r12/two_step [--gpu_ids -1 for the CPU]

Counterpart of ``tools/two_step_metrics.py`` in the JAX package: its flags
(``--gpu_ids`` added), its scenes (``RandomState(7)``) and its report.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..cli.two_step_demo import ADOPTED
from ..configs.options import BoxToMaskTestOptions, MaskToImageTestOptions
from ..eval import two_step_metrics as m
from ..eval.two_step import TwoStepPipeline
from ..models.factory import create_model
from ..utils.checkpoint import restore_params
from .train_dynamics import REPORTS, resolve, scratch, synth_scene


def load_stage(cls_, name, ckpt_dir, fine_size, label_nc, gpu_ids="0", **kw):
    """A stage's model with its run's weights, adopting the run's
    architecture (and dtype) from its config.json as two_step_demo does."""
    opt = cls_(name=name, checkpoints_dir=ckpt_dir, label_nc=label_nc, fineSize=fine_size,
               gpu_ids=gpu_ids, **kw)
    cfg_path = os.path.join(ckpt_dir, name, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        for k in ADOPTED:
            if k in cfg and hasattr(opt, k):
                setattr(opt, k, cfg[k])
    model = create_model(opt)
    restore_params(opt, model)
    return model


def scene_rows(pipe, n_scenes, hw, seed=7):
    """One row of metrics a paired scene: remove at the car's box on the
    full scene, add of class 26 there on the pre scene."""
    dev = pipe.b2m.device
    h, w = hw
    rng = np.random.RandomState(seed)

    def float_img(u8):
        return u8[None].astype(np.float32) / 127.5 - 1.0

    def ids(a):
        return torch.from_numpy(np.ascontiguousarray(a[None]).astype(np.int32)).to(dev)

    def host(t):
        return t[0].to(torch.float32 if t.is_floating_point() else t.dtype).cpu().numpy()

    rows = []
    for i in range(n_scenes):
        s = synth_scene(rng, h, w, i, n_scenes, paired_car=True)
        box = np.asarray(s["car_box"], np.float32)
        boxes = torch.from_numpy(box[None]).to(dev)
        cls26 = torch.tensor([26], dtype=torch.int32, device=dev)

        # remove the car from the full scene; the truth is the pre scene
        img = float_img(s["img"])
        out = pipe.remove_object(torch.from_numpy(img).to(dev), ids(s["label"]),
                                 ids(s["inst"]), boxes)
        rm_label, rm_img = host(out["completed_label"]), host(out["edited_image"])
        row = {
            "remove_context_restore_acc": m.inbox_accuracy(rm_label, s["label_pre"], box),
            "remove_label_passthrough": m.outside_box_max_abs(rm_label, s["label"], box),
            "remove_image_passthrough": m.outside_box_max_abs(rm_img, img[0], box),
        }

        # add a car at the same box on the pre scene; the truth is the full scene
        img_pre = float_img(s["img_pre"])
        out = pipe.add_object(torch.from_numpy(img_pre).to(dev), ids(s["label_pre"]),
                              ids(s["inst_pre"]), boxes, cls26)
        add_label, add_img = host(out["completed_label"]), host(out["edited_image"])
        row.update(
            add_inbox_acc=m.inbox_accuracy(add_label, s["label"], box),
            add_car_iou=m.inbox_class_iou(add_label, s["label"], box, 26),
            add_label_passthrough=m.outside_box_max_abs(add_label, s["label_pre"], box),
            add_image_passthrough=m.outside_box_max_abs(add_img, img_pre[0], box),
        )
        rows.append(row)
        print(f"[metrics] scene {i}: " + json.dumps({k: round(v, 4) for k, v in row.items()}))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=scratch("himan_dyn_b2m_ckpt"))
    p.add_argument("--b2m_name", default="dynamics_b2m")
    p.add_argument("--m2i_name", default="gallery_m2i")
    p.add_argument("--n_scenes", type=int, default=8)
    p.add_argument("--hw", default="128x256")
    p.add_argument("--label_nc", type=int, default=35)
    p.add_argument("--out", default=os.path.join(REPORTS, "two_step"))
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    resolve(args.gpu_ids)

    b2m = load_stage(BoxToMaskTestOptions, args.b2m_name, args.ckpt, 128, args.label_nc,
                     args.gpu_ids)
    m2i = load_stage(MaskToImageTestOptions, args.m2i_name, args.ckpt, 256, args.label_nc,
                     args.gpu_ids, use_masked_image=True)
    pipe = TwoStepPipeline(b2m, m2i)
    hw = [int(v) for v in args.hw.split("x")]
    rows = scene_rows(pipe, args.n_scenes, hw)

    metrics = {k: m.summarize([r[k] for r in rows]) for k in rows[0]}
    report = {
        "n_scenes": args.n_scenes,
        "world": "procedural paired scenes (train_dynamics.synth_scene, "
        "paired_car=True): GT known for both remove (pre-car layout) and "
        "add (the real car's layout)",
        "metrics": metrics,
        "passthrough_basis": "outside_box_max_abs must be exactly 0: the "
        "pipeline composes with torch.where(box_mask) at full res",
        "rows": rows,
    }
    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "summary.json")
    existing = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            existing = json.load(f)
    existing["edit_metrics"] = report
    with open(summary_path, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"[metrics] wrote {summary_path}")
    print(json.dumps(metrics, indent=1))
    return report


if __name__ == "__main__":
    main()

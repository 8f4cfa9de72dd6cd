"""Offline bbox preprocessing: scan a Cityscapes-layout dataroot's
``{phase}_inst`` instance maps and write ``{phase}_bboxes.json``, the
per-object records the bbox-window datasets train from
(``data/bbox.BboxCropDataset`` reads the file when it is there).

Counterpart of ``tools/preprocess_city_bboxes.py`` in the JAX package: the
maps in ``data/image_folder.make_dataset`` order, each object's record
from ``data/bbox.bboxes_from_instance_map`` (the C++ one-pass scanner of
``data/native.py``, else its numpy twin), written by
``data/bbox.save_bbox_records``.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.preprocess_city_bboxes \\
        --dataroot ./datasets/cityscapes --phase train --min_box_size 16

A pass over files on the host: it runs no model and uses no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from ..data.bbox import bboxes_from_instance_map, save_bbox_records
from ..data.image_folder import make_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--phase", default="train")
    p.add_argument("--min_box_size", type=int, default=16)
    p.add_argument("--max_box_size", type=int, default=10_000)
    args = p.parse_args(argv)

    inst_paths = make_dataset(os.path.join(args.dataroot, f"{args.phase}_inst"))
    records = []
    for idx, path in enumerate(inst_paths):
        inst = np.asarray(Image.open(path), np.int32)
        if inst.ndim == 3:
            inst = inst[..., 0]
        for rec in bboxes_from_instance_map(inst, args.min_box_size, args.max_box_size):
            rec["image_index"] = idx
            records.append(rec)
        if (idx + 1) % 100 == 0:
            print(f"{idx + 1}/{len(inst_paths)} images, {len(records)} objects")

    out = os.path.join(args.dataroot, f"{args.phase}_bboxes.json")
    save_bbox_records(records, out)
    print(f"wrote {len(records)} object records to {out}")
    return records


if __name__ == "__main__":
    main()

"""Precompute per-image encoder feature maps for ``--load_features``
(pix2pixHD's precompute_feature_maps step; counterpart of the JAX
repository's ``tools/precompute_feature_maps.py``).

Runs a trained run's instance-feature Encoder over every sample of
``{dataroot}/{phase}_label|_inst|_img`` at native resolution, unaugmented
(the train-time transform is applied to the loaded map as to the label),
and saves one float32 ``.npy`` per image as
``{dataroot}/{phase}_feat/{label basename}.npy`` (exact floats, not the
reference's PNG round trip, as in the JAX package).

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.precompute_feature_maps \\
        --name NAME --dataroot DIR --instance_feat [--which_epoch latest] \\
        [--phase train] [--gpu_ids -1 for the CPU]

Then train with ``--instance_feat --load_features --no-use_bbox_dataset
--no-use_masked_image``. The phase is ``train`` unless ``--phase`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..configs.options import MaskToImageTestOptions, parse_cli
from ..data.cityscapes import AlignedDataset
from ..data.transforms import normalize_rgb
from ..models.factory import create_model
from ..utils.checkpoint import restore_params


def main(argv=None):
    opt = parse_cli(MaskToImageTestOptions, argv)
    probe = argparse.ArgumentParser(add_help=False)
    probe.add_argument("--phase", default=None)
    if probe.parse_known_args(argv if argv is not None else sys.argv[1:])[0].phase is None:
        opt.phase = "train"     # the maps are read at train time
    if not (opt.instance_feat or opt.label_feat):
        raise ValueError("precompute_feature_maps needs --instance_feat or --label_feat "
                         "(the model has no Encoder otherwise)")
    # a native-resolution, unaugmented pass: each map a function of its image
    opt.resize_or_crop, opt.no_flip, opt.serial_batches = "none", True, True
    opt.load_features = opt.uint8_transfer = False
    model = create_model(opt)
    ds = AlignedDataset(opt)
    if ds.image_paths is None:
        raise FileNotFoundError(f"no {opt.phase}_img dir under {opt.dataroot}")
    if not restore_params(opt, model):
        print("WARNING: encoding with the random init")
    use_inst = bool(opt.instance_feat)
    out_dir = os.path.join(opt.dataroot, f"{opt.phase}_feat")
    os.makedirs(out_dir, exist_ok=True)
    feat = None
    with torch.inference_mode():
        for i in range(len(ds)):
            s = ds[i]
            img = s["image"] if s["image"].dtype != np.uint8 else normalize_rgb(s["image"])
            seg = s["inst"] if use_inst else s["label"]
            feat = model.netE(
                torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(model.device),
                torch.from_numpy(np.asarray(seg, np.int32)[None]).to(model.device),
            )[0].to(torch.float32).cpu().numpy()
            stem = os.path.splitext(os.path.basename(s["path"]))[0]
            np.save(os.path.join(out_dir, stem + ".npy"), feat)
    print(f"wrote {len(ds)} feature maps ({None if feat is None else feat.shape}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()

"""box2mask test/inference entry point: load the structure generator at
--which_epoch (a ``*_params.npz`` sidecar written by either package, or
random init from --seed), predict the layout of --how_many object crops and
write an HTML gallery (the masked input, the predicted and the GT layout)
under --results_dir.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.box2mask_test \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/box2mask_test.py`` in the JAX package. As there, the
test options keep the base generator depth (``--n_downsample_global 4
--n_blocks_global 9``): pass the depth the run was trained with, else the
checkpoint loads in part ("checkpoint partial load").
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..configs.options import BoxToMaskTestOptions, parse_cli
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..utils import html as html_mod
from ..utils.checkpoint import restore_params
from ..utils.imaging import tensor2label
from ..utils.visualizer import Visualizer


def main(argv=None):
    opt = parse_cli(BoxToMaskTestOptions, argv)
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    visualizer = Visualizer(opt)
    restore_params(opt, model)

    web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.which_epoch}")
    webpage = html_mod.HTML(
        web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, Epoch = {opt.which_epoch}"
    )

    done = 0
    for host_batch in loader:
        batch = {
            k: torch.from_numpy(v).to(model.device)
            for k, v in host_batch.items()
            if not isinstance(v, list)
        }
        merged, _ = model.inference(batch)
        merged = merged.to(torch.float32).cpu().numpy()
        for i in range(merged.shape[0]):
            visuals = {
                "input_masked": tensor2label(
                    np.where(host_batch["boxmask"][i, :, :, 0] > 0, 0,
                             host_batch["masked_layout"][i]),
                    opt.label_nc,
                ),
                "predicted_layout": tensor2label(merged[i], opt.label_nc),
                "gt_layout": tensor2label(host_batch["gt_layout"][i], opt.label_nc),
            }
            visualizer.save_images(webpage, visuals, host_batch["path"][i])
            done += 1
            if done >= opt.how_many:
                break
        if done >= opt.how_many:
            break
    webpage.save()
    print(f"wrote {done} results to {web_dir}")


if __name__ == "__main__":
    main()

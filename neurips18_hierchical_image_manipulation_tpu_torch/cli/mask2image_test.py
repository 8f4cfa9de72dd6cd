"""mask2image test/inference entry point: load the generator at --which_epoch
(a JAX-written ``*_params.npz`` sidecar, or random init from --seed), run
--how_many samples, write an HTML gallery under --results_dir.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_test \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/mask2image_test.py`` in the JAX package, without the
W-sharded (--spatial_shards) and cluster-feature flows, which wait.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..configs.options import MaskToImageTestOptions, parse_cli
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..utils import html as html_mod
from ..utils.checkpoint import restore_params
from ..utils.imaging import tensor2im, tensor2label
from ..utils.visualizer import Visualizer


def main(argv=None):
    opt = parse_cli(MaskToImageTestOptions, argv)
    if opt.spatial_shards > 1:
        raise NotImplementedError("--spatial_shards is not ported yet")
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
        fake = model.inference(batch).to(torch.float32).cpu().numpy()
        for i in range(fake.shape[0]):
            visuals = {
                "input_label": tensor2label(host_batch["label"][i], opt.label_nc),
                "synthesized_image": tensor2im(fake[i]),
            }
            if opt.aspect_ratio != 1.0:
                # reference save_images: stretch W by aspect_ratio
                from PIL import Image

                for k, v in visuals.items():
                    h, w = v.shape[:2]
                    visuals[k] = np.asarray(
                        Image.fromarray(v).resize(
                            (int(w * opt.aspect_ratio), h), Image.BICUBIC
                        )
                    )
            if "image" in host_batch:
                visuals["real_image"] = tensor2im(host_batch["image"][i])
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

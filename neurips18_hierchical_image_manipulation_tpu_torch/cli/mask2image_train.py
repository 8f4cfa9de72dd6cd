"""mask2image train entry point: the pix2pixHD GAN (GlobalGenerator,
multiscale PatchGAN, LSGAN + feature matching + VGG19, Adam) on bbox
context windows.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_train \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/mask2image_train.py`` in the JAX package (one device;
the data-parallel mesh waits for a later slice). ``--dtype bfloat16`` trains
the bf16 tier, ``--pool_size N`` replays fakes to D from an image pool,
``--continue_train`` resumes from ``--which_epoch``. Writes
``{checkpoints_dir}/{name}/``: ``ckpt/{latest,N}/`` (resumable state),
``ckpt/{latest,N}_params.npz`` (which the serving CLI and the JAX package
load), ``iter.txt``, ``loss_log.txt`` and the ``web/index.html`` visuals.
"""

from __future__ import annotations

import functools

from ..configs.options import MaskToImageTrainOptions, check_train_options, parse_cli
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..train import loop


def main(argv=None):
    opt = parse_cli(MaskToImageTrainOptions, argv)
    check_train_options(opt)
    loader = CreateDataLoader(opt)
    print(f"#training samples = {len(loader.dataset)}")
    model = create_model(opt)
    make_visuals = functools.partial(loop.mask2image_visuals, label_nc=opt.label_nc)
    return loop.train(opt, model, loader, make_visuals=make_visuals)


if __name__ == "__main__":
    main()

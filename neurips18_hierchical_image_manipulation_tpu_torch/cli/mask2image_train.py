"""mask2image train entry point: the pix2pixHD GAN (GlobalGenerator,
multiscale PatchGAN, LSGAN + feature matching + VGG19, Adam) on bbox
context windows.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_train \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/mask2image_train.py`` in the JAX package (its
data-parallel mesh too: ``--mesh_devices N`` over N ranks, started by
``torchrun`` or, without it, here as N local processes; ``--batchSize`` is
the global batch). ``--dtype bfloat16`` trains
the bf16 tier, ``--pool_size N`` replays fakes to D from an image pool,
``--continue_train`` resumes from ``--which_epoch``. Writes
``{checkpoints_dir}/{name}/``: ``ckpt/{latest,N}/`` (resumable state),
``ckpt/{latest,N}_params.npz`` (which the serving CLI and the JAX package
load), ``iter.txt``, ``loss_log.txt`` and the ``web/index.html`` visuals.
"""

from __future__ import annotations

import functools
import sys

from ..configs.options import MaskToImageTrainOptions, check_train_options, parse_cli
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..parallel import make_data_mesh
from ..parallel.distributed import initialize_for, launch_local, shutdown
from ..train import loop


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = parse_cli(MaskToImageTrainOptions, argv)
    check_train_options(opt)
    started = initialize_for(opt.gpu_ids)
    try:
        mesh = make_data_mesh(opt)
        if mesh is not None and (not mesh.launched or mesh.rank == 0):
            print(f"data-parallel mesh over {mesh.world_size} devices", flush=True)
        if mesh is not None and not mesh.launched:
            return launch_local(f"{__package__}.mask2image_train", argv, mesh.world_size,
                                opt.gpu_ids)
        loader = CreateDataLoader(opt)
        if mesh is None or mesh.rank == 0:
            print(f"#training samples = {len(loader.dataset)}")
        model = create_model(opt)
        make_visuals = functools.partial(loop.mask2image_visuals, label_nc=opt.label_nc)
        return loop.train(opt, model, loader, make_visuals=make_visuals, mesh=mesh)
    finally:
        shutdown(started)


if __name__ == "__main__":
    main()

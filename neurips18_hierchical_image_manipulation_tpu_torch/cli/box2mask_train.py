"""box2mask train entry point: the two-stream structure generator and its
layout discriminator (per-stream CE + object BCE + LSGAN, Adam) on bbox
context-window crops.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.box2mask_train \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/box2mask_train.py`` in the JAX package (its
data-parallel mesh too: ``--mesh_devices N`` over N ranks, started by
``torchrun`` or, without it, here as N local processes; ``--batchSize`` is
the global batch). ``--bg_box_prob`` and
``--lambda_ctx_neg`` set the background-box augmentation and the
negative-class penalty; ``--dtype bfloat16`` trains the bf16 tier;
``--continue_train`` resumes from ``--which_epoch``; ``--pool_size`` is
accepted and changes nothing (the JAX package's box2mask trains the fused
step whatever it says). Writes ``{checkpoints_dir}/{name}/`` as the
mask2image train CLI does: ``ckpt/{latest,N}/``, ``ckpt/{latest,N}_params.npz``
(which ``box2mask_test`` and the JAX package load), ``iter.txt``,
``loss_log.txt`` and the ``web/index.html`` visuals.
"""

from __future__ import annotations

import functools
import sys

from ..configs.options import BoxToMaskTrainOptions, check_train_options, parse_cli
from ..data.loader import CreateDataLoader
from ..models.factory import create_model
from ..parallel import make_data_mesh
from ..parallel.distributed import initialize_for, launch_local, shutdown
from ..train import loop


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = parse_cli(BoxToMaskTrainOptions, argv)
    check_train_options(opt)
    started = initialize_for(opt.gpu_ids)
    try:
        mesh = make_data_mesh(opt)
        if mesh is not None and (not mesh.launched or mesh.rank == 0):
            print(f"data-parallel mesh over {mesh.world_size} devices", flush=True)
        if mesh is not None and not mesh.launched:
            return launch_local(f"{__package__}.box2mask_train", argv, mesh.world_size,
                                opt.gpu_ids)
        loader = CreateDataLoader(opt)
        if mesh is None or mesh.rank == 0:
            print(f"#object crops = {len(loader.dataset)}")
        model = create_model(opt)
        make_visuals = functools.partial(loop.box2mask_visuals, label_nc=opt.label_nc)
        return loop.train(opt, model, loader, make_visuals=make_visuals, mesh=mesh)
    finally:
        shutdown(started)


if __name__ == "__main__":
    main()

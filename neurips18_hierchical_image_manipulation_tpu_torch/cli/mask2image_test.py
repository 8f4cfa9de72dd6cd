"""mask2image test/inference entry point: load the generator at --which_epoch
(a JAX-written ``*_params.npz`` sidecar, or random init from --seed), run
--how_many samples, write an HTML gallery under --results_dir.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_test \\
        --name NAME --dataroot DIR [--gpu_ids -1 for the CPU]

Counterpart of ``cli/mask2image_test.py`` in the JAX package. ``--spatial_shards
N`` serves over N ranks with every generator layer's activations split
along W (``parallel/spatial.py``; ``torchrun`` starts the ranks, or this
CLI starts N local processes; ``--gpu_ids 0,0`` places two on one card,
over gloo): each rank builds its own W slab of the conditioning with the
plain (unpacked) encode, runs its slab and rank 0 gathers the output and
writes the gallery. ``--netG local`` serves the
1024p LocalEnhancer; under ``--instance_feat`` without
``--use_encoded_image``, an existing ``--cluster_path`` npy
(``tools/encode_features.py``) paints each instance with a cluster center
of its class as the features (JAX ``:47-56,125-131``), else the Encoder
encodes the real image.
"""

from __future__ import annotations

import os

import sys

import numpy as np
import torch

from ..configs.options import MaskToImageTestOptions, parse_cli
from ..data.loader import CreateDataLoader
from ..eval.features import sample_cluster_features
from ..models.factory import create_model
from ..ops import boxcomposite, onehot_edges
from ..parallel import make_mesh, spatial
from ..parallel.distributed import initialize_for, launch_local, shutdown
from ..utils import html as html_mod
from ..utils.checkpoint import restore_params
from ..utils.imaging import tensor2im, tensor2label
from ..utils.visualizer import Visualizer


def _cond_slab(opt, host_batch, lo, hi, device):
    """Columns [lo, hi) of the generator's conditioning (the JAX package's
    unpacked encode, ``:102-115``), built from the host batch widened by a
    column a side so that the instance edges at the slab's borders see
    their neighbours; the boxes shift to the slab's coordinates."""
    w = host_batch["label"].shape[2]
    a, b = max(lo - 1, 0), min(hi + 1, w)

    def cols(k):
        return torch.from_numpy(np.ascontiguousarray(host_batch[k][:, :, a:b])).to(device)

    inst = None if opt.no_instance else cols("inst")
    if getattr(opt, "use_masked_image", False):
        img = cols("image")
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 127.5 - 1.0
        boxes = torch.from_numpy(host_batch["boxes"]).to(device, torch.float32).clone()
        boxes[:, 1] -= a
        g = onehot_edges.encode_input_rgb(cols("label"), inst,
                                          boxcomposite.mask_box(img, boxes, fill=0.0),
                                          opt.label_nc)
    else:
        g = onehot_edges.encode_input(cols("label"), inst, opt.label_nc)
    return g[:, :, lo - a:hi - a]


def spatial_forward(opt, model, mesh):
    """host batch -> the full generator output, every layer W-sharded over
    ``mesh`` (JAX ``make_fwd``'s ``--spatial_shards`` branch)."""
    g = model.netG
    if opt.netG == "local":
        fwd = spatial.make_spatial_local_enhancer(
            mesh, g, n_downsample_global=opt.n_downsample_global,
            n_blocks_global=opt.n_blocks_global, n_local_enhancers=opt.n_local_enhancers,
            n_blocks_local=opt.n_blocks_local)
    else:
        fwd = spatial.make_spatial_generator(mesh, g, n_downsampling=opt.n_downsample_global,
                                             n_blocks=opt.n_blocks_global)
    n, r = mesh.axis_size("data"), mesh.axis_index("data")

    def run(host_batch):
        w = host_batch["label"].shape[2]
        if w % n:
            raise ValueError(f"W {w} does not split over {n} shards")
        ws = w // n
        return spatial.gather_w(fwd(_cond_slab(opt, host_batch, r * ws, (r + 1) * ws,
                                               model.device)), mesh)

    return run


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = parse_cli(MaskToImageTestOptions, argv)
    if opt.spatial_shards <= 1:
        return serve(opt)
    # the JAX package's conditions (:64-69)
    if opt.netG not in ("global", "local"):
        raise ValueError("--spatial_shards needs netG=global or local")
    if opt.instance_feat or opt.label_feat:
        raise ValueError("--spatial_shards is incompatible with encoder features")
    started = initialize_for(opt.gpu_ids)
    try:
        if not torch.distributed.is_initialized():
            return launch_local(f"{__package__}.mask2image_test", argv, opt.spatial_shards,
                                opt.gpu_ids)
        return serve(opt, make_mesh((opt.spatial_shards,), ("data",)))
    finally:
        shutdown(started)


def serve(opt, mesh=None):
    """The gallery; under a spatial ``mesh`` rank 0 writes it."""
    main_rank = mesh is None or mesh.rank == 0
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    restore_params(opt, model)

    web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.which_epoch}")
    if main_rank:
        visualizer = Visualizer(opt)
        webpage = html_mod.HTML(
            web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, Epoch = {opt.which_epoch}"
        )
    fwd = None
    if mesh is not None:
        fwd = spatial_forward(opt, model, mesh)
        if main_rank:
            print(f"spatial inference: W sharded over {opt.spatial_shards} devices")

    clusters = None
    if opt.instance_feat and not opt.use_encoded_image and os.path.exists(opt.cluster_path):
        clusters = np.load(opt.cluster_path)
        print(f"loaded feature clusters {clusters.shape} from {opt.cluster_path}")

    done = 0
    for host_batch in loader:
        if clusters is not None:
            host_batch = dict(host_batch, feat=sample_cluster_features(
                clusters, np.asarray(host_batch["inst"])))
        if fwd is None:
            out = model.inference({k: torch.from_numpy(v).to(model.device)
                                   for k, v in host_batch.items() if not isinstance(v, list)})
        else:
            out = fwd(host_batch)
        fake = out.to(torch.float32).cpu().numpy()
        if not main_rank:
            done += fake.shape[0]
            if done >= opt.how_many:
                break
            continue
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
    if main_rank:
        webpage.save()
        print(f"wrote {done} results to {web_dir}")


if __name__ == "__main__":
    main()

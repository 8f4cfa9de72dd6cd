"""Export either stage's inference as a ``torch.export`` program for
serving.

The counterpart of ``tools/export_inference.py`` in the JAX package, which
exports StableHLO with ``jax.export``. Here the stage's ``inference`` is
wrapped in an ``nn.Module`` and traced by ``torch.export.export``; the
program (weights included) is written with ``torch.export.save`` as a
``.pt2`` file.

The kernels on the serving path are in the exported graph as the custom
ops ``himan::encode`` and ``himan::instance_norm`` (``kernels/ops.py``): a
reloaded program launches the same hand-written kernels as the eager
forward, on the card. There is no fallback: a graph without them (the
plain composition traced in their place) raises.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.export_inference \\
        --stage mask2image --out m2i.pt2 --label_nc 35 --fineSize 256 \\
        [--gpu_ids -1 for the CPU]

``load(path)`` imports ``kernels.ops`` before ``torch.export.load``, so a
serving process finds the ops.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..configs.options import BoxToMaskTestOptions, MaskToImageTestOptions
from ..data.synthetic import synthetic_batch, synthetic_box2mask_batch
from ..kernels import ops as kops
from ..models.factory import create_model

# the ops each stage's exported graph must hold
REQUIRED = {"mask2image": (kops.ENCODE, kops.INSTANCE_NORM),
            "box2mask": (kops.INSTANCE_NORM,)}


class Inference(torch.nn.Module):
    """A stage's ``inference`` as a module: its generator is registered, so
    the export lifts its weights."""

    def __init__(self, model):
        super().__init__()
        self.netG = model.netG
        self.model = model

    def forward(self, batch):
        return self.model.inference(batch)


def build(stage, label_nc=35, fine_size=256, batch_size=1, gpu_ids="0", seed=0, **arch):
    """The stage's model at its options' defaults (``arch`` overrides) and a
    synthetic batch on its device, from ``RandomState(seed)`` as the JAX
    tool draws it."""
    rng = np.random.RandomState(seed)
    cls_ = MaskToImageTestOptions if stage == "mask2image" else BoxToMaskTestOptions
    opt = cls_(name="export", label_nc=label_nc, fineSize=fine_size, gpu_ids=gpu_ids, **arch)
    model = create_model(opt)
    if stage == "mask2image":
        host = synthetic_batch(rng, batch_size, hw=(fine_size, fine_size), label_nc=label_nc)
    else:
        host = synthetic_box2mask_batch(rng, batch_size, size=fine_size, label_nc=label_nc)
    return model, {k: torch.from_numpy(v).to(model.device) for k, v in host.items()}


def export(stage, model, batch) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the stage's inference on ``batch``; raises
    unless the graph holds the stage's kernel ops."""
    with torch.no_grad():
        ep = torch.export.export(Inference(model).eval(), (batch,))
    found = kops.exported_ops(ep.graph_module)
    missing = [op for op in REQUIRED[stage] if not found[op]]
    if missing:
        raise RuntimeError(f"exported {stage} graph lacks the kernel ops {missing} "
                           f"(found {found}): the plain composition was traced in their place")
    return ep


def save(ep, path) -> int:
    """Write the program to ``path``; returns its bytes."""
    torch.export.save(ep, path)
    return os.path.getsize(path)


def load(path) -> torch.export.ExportedProgram:
    """Read a program written by ``save``, with the kernel ops registered."""
    from ..kernels import ops  # noqa: F401  (registers himan::encode / instance_norm)

    return torch.export.load(path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stage", choices=["mask2image", "box2mask"], required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--label_nc", type=int, default=35)
    p.add_argument("--fineSize", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)

    model, batch = build(args.stage, args.label_nc, args.fineSize, args.batch, args.gpu_ids)
    ep = export(args.stage, model, batch)
    n = save(ep, args.out)
    print(f"exported {args.stage} inference: {n} bytes, device={model.device}, "
          f"ops={kops.exported_ops(ep.graph_module)}")
    return ep, n


if __name__ == "__main__":
    main()

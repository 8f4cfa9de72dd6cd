"""Parity evaluation over the test split; prints one JSON line.

  * ``--stage box2mask``: layout mIoU and in-box segmentation consistency
    between the predicted and the GT layouts of the bbox crops.
  * ``--stage mask2image``: FID between generated and real windows over
    mean-pooled VGG19 relu5_1 features. ``--feature_params FILE`` loads
    the VGG weights from an npz of ``params/conv{b}_{c}/{kernel,bias}``
    (the layout the JAX package's evaluator reads); without it the VGG
    keeps its init from seed 0, so FID values of the two packages are
    comparable only with a shared weights file.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.evaluate \\
        --stage box2mask --name N --dataroot D [--gpu_ids -1 for the CPU]

Counterpart of ``cli/evaluate.py`` in the JAX package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs.options import BoxToMaskTestOptions, MaskToImageTestOptions, parse_cli
from ..data.loader import CreateDataLoader
from ..eval.metrics import FIDEvaluator, layout_miou, segmentation_consistency, vgg_pool_features
from ..models import networks
from ..models.factory import create_model
from ..utils.checkpoint import params_from_jax, restore_params


def _device_batches(loader, device):
    for host_batch in loader:
        yield host_batch, {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()
                           if not isinstance(v, list)}


def eval_box2mask(argv=None):
    opt = parse_cli(BoxToMaskTestOptions, argv)
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    restore_params(opt, model)
    mious, consis = [], []
    n = 0
    for host_batch, batch in _device_batches(loader, model.device):
        merged, _ = model.inference(batch)
        pred = torch.argmax(merged, dim=-1).cpu().numpy()
        gt = host_batch["gt_layout"]
        mious.append(layout_miou(pred, gt, opt.label_nc))
        consis.append(segmentation_consistency(pred, gt, host_batch["boxmask"]))
        n += pred.shape[0]
        if n >= opt.how_many:
            break
    result = {
        "metric": "layout_miou",
        "value": float(np.mean(mious)),
        "segmentation_consistency": float(np.mean(consis)),
        "samples": n,
    }
    print(json.dumps(result))
    return result


def load_vgg(path, vgg: torch.nn.Module) -> None:
    """VGG19 weights from an npz keyed ``params/conv{b}_{c}/{kernel,bias}``
    (HWIO kernels): every parameter present, of its shape."""
    with np.load(path) as data:
        sd = params_from_jax({k: data[k] for k in data.files}, prefix="params/")
    vgg.load_state_dict(sd, strict=True)


def eval_mask2image(argv=None, feature_params_path=None):
    opt = parse_cli(MaskToImageTestOptions, argv)
    loader = CreateDataLoader(opt)
    model = create_model(opt)
    restore_params(opt, model)
    vgg = networks.Vgg19Features()
    vgg.reset_parameters(torch.Generator().manual_seed(0))
    if feature_params_path:
        load_vgg(feature_params_path, vgg)
    vgg.to(model.device).eval()
    fid_eval = FIDEvaluator(vgg_pool_features(vgg), 512)
    n = 0
    for _, batch in _device_batches(loader, model.device):
        fake = model.inference(batch)
        fid_eval.update(real_images=batch["image"], fake_images=fake)
        n += int(fake.shape[0])
        if n >= opt.how_many:
            break
    result = {"metric": "fid_vgg", "value": fid_eval.compute(), "samples": n}
    print(json.dumps(result))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--stage", choices=["box2mask", "mask2image"], required=True)
    p.add_argument("--feature_params", default="")
    ns, rest = p.parse_known_args(argv)
    if ns.stage == "box2mask":
        return eval_box2mask(rest)
    return eval_mask2image(rest, feature_params_path=ns.feature_params or None)


if __name__ == "__main__":
    main()

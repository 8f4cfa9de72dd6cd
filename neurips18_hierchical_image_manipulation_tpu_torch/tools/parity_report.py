"""The parity runbook: one command that converts pix2pixHD reference weights
dropped in a directory, renders the test split with them in the port,
evaluates FID (and layout mIoU) and writes a report.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.parity_report \\
        --weights_dir /path/to/weights --dataroot /path/to/cityscapes \\
        --out parity_report.json [--gpu_ids -1 for the CPU] \\
        [--b2m_name run --b2m_checkpoints_dir ckpts]   # the layout mIoU stage

Counterpart of ``tools/parity_report.py`` in the JAX package: its flags,
its stages and its report's keys. Weight files (pix2pixHD's formats):

  {weights_dir}/latest_net_G.pth   the mask2image generator's state_dict
                                   (``model.{i}.weight`` keys)
  {weights_dir}/vgg19.pth          torchvision VGG19 (``features.{i}.*``):
                                   the FID feature extractor

Layout mIoU evaluates a structure-generator run trained by either package
(``--b2m_name`` / ``--b2m_checkpoints_dir``, through
``cli/evaluate.eval_box2mask``): no ``.pth`` format exists for it.

``--make_standins`` first writes random-weight ``.pth`` files in those
formats (G from ``torch.manual_seed(seed)`` through
``pix2pixhd_format.GlobalGeneratorT``, VGG19 from ``RandomState(seed)`` x
0.05, the JAX tool's draws), so that the whole chain runs where the real
weights are absent and only the numbers wait for them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..cli.evaluate import eval_box2mask
from ..configs.options import MaskToImageTestOptions
from ..data.loader import CreateDataLoader
from ..eval.metrics import FIDEvaluator, vgg_pool_features
from ..models import networks
from ..models.factory import create_model, resolve_device
from ..utils.checkpoint import params_from_jax, state_dicts_from_jax
from .convert_torch_checkpoint import convert_global_generator, read_pth
from .load_vgg_weights import PREFIX as VGG_PREFIX
from .load_vgg_weights import TORCHVISION_CONV_INDICES, convert_vgg19_state_dict
from .pix2pixhd_format import GlobalGeneratorT

# VGG19 conv (in, out) channels per (block, conv), torchvision order
_VGG19_CHANNELS = {
    (1, 1): (3, 64), (1, 2): (64, 64),
    (2, 1): (64, 128), (2, 2): (128, 128),
    (3, 1): (128, 256), (3, 2): (256, 256), (3, 3): (256, 256), (3, 4): (256, 256),
    (4, 1): (256, 512), (4, 2): (512, 512), (4, 3): (512, 512), (4, 4): (512, 512),
    (5, 1): (512, 512), (5, 2): (512, 512), (5, 3): (512, 512), (5, 4): (512, 512),
}


def make_standins(weights_dir: str, input_nc: int, ngf: int, n_down: int,
                  n_blocks: int, seed: int = 0) -> None:
    """Write random-weight .pth stand-ins in the reference formats."""
    os.makedirs(weights_dir, exist_ok=True)
    torch.manual_seed(seed)
    g = GlobalGeneratorT(input_nc, 3, ngf=ngf, n_down=n_down, n_blocks=n_blocks)
    torch.save(g.state_dict(), os.path.join(weights_dir, "latest_net_G.pth"))

    rng = np.random.RandomState(seed)
    vgg_sd = {}
    for (b, c), idx in TORCHVISION_CONV_INDICES.items():
        ci, co = _VGG19_CHANNELS[(b, c)]
        vgg_sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(co, ci, 3, 3) * 0.05).astype(np.float32))
        vgg_sd[f"features.{idx}.bias"] = torch.zeros(co)
    torch.save(vgg_sd, os.path.join(weights_dir, "vgg19.pth"))
    print(f"stand-ins written to {weights_dir}")


def run_report(args) -> dict:
    report = {"weights_dir": args.weights_dir, "stages": {}}

    # 1. convert the reference mask2image generator
    g_pth = os.path.join(args.weights_dir, "latest_net_G.pth")
    g_flat = convert_global_generator(read_pth(g_pth), n_down=args.n_down,
                                      n_blocks=args.n_blocks)
    report["stages"]["convert_G"] = {"pth": g_pth, "arrays": len(g_flat)}

    # 2. convert VGG19 (the FID features)
    vgg_pth = os.path.join(args.weights_dir, "vgg19.pth")
    vgg_flat = None
    if os.path.exists(vgg_pth):
        vgg_flat = convert_vgg19_state_dict(read_pth(vgg_pth))
        report["stages"]["convert_VGG"] = {"pth": vgg_pth, "arrays": len(vgg_flat)}
    else:
        report["stages"]["convert_VGG"] = {
            "pth": None,
            "note": "vgg19.pth absent - FID uses random-init VGG features "
            "(NOT paper-comparable)",
        }

    # 3. render the split with the converted G; FID
    opt = MaskToImageTestOptions(
        name="parity_m2i",
        checkpoints_dir=os.path.join(args.weights_dir, ".parity_ckpt"),
        dataroot=args.dataroot, label_nc=args.label_nc, ngf=args.ngf,
        n_downsample_global=args.n_down, n_blocks_global=args.n_blocks,
        fineSize=args.fineSize, loadSize=args.loadSize, resize_or_crop=args.resize_or_crop,
        phase=args.phase, no_instance=args.no_instance,
        # a label2city pix2pixHD checkpoint has no masked-RGB channels;
        # --use_masked_image opts into the editing variant (+3 channels)
        use_masked_image=args.use_masked_image, gpu_ids=args.gpu_ids,
    )
    model = create_model(opt)
    model.netG.load_state_dict(state_dicts_from_jax(g_flat)["G"], strict=True)
    loader = CreateDataLoader(opt)
    vgg = networks.Vgg19Features()
    vgg.reset_parameters(torch.Generator().manual_seed(1))
    if vgg_flat is not None:
        vgg.load_state_dict(params_from_jax(vgg_flat, prefix=VGG_PREFIX), strict=True)
    vgg.to(model.device).eval()
    fid_eval = FIDEvaluator(vgg_pool_features(vgg), 512)
    n = 0
    for host_batch in loader:
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in host_batch.items()
                 if not isinstance(v, list)}
        fake = model.inference(batch)
        fid_eval.update(real_images=batch["image"], fake_images=fake)
        n += int(fake.shape[0])
        if n >= args.how_many:
            break
    report["stages"]["fid"] = {
        "value": float(fid_eval.compute()),
        "samples": n,
        "features": "vgg19-pretrained" if vgg_flat is not None else "vgg19-random",
    }

    # 4. the structure generator's layout mIoU (a run of either package)
    if args.b2m_name:
        argv = ["--name", args.b2m_name, "--checkpoints_dir", args.b2m_checkpoints_dir,
                "--dataroot", args.dataroot, "--phase", args.phase,
                "--how_many", str(args.how_many), "--gpu_ids", args.gpu_ids,
                ] + (args.b2m_args.split() if args.b2m_args else [])
        report["stages"]["layout_miou"] = eval_box2mask(argv)
    else:
        report["stages"]["layout_miou"] = {
            "note": "no --b2m_name given - train cli/box2mask_train and "
            "pass the run name for the mIoU stage"
        }
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights_dir", required=True)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--out", default="parity_report.json")
    p.add_argument("--label_nc", type=int, default=35)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--n_down", type=int, default=4)
    p.add_argument("--n_blocks", type=int, default=9)
    p.add_argument("--fineSize", type=int, default=512)
    p.add_argument("--loadSize", type=int, default=1024)
    p.add_argument("--resize_or_crop", default="scale_width")
    p.add_argument("--phase", default="test")
    p.add_argument("--no_instance", action="store_true")
    p.add_argument("--use_masked_image", action="store_true")
    p.add_argument("--how_many", type=int, default=500)
    p.add_argument("--b2m_name", default="")
    p.add_argument("--b2m_checkpoints_dir", default="./checkpoints")
    p.add_argument("--b2m_args", default="")
    p.add_argument("--make_standins", action="store_true")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    resolve_device(args)   # no card and no --gpu_ids -1: raise before any work

    if args.make_standins:
        # the stand-in G takes the model's input channels: the one-hot, the
        # instance edge unless --no_instance, the masked RGB under
        # --use_masked_image
        input_nc = (args.label_nc + (0 if args.no_instance else 1)
                    + (3 if args.use_masked_image else 0))
        make_standins(args.weights_dir, input_nc, args.ngf, args.n_down, args.n_blocks)

    report = run_report(args)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

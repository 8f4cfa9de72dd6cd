"""mask2image model — PyTorch counterpart of ``models/pix2pixhd.py`` in the
JAX package, serving half: ``generator_input_nc``, ``encode_input`` and
``inference``. The training half (D, VGG, losses) waits for a later slice.

The generator is conditioned on the label one-hot, the instance edge
plane and the box-masked RGB (the fork's change to pix2pixHD), all built
in one pass by the encode kernel (``kernels/encode.py``):

  * instance norm, ``n_downsampling >= 1`` and even H, W (the JAX
    package's stem-pack conditions): the kernel emits the input already
    reflect-padded by 3 and wraps it in ``PaddedStemInput``, so the stem
    conv pads nothing itself;
  * otherwise (``--norm batch``, odd sizes): the unpadded tensor.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels import encode as kenc
from ..ops.nnops import PaddedStemInput
from . import networks

# batch keys that hold pixel coordinates: never a dtype witness (the JAX
# package keeps boxes fp32 under its bf16 policy, train/steps._COORD_KEYS)
_COORD_KEYS = frozenset({"boxes"})


class Pix2PixHDModel:
    def __init__(self, opt, device: torch.device):
        if getattr(opt, "instance_feat", False) or getattr(opt, "label_feat", False):
            raise NotImplementedError(
                "--instance_feat / --label_feat (the feature encoder) is not ported yet"
            )
        self.opt = opt
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(int(opt.seed))
        self.netG = networks.define_G(opt, self.generator_input_nc(), gen)
        self.netG.to(self.device).eval()

    def generator_input_nc(self) -> int:
        nc = self.opt.label_nc
        if not self.opt.no_instance:
            nc += 1
        if getattr(self.opt, "use_masked_image", False):
            nc += 3
        return nc

    def _padded_stem(self, h: int, w: int) -> bool:
        g = self.netG
        return g.norm == "instance" and g.n_downsampling >= 1 and h % 2 == 0 and w % 2 == 0

    def encode_input(self, batch: Dict[str, torch.Tensor]):
        """batch: label (B,H,W) int ids; inst (B,H,W) int; image (B,H,W,3)
        in [-1,1] float, or raw uint8 (--uint8_transfer), normalized here
        in the dtype the batch or the generator computes in; boxes (B,4).
        Returns the generator input: a NHWC tensor or a PaddedStemInput."""
        batch = dict(batch)
        img = batch.get("image")
        if img is not None and img.dtype == torch.uint8:
            dt = next(
                (
                    v.dtype
                    for k, v in batch.items()
                    if k not in _COORD_KEYS
                    and torch.is_tensor(v)
                    and v.is_floating_point()
                ),
                next(self.netG.parameters()).dtype,
            )
            batch["image"] = img.to(dt) / 127.5 - 1.0
        dt = batch["image"].dtype if "image" in batch else torch.float32
        label = batch["label"].to(torch.int32).contiguous()
        inst = None if self.opt.no_instance else batch["inst"].to(torch.int32).contiguous()
        image = boxes = None
        if getattr(self.opt, "use_masked_image", False):
            image = batch["image"].contiguous()
            boxes = batch["boxes"].to(torch.float32).contiguous()
        h, w = label.shape[1:3]
        if self._padded_stem(h, w):
            return PaddedStemInput(
                kenc.encode(label, inst, image, boxes, self.opt.label_nc, pad=3, dtype=dt)
            )
        return kenc.encode(label, inst, image, boxes, self.opt.label_nc, pad=0, dtype=dt)

    @torch.inference_mode()
    def inference(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,H,W,3) NHWC generator output in [-1, 1]."""
        return self.netG(self.encode_input(batch))

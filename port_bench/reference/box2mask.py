"""The structure generator of Hong et al., NeurIPS 2018 §3.1 (box2mask), in
plain PyTorch, written from the paper's description as its training
options set it:

* G, two streams over one encoder: the layout one-hot with the box's
  interior zeroed and the box mask, reflect-pad 3, 7x7 conv to ngf, IN,
  ReLU; n_down stride-2 3x3 convs, IN, ReLU (each input kept as a skip).
  At the bottleneck the class one-hot, masked by the box mask max-pooled
  onto it, joins through a 1x1 conv and IN, then a bias-free linear
  embedding of the class is added before the ReLU; n_blocks resnet blocks.
  Two decoders (layout logits over label_nc; one object-mask logit), each
  n_down transposed convs, IN, ReLU, plus the mirrored skip, then
  reflect-pad 3 and a 7x7 conv. merged = softmax(layout) outside the
  object mask sigmoid(mask) * box, the class one-hot inside it.
* D, one PatchGAN over the layout, the class one-hot tiled and the box
  mask, no intermediate features.
* The objective: lambda_recon * the layout's per-pixel cross-entropy
  weighted by 1 - the object mask, lambda_recon * the object logit's BCE
  inside the box (each a ratio of sums over the batch), LSGAN on merged;
  D's loss 0.5 (real one-hot + fake merged held fixed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import flops
from .layers import Conv, ConvT, PatchD, ResBlock, inorm, onehot

MODEL = "box2mask"
METRICS = ("G_GAN", "G_recon", "G_obj", "D_real", "D_fake")


class TwoStreamG(nn.Module):
    def __init__(self, nc=35, ngf=64, n_down=3, n_blocks=4):
        super().__init__()
        self.n_down, self.n_blocks = n_down, n_blocks
        self.enc_in = Conv(nc + 1, ngf, 7, reflect=3, bias=False)
        for i in range(n_down):
            setattr(self, f"enc_down{i}", Conv(ngf * 2**i, ngf * 2 ** (i + 1), 3, 2, 1,
                                               bias=False))
        ch = ngf * 2**n_down
        self.cls_fuse = Conv(ch + nc, ch, 1, bias=False)
        self.cls_embed = nn.Linear(nc, ch, bias=False)
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResBlock(ch))
        for tag, cout in (("ctx", nc), ("obj", 1)):
            for i in range(n_down):
                c = ngf * 2 ** (n_down - i)
                setattr(self, f"{tag}_up{i}", ConvT(c, c // 2, bias=False))
            setattr(self, f"{tag}_out", Conv(ngf, cout, 7, reflect=3))

    def forward(self, masked_oh, boxmask, cls_oh):
        h = F.relu(inorm(self.enc_in(torch.cat([masked_oh, boxmask], 1))))
        skips = []
        for i in range(self.n_down):
            skips.append(h)
            h = F.relu(inorm(getattr(self, f"enc_down{i}")(h)))
        f = boxmask.shape[2] // h.shape[2]
        bm = F.max_pool2d(boxmask, f, f)
        h = inorm(self.cls_fuse(torch.cat([h, cls_oh[:, :, None, None] * bm], 1)))
        h = F.relu(h + self.cls_embed(cls_oh)[:, :, None, None])
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)

        def decode(tag, h):
            for i in range(self.n_down):
                h = F.relu(inorm(getattr(self, f"{tag}_up{i}")(h))) + skips[self.n_down - 1 - i]
            return getattr(self, f"{tag}_out")(h)

        layout, mask = decode("ctx", h), decode("obj", h)
        obj = torch.clamp(torch.sigmoid(mask) * boxmask, 0.0, 1.0)
        merged = torch.softmax(layout, 1) * (1.0 - obj) + cls_oh[:, :, None, None] * obj
        return layout, mask, merged


class LayoutD(nn.Module):
    def __init__(self, nc=35, ndf=64, n_layers=3):
        super().__init__()
        self.d = PatchD(2 * nc + 1, ndf, n_layers)

    def forward(self, layout, boxmask, cls_oh):
        cls = cls_oh[:, :, None, None].expand(-1, -1, *layout.shape[2:])
        return self.d(torch.cat([layout, cls, boxmask], 1))[-1]


class BoxToMask:
    G_NETS = ("G",)

    def __init__(self, cfg, train: bool = True):
        self.cfg = cfg
        self.nets = {"G": TwoStreamG(cfg["label_nc"], cfg["ngf"], cfg["n_downsample_global"],
                                     cfg["n_blocks_global"])}
        if train:
            self.nets["D"] = LayoutD(cfg["label_nc"], cfg["ndf"], cfg["n_layers_D"])

    def inputs(self, b):
        nc = self.cfg["label_nc"]
        box = b["boxmask"].float().permute(0, 3, 1, 2)
        return onehot(b["label"], nc) * (1.0 - box), box, onehot(b["cls"], nc)

    @staticmethod
    def full(b):
        """The batch's rows and the sums the two ratio-of-sums losses
        divide by."""
        return {"n": b["label"].shape[0],
                "w_recon": float((1.0 - b["objmask"].float()).sum().clamp_min(1.0)),
                "w_obj": float(b["boxmask"].float().sum().clamp_min(1.0))}

    def block_losses(self, b, full):
        cfg, G, D = self.cfg, self.nets["G"], self.nets["D"]
        share = b["label"].shape[0] / full["n"]
        masked, box, cls = self.inputs(b)
        layout, mask, merged = G(masked, box, cls)
        obj_gt = b["objmask"].float().permute(0, 3, 1, 2)
        nll = F.cross_entropy(layout, b["label"].long(), reduction="none")
        recon = cfg["lambda_recon"] * (nll * (1.0 - obj_gt[:, 0])).sum() / full["w_recon"]
        bce = F.binary_cross_entropy_with_logits(mask, obj_gt, reduction="none")
        obj = cfg["lambda_recon"] * (bce * box).sum() / full["w_obj"]
        d_params = list(D.parameters())
        for p in d_params:
            p.requires_grad_(False)
        pred = D(merged, box, cls)
        for p in d_params:
            p.requires_grad_(True)
        g_gan = F.mse_loss(pred, torch.ones_like(pred)) * share
        gt = onehot(b["label"], cfg["label_nc"])
        p_real, p_fake = D(gt, box, cls), D(merged.detach(), box, cls)
        d_real = F.mse_loss(p_real, torch.ones_like(p_real)) * share
        d_fake = F.mse_loss(p_fake, torch.zeros_like(p_fake)) * share
        metrics = {"G_GAN": g_gan, "G_recon": recon, "G_obj": obj, "D_real": d_real,
                   "D_fake": d_fake}
        return g_gan + recon + obj, 0.5 * (d_real + d_fake), metrics


# ---- what the harness asks of a model (reference/registry.py)

Reference = BoxToMask


def g_layers(cfg, h, w):
    """The two-stream G's layers and IN sites on h x w (flops.train_step)."""
    nc, ngf, nd, nb = cfg["label_nc"], cfg["ngf"], cfg["n_downsample_global"], cfg["n_blocks_global"]
    conv, convt = flops.conv, flops.convt
    layers = [(conv(1, h, w, nc + 1, ngf, 7), False)]
    sites = [(h * w * ngf, ngf, False)]
    c, hh, ww = ngf, h, w
    for _ in range(nd):
        hh, ww = hh // 2, ww // 2
        layers.append((conv(1, hh, ww, c, 2 * c, 3), True))
        c *= 2
        sites.append((hh * ww * c, c, False))
    layers.append((conv(1, hh, ww, c + nc, c, 1), True))
    sites.append((hh * ww * c, c, False))
    for _ in range(nb):
        layers += [(conv(1, hh, ww, c, c, 3), True)] * 2
        sites += [(hh * ww * c, c, False), (hh * ww * c, c, True)]
    for cout in (nc, 1):
        cc, h2, w2 = c, hh, ww
        for _ in range(nd):
            layers.append((convt(1, h2, w2, cc, cc // 2), True))
            h2, w2, cc = h2 * 2, w2 * 2, cc // 2
            sites.append((h2 * w2 * cc, cc, False))
        layers.append((conv(1, h, w, ngf, cout, 7), True))
    return layers, sites


def d_input(cfg):
    """LayoutD, one PatchGAN: (the layout, the class tiled and the box mask;
    the conditioning, the class and the box mask; one scale)."""
    return 2 * cfg["label_nc"] + 1, cfg["label_nc"] + 1, 1


def vgg_taps(cfg, h, w):
    return 0.0


def linear(cfg, n):
    """The class embedding, forward and weight gradient."""
    return 2 * 2.0 * n * cfg["label_nc"] * cfg["ngf"] * 2 ** cfg["n_downsample_global"]

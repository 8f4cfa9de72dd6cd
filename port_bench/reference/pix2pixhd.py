"""pix2pixHD conditioned on the box-masked RGB (Wang et al., CVPR 2018;
Hong et al., NeurIPS 2018), in plain PyTorch: the mask2image stage.

* G, the GlobalGenerator: reflect-pad 3, 7x7 conv to ngf, IN, ReLU; n_down
  stride-2 3x3 convs doubling the channels, IN, ReLU; n_blocks resnet
  blocks; n_down transposed 3x3 convs halving them, IN, ReLU; reflect-pad
  3, 7x7 conv to RGB, tanh. Its input: the label one-hot, the instance
  edges and the RGB with the box's interior set to 0.
* D: num_D PatchGANs over the conditioning (one-hot, edges) and an image,
  the input average-pooled (3, 2, 1, not counting the pad) between scales.
* VGG19, frozen, tapped at relu1_1 .. relu5_1.
* The objective: LSGAN; feature matching over D's layers but the logits,
  weighted 4 / (n_layers_D + 1) / num_D * lambda_feat, D's features of the
  real image held fixed; VGG L1 weighted (1/32, 1/16, 1/8, 1/4, 1) *
  lambda_feat; D's loss 0.5 (real + fake) on the fake held fixed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import flops
from .layers import Conv, ConvT, PatchD, ResBlock, edges, inorm, onehot

MODEL = "pix2pixHD"
VGG_CFG = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
METRICS = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")


class GlobalGenerator(nn.Module):
    def __init__(self, cin, ngf=64, n_down=4, n_blocks=9, cout=3):
        super().__init__()
        self.n_down, self.n_blocks = n_down, n_blocks
        self.conv_in = Conv(cin, ngf, 7, reflect=3, bias=False)
        for i in range(n_down):
            setattr(self, f"down{i}", Conv(ngf * 2**i, ngf * 2 ** (i + 1), 3, 2, 1, bias=False))
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResBlock(ngf * 2**n_down))
        for i in range(n_down):
            c = ngf * 2 ** (n_down - i)
            setattr(self, f"up{i}", ConvT(c, c // 2, bias=False))
        self.conv_out = Conv(ngf, cout, 7, reflect=3)

    def forward(self, x):
        h = F.relu(inorm(self.conv_in(x)))
        for i in range(self.n_down):
            h = F.relu(inorm(getattr(self, f"down{i}")(h)))
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(self.n_down):
            h = F.relu(inorm(getattr(self, f"up{i}")(h)))
        return torch.tanh(self.conv_out(h))


class MultiscaleD(nn.Module):
    def __init__(self, cin, ndf=64, n_layers=3, num_D=2):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"scale{i}", PatchD(cin, ndf, n_layers))

    def forward(self, x):
        out = []
        for i in range(self.num_D):
            out.append(getattr(self, f"scale{i}")(x))
            if i != self.num_D - 1:
                x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return out


class VGG19(nn.Module):
    """VGG19's 16 convolutions (all kept as parameters); the taps need the
    first 13 and the pools between the blocks."""

    def __init__(self):
        super().__init__()
        cin = 3
        for b, widths in enumerate(VGG_CFG):
            for c, width in enumerate(widths):
                setattr(self, f"conv{b + 1}_{c + 1}", Conv(cin, width, 3, padding=1))
                cin = width

    def forward(self, x):
        taps, h = [], x
        for b, widths in enumerate(VGG_CFG):
            if b:
                h = F.max_pool2d(h, 2, 2)
            for c in range(1 if b == len(VGG_CFG) - 1 else len(widths)):
                h = F.relu(getattr(self, f"conv{b + 1}_{c + 1}")(h))
                if c == 0:
                    taps.append(h)
        return taps


class Pix2PixHD:
    """The mask2image stage: ``nets`` (G, D, VGG) and the objective over a
    block of a batch's rows."""

    G_NETS = ("G",)

    def __init__(self, cfg, train: bool = True):
        self.cfg = cfg
        nc = cfg["label_nc"]
        self.nets = {"G": GlobalGenerator(nc + 1 + 3, cfg["ngf"], cfg["n_downsample_global"],
                                          cfg["n_blocks_global"])}
        if train:
            self.nets["D"] = MultiscaleD(nc + 1 + 3, cfg["ndf"], cfg["n_layers_D"], cfg["num_D"])
            self.nets["VGG"] = VGG19().requires_grad_(False)

    def inputs(self, b):
        """(G input, D conditioning, real image) NCHW from a batch: label,
        inst (B,H,W), image (B,H,W,3) in [-1, 1], boxmask (B,H,W,1)."""
        cond = torch.cat([onehot(b["label"], self.cfg["label_nc"]), edges(b["inst"])], 1)
        real = b["image"].float().permute(0, 3, 1, 2)
        keep = 1.0 - b["boxmask"].float().permute(0, 3, 1, 2)
        return torch.cat([cond, real * keep], 1), cond, real

    def generate(self, b):
        """The served forward: G's (B,H,W,3) output."""
        x, _, _ = self.inputs(b)
        return self.nets["G"](x).permute(0, 2, 3, 1)

    @staticmethod
    def full(b):
        """What a block's terms are normalized by: the batch's rows."""
        return {"n": b["label"].shape[0]}

    def block_losses(self, b, full):
        """-> (G's loss, D's loss, metrics) of the rows of ``b``, each term
        scaled by its share of the full batch's mean."""
        cfg, G, D, V = self.cfg, self.nets["G"], self.nets["D"], self.nets["VGG"]
        share = b["label"].shape[0] / full["n"]
        x, cond, real = self.inputs(b)
        fake = G(x)
        d_params = list(D.parameters())
        for p in d_params:
            p.requires_grad_(False)
        pred_fake = D(torch.cat([cond, fake], 1))
        for p in d_params:
            p.requires_grad_(True)
        with torch.no_grad():
            pred_real_fixed = D(torch.cat([cond, real], 1))
        g_gan = sum(F.mse_loss(s[-1], torch.ones_like(s[-1])) for s in pred_fake)
        w = 4.0 / (cfg["n_layers_D"] + 1) / cfg["num_D"] * cfg["lambda_feat"]
        fm = sum(w * F.l1_loss(f, r) for sf, sr in zip(pred_fake, pred_real_fixed)
                 for f, r in zip(sf[:-1], sr[:-1]))
        with torch.no_grad():
            taps_real = V(real)
        vgg = cfg["lambda_feat"] * sum(wt * F.l1_loss(a, r) for wt, a, r in
                                       zip(VGG_WEIGHTS, V(fake), taps_real))
        pred_real = D(torch.cat([cond, real], 1))
        pred_fake_d = D(torch.cat([cond, fake.detach()], 1))
        d_real = sum(F.mse_loss(s[-1], torch.ones_like(s[-1])) for s in pred_real)
        d_fake = sum(F.mse_loss(s[-1], torch.zeros_like(s[-1])) for s in pred_fake_d)
        metrics = {"G_GAN": g_gan, "G_GAN_Feat": fm, "G_VGG": vgg, "D_real": d_real,
                   "D_fake": d_fake}
        metrics = {k: v * share for k, v in metrics.items()}
        return (metrics["G_GAN"] + metrics["G_GAN_Feat"] + metrics["G_VGG"],
                0.5 * (metrics["D_real"] + metrics["D_fake"]), metrics)


# ---- what the harness asks of a model (reference/registry.py)

Reference = Pix2PixHD


def g_layers(cfg, h, w):
    """The GlobalGenerator's layers and IN sites on h x w (flops.train_step)."""
    return flops._global_g(cfg, h, w)


def d_input(cfg):
    """The multiscale D: (the conditioning and the image; the conditioning,
    one-hot and edges; num_D scales)."""
    return cfg["label_nc"] + 1 + 3, cfg["label_nc"] + 1, cfg["num_D"]


def vgg_taps(cfg, h, w):
    return flops._vgg_taps(h, w)


def linear(cfg, n):
    return 0.0

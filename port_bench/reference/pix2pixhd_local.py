"""pix2pixHD's 1024p generator, the LocalEnhancer, conditioned on the
box-masked RGB (Wang et al., CVPR 2018, ``--netG local``; Hong et al.,
NeurIPS 2018), in plain PyTorch: the mask2image stage at full resolution.

* G, the LocalEnhancer with one enhancer branch (pix2pixHD's
  ``label2city_1024p``: ``--ngf 32``):
  - the trunk (``global``): the GlobalGenerator at ``ngf * 2`` without its
    last reflect-pad, 7x7 conv and tanh, on the input average-pooled once
    (3x3, stride 2, pad 1, the pad not counted);
  - the branch (``local1_*``) on the input itself: reflect-pad 3, 7x7 conv
    to ngf, IN, ReLU; a stride-2 3x3 conv to 2 ngf, IN, ReLU; the trunk's
    output added; n_blocks_local resnet blocks at 2 ngf; a transposed 3x3
    conv to ngf, IN, ReLU;
  - the head: reflect-pad 3, 7x7 conv to RGB, tanh.
* D, VGG19 and the objective: those of ``reference/pix2pixhd.py`` at
  num_D scales (3 in the recipe), so feature matching is weighted
  4 / (n_layers_D + 1) / num_D * lambda_feat.

Departures from pix2pixHD: the convolutions under instance norm apply no
bias (the norm removes it; the parameter is kept, zero), and G's input is
the fork's (label one-hot, instance edges, box-masked RGB: 39 channels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import flops
from .layers import Conv, ConvT, ResBlock, inorm
from .pix2pixhd import (GlobalGenerator, MultiscaleD, Pix2PixHD, VGG19, d_input,  # noqa: F401
                        linear, vgg_taps)

MODEL = "pix2pixHD-local"


class Trunk(GlobalGenerator):
    """The GlobalGenerator without its head: the last up's IN and ReLU out."""

    def __init__(self, cin, ngf, n_down, n_blocks):
        super().__init__(cin, ngf, n_down, n_blocks)
        del self.conv_out

    def forward(self, x):
        h = F.relu(inorm(self.conv_in(x)))
        for i in range(self.n_down):
            h = F.relu(inorm(getattr(self, f"down{i}")(h)))
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(self.n_down):
            h = F.relu(inorm(getattr(self, f"up{i}")(h)))
        return h


class LocalEnhancer(nn.Module):
    def __init__(self, cin, ngf=32, n_down=4, n_blocks=9, n_blocks_local=3, cout=3):
        super().__init__()
        self.n_blocks_local = n_blocks_local
        self.add_module("global", Trunk(cin, 2 * ngf, n_down, n_blocks))
        self.local1_conv_in = Conv(cin, ngf, 7, reflect=3, bias=False)
        self.local1_down = Conv(ngf, 2 * ngf, 3, 2, 1, bias=False)
        for i in range(n_blocks_local):
            setattr(self, f"local1_res{i}", ResBlock(2 * ngf))
        self.local1_up = ConvT(2 * ngf, ngf, bias=False)
        self.conv_out = Conv(ngf, cout, 7, reflect=3)

    def forward(self, x):
        trunk = getattr(self, "global")(F.avg_pool2d(x, 3, 2, 1, count_include_pad=False))
        h = F.relu(inorm(self.local1_conv_in(x)))
        h = F.relu(inorm(self.local1_down(h))) + trunk
        for i in range(self.n_blocks_local):
            h = getattr(self, f"local1_res{i}")(h)
        h = F.relu(inorm(self.local1_up(h)))
        return torch.tanh(self.conv_out(h))


class Pix2PixHDLocal(Pix2PixHD):
    """``Pix2PixHD`` with the LocalEnhancer for G."""

    def __init__(self, cfg, train: bool = True):
        self.cfg = cfg
        cin = cfg["label_nc"] + 1 + 3
        self.nets = {"G": LocalEnhancer(cin, cfg["ngf"], cfg["n_downsample_global"],
                                        cfg["n_blocks_global"], cfg["n_blocks_local"])}
        if train:
            self.nets["D"] = MultiscaleD(cin, cfg["ndf"], cfg["n_layers_D"], cfg["num_D"])
            self.nets["VGG"] = VGG19().requires_grad_(False)


# ---- what the harness asks of a model (reference/registry.py)

Reference = Pix2PixHDLocal


def g_layers(cfg, h, w):
    """The trunk's layers and IN sites on the pooled (h/2, w/2) at 2 ngf,
    its head left out; then the branch's and the head's on h x w. Neither
    first convolution takes a data gradient: each sees the input."""
    ngf, cin = cfg["ngf"], cfg["label_nc"] + 1 + 3
    hh, ww = (h + 1) // 2, (w + 1) // 2
    layers, sites = flops._global_g(dict(cfg, ngf=2 * ngf), hh, ww)
    layers = layers[:-1]
    layers += [(flops.conv(1, h, w, cin, ngf, 7), False),
               (flops.conv(1, hh, ww, ngf, 2 * ngf, 3), True)]
    sites += [(h * w * ngf, ngf, False), (hh * ww * 2 * ngf, 2 * ngf, False)]
    for _ in range(cfg["n_blocks_local"]):
        layers += [(flops.conv(1, hh, ww, 2 * ngf, 2 * ngf, 3), True)] * 2
        sites += [(hh * ww * 2 * ngf, 2 * ngf, False), (hh * ww * 2 * ngf, 2 * ngf, True)]
    layers += [(flops.convt(1, hh, ww, 2 * ngf, ngf), True),
               (flops.conv(1, h, w, ngf, 3, 7), True)]
    sites.append((h * w * ngf, ngf, False))
    return layers, sites

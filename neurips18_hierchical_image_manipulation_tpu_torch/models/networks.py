"""Generator modules — PyTorch counterparts of ``models/networks.py`` in the
JAX package (pix2pixHD GlobalGenerator lineage), NHWC activations.

Module and parameter names follow the JAX param tree (``conv_in``,
``down{i}``, ``res{i}.conv1|conv2``, ``up{i}``, ``conv_out``, and the batch
norm ``norm*`` modules), so ``utils/checkpoint.py`` maps a JAX npz sidecar
onto ``state_dict`` keys one to one.

Init follows the reference's ``weights_init``: conv weights ~ N(0, 0.02),
biases zero, batch-norm weight ~ N(1, 0.02), bias zero, drawn from an
explicit ``torch.Generator`` (the same distribution as the JAX init, not
the same bits).

Dead biases: a conv followed by InstanceNorm(affine=False) keeps its bias
as a parameter (the checkpoint layout is unchanged) but does not apply it
— IN subtracts the per-channel mean, so the bias cannot change the output.
``conv_out``'s bias is live, and under ``--norm batch`` every bias is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import instance_norm as kin
from ..ops import nnops
from ..ops.nnops import PaddedStemInput


class Conv(nn.Module):
    """torch.nn.Conv2d twin on NHWC; ``reflect`` > 0 applies
    ReflectionPad2d(reflect) first (the pix2pixHD pad+conv pairs)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, reflect=0,
                 dead_bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.reflect, self.dead_bias = reflect, dead_bias

    def forward(self, x, padded: bool = False):
        """``padded``: x already carries the reflect pad (PaddedStemInput)."""
        if self.reflect and not padded:
            x = nnops.reflect_pad(x, self.reflect)
        b = None if self.dead_bias else self.bias
        return nnops.conv2d(x, self.weight, b, stride=self.stride, padding=self.padding)


class ConvTranspose(nn.Module):
    """torch.nn.ConvTranspose2d(k3, s2, p1, op1) twin on NHWC."""

    def __init__(self, cin, cout, dead_bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dead_bias = dead_bias

    def forward(self, x):
        b = None if self.dead_bias else self.bias
        return nnops.conv_transpose2d(x, self.weight, b)


def norm_act(x, norm: str = "instance", act: str = "relu",
             residual: Optional[torch.Tensor] = None):
    """Parameterless norm + act: IN goes through the fused kernel wrapper
    (``kernels/instance_norm.py``), which adds ``residual`` before ``act``."""
    if norm == "instance":
        return kin.instance_norm(x, act, residual)[0]
    if norm != "none":
        raise ValueError(f"unsupported norm: {norm}")
    if residual is not None:
        x = x + residual
    return nnops.apply_act(x, act)


class NormAct(nn.Module):
    """``get_norm_layer`` twin: ``instance`` is InstanceNorm2d(affine=False)
    with no parameters; ``batch`` is BatchNorm2d(affine=True) on batch
    statistics (nnops.batch_norm) with ``weight`` and ``bias``; ``none`` is
    the activation only."""

    def __init__(self, channels, norm="instance", act="relu"):
        super().__init__()
        self.norm, self.act = norm, act
        if norm == "batch":
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        elif norm not in ("instance", "none"):
            raise ValueError(f"unsupported norm: {norm}")

    def forward(self, x, residual=None):
        if self.norm == "batch":
            x = nnops.batch_norm(x, self.weight, self.bias)
            return norm_act(x, "none", self.act, residual)
        return norm_act(x, self.norm, self.act, residual)


class ResnetBlock(nn.Module):
    """ReflectPad1 -> Conv3x3 -> norm -> ReLU -> ReflectPad1 -> Conv3x3 ->
    norm, plus the block input. Under IN the add rides in the second IN's
    epilogue. (--use_dropout's Dropout is inactive at inference.)"""

    def __init__(self, dim, norm="instance"):
        super().__init__()
        db = norm == "instance"
        self.conv1 = Conv(dim, dim, 3, reflect=1, dead_bias=db)
        self.norm1 = NormAct(dim, norm, "relu")
        self.conv2 = Conv(dim, dim, 3, reflect=1, dead_bias=db)
        self.norm2 = NormAct(dim, norm, "none")

    def forward(self, x):
        h = self.norm1(self.conv1(x))
        return self.norm2(self.conv2(h), residual=x)


class GlobalGenerator(nn.Module):
    """pix2pixHD GlobalGenerator: c7s1-ngf, n_downsampling stride-2 convs,
    n_blocks resnet blocks, mirrored transposed-conv ups, c7s1-output_nc +
    tanh. Input NHWC (B,H,W,input_nc) or a ``PaddedStemInput``; output
    NHWC (B,H,W,output_nc) in [-1, 1]."""

    def __init__(self, input_nc, output_nc=3, ngf=64, n_downsampling=4,
                 n_blocks=9, norm="instance"):
        super().__init__()
        self.norm, self.n_downsampling, self.n_blocks = norm, n_downsampling, n_blocks
        db = norm == "instance"
        self.conv_in = Conv(input_nc, ngf, 7, reflect=3, dead_bias=db)
        self.norm_in = NormAct(ngf, norm, "relu")
        for i in range(n_downsampling):
            cin, cout = ngf * 2**i, ngf * 2 ** (i + 1)
            self.add_module(f"down{i}", Conv(cin, cout, 3, 2, 1, dead_bias=db))
            self.add_module(f"norm_down{i}", NormAct(cout, norm, "relu"))
        dim = ngf * 2**n_downsampling
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(dim, norm))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            cout = ngf * mult // 2
            self.add_module(f"up{i}", ConvTranspose(ngf * mult, cout, dead_bias=db))
            self.add_module(f"norm_up{i}", NormAct(cout, norm, "relu"))
        self.conv_out = Conv(ngf, output_nc, 7, reflect=3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Reference ``weights_init`` from ``generator``, in registration
        order: conv weights ~ N(0, 0.02), batch-norm weights ~ N(1, 0.02),
        biases zero."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, ConvTranspose)):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, NormAct) and m.norm == "batch":
                    m.weight.normal_(1.0, 0.02, generator=generator)
                    m.bias.zero_()

    def forward(self, x):
        if isinstance(x, PaddedStemInput):
            h = self.conv_in(x.padded, padded=True)
        else:
            h = self.conv_in(x)
        h = self.norm_in(h)
        for i in range(self.n_downsampling):
            h = getattr(self, f"norm_down{i}")(getattr(self, f"down{i}")(h))
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in range(self.n_downsampling):
            h = getattr(self, f"norm_up{i}")(getattr(self, f"up{i}")(h))
        return torch.tanh(self.conv_out(h))


def define_G(opt, input_nc: int, generator: torch.Generator) -> GlobalGenerator:
    """``define_G`` for ``--netG global`` (the other generators wait for
    later slices), initialized from ``generator``."""
    if opt.netG != "global":
        raise NotImplementedError(f"--netG {opt.netG} is not ported yet")
    g = GlobalGenerator(
        input_nc,
        output_nc=opt.output_nc,
        ngf=opt.ngf,
        n_downsampling=opt.n_downsample_global,
        n_blocks=opt.n_blocks_global,
        norm=opt.norm,
    )
    g.reset_parameters(generator)
    return g

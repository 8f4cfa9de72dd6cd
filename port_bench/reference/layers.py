"""Plain PyTorch layers of the reference, NCHW, float32.

Parameters carry the names of the published layer lists as the port's
checkpoints spell them (``conv_in``, ``down{i}``, ``res{i}.conv1``, ...), so
that one set of weights made from the seed loads into both sides. A
convolution followed by instance norm applies no bias: the norm subtracts
every channel's mean, so the bias cannot change the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .precision import operand


class Conv(nn.Module):
    """k x k convolution (OIHW weight), with a reflect pad of ``reflect``
    first or a zero pad of ``padding``; ``bias`` False: the bias is kept as
    a parameter but not applied (a convolution under instance norm)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, reflect=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.reflect, self.use_bias = stride, padding, reflect, bias

    def forward(self, x):
        if self.reflect:
            x = F.pad(x, (self.reflect,) * 4, mode="reflect")
        return operand(F.conv2d(operand(x), operand(self.weight),
                                self.bias if self.use_bias else None, self.stride, self.padding))


class ConvT(nn.Module):
    """ConvTranspose2d(k 3, stride 2, pad 1, output pad 1), IOHW weight."""

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.use_bias = bias

    def forward(self, x):
        return operand(F.conv_transpose2d(operand(x), operand(self.weight),
                                          self.bias if self.use_bias else None, 2, 1, 1))


def inorm(x):
    """InstanceNorm2d(affine=False, eps 1e-5): biased variance over (H, W)."""
    return F.instance_norm(x, eps=1e-5)


def onehot(ids, n):
    """(B,H,W) or (B,) int ids -> one-hot on a new channel axis 1 (B,n,...);
    ids outside [0, n) give zeros."""
    ar = torch.arange(n, device=ids.device).view((1, n) + (1,) * (ids.dim() - 1))
    return (ids.long().unsqueeze(1) == ar).float()


def edges(inst):
    """(B,H,W) ids -> (B,1,H,W): 1 where any 4-neighbour's id differs."""
    e = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    dw = inst[:, :, 1:] != inst[:, :, :-1]
    dh = inst[:, 1:, :] != inst[:, :-1, :]
    e[:, :, 1:] |= dw
    e[:, :, :-1] |= dw
    e[:, 1:, :] |= dh
    e[:, :-1, :] |= dh
    return e.float().unsqueeze(1)


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, reflect=1, bias=False)
        self.conv2 = Conv(dim, dim, 3, reflect=1, bias=False)

    def forward(self, x):
        return x + inorm(self.conv2(F.relu(inorm(self.conv1(x)))))


class PatchD(nn.Module):
    """PatchGAN: 4x4 convs padded 2 with zeros, n_layers stride-2 ones
    (channels doubling to 512), one stride-1, a 1-channel logit; LReLU 0.2,
    IN on all but the first and the last. -> the features of every layer,
    logits last."""

    def __init__(self, cin, ndf=64, n_layers=3):
        super().__init__()
        self.n_layers = n_layers
        self.layer0 = Conv(cin, ndf, 4, 2, 2)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"layer{n}", Conv(prev, nf, 4, 2, 2, bias=False))
        prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"layer{n_layers}", Conv(prev, nf, 4, 1, 2, bias=False))
        setattr(self, f"layer{n_layers + 1}", Conv(nf, 1, 4, 1, 2))

    def forward(self, x):
        h = F.leaky_relu(self.layer0(x), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(inorm(getattr(self, f"layer{n}")(h)), 0.2)
            feats.append(h)
        feats.append(getattr(self, f"layer{self.n_layers + 1}")(h))
        return feats

"""pix2pixHD's own module layout, in plain PyTorch: the format of the
original ``{epoch}_net_G.pth`` / ``{epoch}_net_D.pth`` state dicts.

``GlobalGeneratorT`` is one ``nn.Sequential`` (``model.{i}`` keys):
[pad, conv7, IN, ReLU] + n_down x [conv, IN, ReLU] + n_blocks x
[ResnetBlock] + n_down x [convT, IN, ReLU] + [pad, conv7, tanh], each
resblock an inner Sequential ([pad, conv, IN, ReLU, pad, conv, IN]).
``NLayerDiscriminatorT`` is the PatchGAN with intermediate features, one
Sequential a stage. The submodules are built in the order of the JAX
package's test oracle (``tests/torch_oracle.py``), so ``torch.manual_seed``
gives the same initial tensors; the resblock's inner Sequential is named
``block`` there, ``conv_block`` in pix2pixHD itself (the converter reads
either).

These modules run the reference computation (cuDNN convolutions,
``nn.InstanceNorm2d``) against which a converted checkpoint's forward in
the port is held. ``global_generator_state_dict`` and
``multiscale_discriminator_state_dict`` are the inverse of
``convert_torch_checkpoint``: the port's G / D parameters as a pix2pixHD
state dict. A pix2pixHD tensor and the port's are the same array (torch
layouts both: OIHW convolutions, IOHW transposed convolutions), so only
the keys change.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

# the three spellings of a multiscale discriminator's layer keys
D_SPELLINGS = ("scale{i}_layer{n}", "layer{i}.model{n}", "discriminator_{i}.model{n}")


def IN(ch):
    return nn.InstanceNorm2d(ch, affine=False, eps=1e-5, track_running_stats=False)


class ResnetBlockT(nn.Module):
    def __init__(self, dim, norm=IN):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), norm(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), norm(dim),
        )

    def forward(self, x):
        return x + self.block(x)


class GlobalGeneratorT(nn.Module):
    def __init__(self, input_nc, output_nc, ngf=64, n_down=4, n_blocks=9, norm=IN):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7), norm(ngf), nn.ReLU(True)]
        for i in range(n_down):
            cin, cout = ngf * 2**i, ngf * 2 ** (i + 1)
            layers += [nn.Conv2d(cin, cout, 3, stride=2, padding=1), norm(cout), nn.ReLU(True)]
        for _ in range(n_blocks):
            layers += [ResnetBlockT(ngf * 2**n_down, norm)]
        for i in range(n_down):
            cin = ngf * 2 ** (n_down - i)
            cout = cin // 2
            layers += [
                nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1),
                norm(cout), nn.ReLU(True),
            ]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class NLayerDiscriminatorT(nn.Module):
    def __init__(self, input_nc, ndf=64, n_layers=3, norm=IN):
        super().__init__()
        padw = 2
        self.stages = nn.ModuleList()
        self.stages.append(nn.Sequential(
            nn.Conv2d(input_nc, ndf, 4, stride=2, padding=padw), nn.LeakyReLU(0.2, True)))
        nf = ndf
        for _ in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.stages.append(nn.Sequential(
                nn.Conv2d(nf_prev, nf, 4, stride=2, padding=padw), norm(nf),
                nn.LeakyReLU(0.2, True)))
        nf_prev, nf = nf, min(nf * 2, 512)
        self.stages.append(nn.Sequential(
            nn.Conv2d(nf_prev, nf, 4, stride=1, padding=padw), norm(nf), nn.LeakyReLU(0.2, True)))
        self.stages.append(nn.Sequential(nn.Conv2d(nf, 1, 4, stride=1, padding=padw)))

    def forward(self, x):
        feats = []
        h = x
        for stage in self.stages:
            h = stage(h)
            feats.append(h)
        return feats


def global_generator_index_map(n_down: int, n_blocks: int):
    """Sequential indices of the param-bearing layers of pix2pixHD's
    GlobalGenerator: [pad, conv7, IN, ReLU] + n_down x [conv, IN, ReLU] +
    n_blocks x [ResnetBlock] + n_down x [convT, IN, ReLU] + [pad, conv7,
    tanh]."""
    idx = {"conv_in": 1}
    i = 4
    for d in range(n_down):
        idx[f"down{d}"] = i
        i += 3
    for r in range(n_blocks):
        idx[f"res{r}"] = i
        i += 1
    for u in range(n_down):
        idx[f"up{u}"] = i
        i += 3
    idx["conv_out"] = i + 1  # +1 skips the ReflectionPad
    return idx


def global_generator_state_dict(g_sd: Dict[str, torch.Tensor], n_down: int, n_blocks: int,
                                inner: str = "conv_block",
                                prefix: str = "model") -> Dict[str, torch.Tensor]:
    """The port's GlobalGenerator ``state_dict`` (``conv_in``, ``down{i}``,
    ``res{r}.conv{1,2}``, ``up{i}``, ``conv_out``) -> pix2pixHD's
    ``model.{i}`` keys (``inner``: the resblock Sequential's name)."""
    idx = global_generator_index_map(n_down, n_blocks)
    names = {f"res{r}.conv{c}": f"{prefix}.{idx[f'res{r}']}.{inner}.{4 * c - 3}"
             for r in range(n_blocks) for c in (1, 2)}
    names.update({k: f"{prefix}.{i}" for k, i in idx.items() if not k.startswith("res")})
    out = {}
    for key, t in g_sd.items():
        module, leaf = key.rsplit(".", 1)
        out[f"{names[module]}.{leaf}"] = t.detach().clone()
    return out


def multiscale_discriminator_state_dict(d_sd: Dict[str, torch.Tensor], num_D: int,
                                        n_layers: int,
                                        spelling: str = D_SPELLINGS[0]) -> Dict[str, torch.Tensor]:
    """The port's MultiscaleDiscriminator ``state_dict`` (``scale{i}.layer{n}``,
    finest scale first) -> pix2pixHD's keys in one of ``D_SPELLINGS``, whose
    scale attribute 0 is the coarsest."""
    out = {}
    for i in range(num_D):
        for n in range(n_layers + 2):
            key = spelling.format(i=num_D - 1 - i, n=n)
            for leaf in ("weight", "bias"):
                out[f"{key}.0.{leaf}"] = d_sd[f"scale{i}.layer{n}.{leaf}"].detach().clone()
    return out

"""The reference-equivalent pix2pixHD train step in plain PyTorch, measured
on one CUDA card.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.bench_torch_oracle \\
        [--iters 10] [--out FILE]

Counterpart of ``tools/bench_torch_oracle.py`` in the JAX package, which
timed this step on a CPU and scaled it to an estimate for an A100. Here it
runs on the card itself: the step a pix2pixHD user trains, with nothing of
the port's networks or kernels in it:

  * ``tools/pix2pixhd_format``'s ``GlobalGeneratorT`` and
    ``NLayerDiscriminatorT`` (``nn.InstanceNorm2d``, ``nn.ReflectionPad2d``,
    plain NCHW), num_D of them on an ``AvgPool2d(3, 2, 1,
    count_include_pad=False)`` pyramid;
  * ``Vgg19T``: VGG19's feature layers as plain ``nn.Conv2d``, tapped at
    relu1_1 .. relu5_1 (pix2pixHD's ``Vgg19`` slices);
  * ``F.mse_loss`` / ``F.l1_loss`` with pix2pixHD's weights (LSGAN, feature
    matching 4/(n_layers_D+1) * 1/num_D * lambda_feat, VGG (1/32 .. 1) *
    lambda_feat);
  * ``Adam(2e-4, (0.5, 0.999))`` on G and on D; G's loss backward, G's
    step, D's gradients zeroed, D's loss backward, D's step (pix2pixHD's
    order: both gradients at the same parameters).

The input is built by plain torch (one-hot, pix2pixHD's instance edges,
the box-masked RGB). The port's kernel wrappers' launch counters are read
before and after, and the tool raises if any moved.

It reports images/s at bs 1 and 4 at 512x256 in fp32 under PyTorch's
defaults (``tf32_default``: TF32 convolutions on, TF32 matmuls off) and
with TF32 off (``tf32_off``, the port's fp32 parity tier), each by
``train/profiler.measure_steps`` after a warm-up step, with the peak
memory; ``model_tflop_per_img_512x256`` is the JAX tool's analytic model
FLOPs (``model_flops_per_image``, this module's own copy). JSON to
``--out`` (default under ``reports/torch_r13/``), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.synthetic import synthetic_batch
from ..kernels.calls import read_launches
from ..train.profiler import measure_steps
from . import pix2pixhd_format as p2p
from . import roofline_step as rs

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
VGG_CFG = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)
TIERS = {"tf32_default": True, "tf32_off": False}   # cudnn.allow_tf32 of each


class Vgg19T(nn.Module):
    """torchvision's VGG19 ``features[:30]`` as plain layers, tapped after
    relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1 (pix2pixHD's slices
    [0:2], [2:7], [7:12], [12:21], [21:30]); ``index`` maps the port's
    ``conv{b}_{c}`` names to the layers."""

    TAPS = (1, 6, 11, 20, 29)

    def __init__(self):
        super().__init__()
        layers, self.index, cin = [], {}, 3
        for b, widths in enumerate(VGG_CFG):
            if b:
                layers.append(nn.MaxPool2d(2, 2))
            for c, width in enumerate(widths):
                if len(layers) > self.TAPS[-1]:
                    break
                self.index[f"conv{b + 1}_{c + 1}"] = len(layers)
                layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
                cin = width
        self.features = nn.Sequential(*layers[:self.TAPS[-1] + 1])

    def forward(self, x):
        taps, h = [], x
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i in self.TAPS:
                taps.append(h)
        return taps


def weights_init(m):
    """pix2pixHD's ``weights_init``: conv weights ~ N(0, 0.02)."""
    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
        m.weight.data.normal_(0.0, 0.02)


class Oracle:
    """pix2pixHD's GAN objective and train step (see the module docstring).
    ``lr_lambda`` (step -> LR factor) drives both Adams through LambdaLR,
    stepped once a train step, as the port's schedule is."""

    def __init__(self, input_nc, cond_nc, ngf=64, n_down=4, n_blocks=9, ndf=64,
                 n_layers_D=3, num_D=2, vgg=True, lr=2e-4, beta1=0.5, lambda_feat=10.0,
                 lr_lambda=None, device="cpu"):
        self.n_layers_D, self.num_D, self.lambda_feat = n_layers_D, num_D, lambda_feat
        self.G = p2p.GlobalGeneratorT(input_nc, 3, ngf, n_down, n_blocks).to(device)
        self.Ds = nn.ModuleList(p2p.NLayerDiscriminatorT(cond_nc + 3, ndf, n_layers_D)
                                for _ in range(num_D)).to(device)
        self.V = Vgg19T().to(device).requires_grad_(False) if vgg else None
        self.pool = nn.AvgPool2d(3, 2, 1, count_include_pad=False)
        self.opt_g = torch.optim.Adam(self.G.parameters(), lr=lr, betas=(beta1, 0.999))
        self.opt_d = torch.optim.Adam(self.Ds.parameters(), lr=lr, betas=(beta1, 0.999))
        self.scheds = ([torch.optim.lr_scheduler.LambdaLR(o, lr_lambda)
                        for o in (self.opt_g, self.opt_d)] if lr_lambda else [])

    def d_forward(self, cond, img):
        """Every scale's features (logits last), finest scale first."""
        x, out = torch.cat([cond, img], 1), []
        for i, d in enumerate(self.Ds):
            out.append(d(x))
            if i != self.num_D - 1:
                x = self.pool(x)
        return out

    def losses(self, x, cond, real):
        """-> (loss_G, loss_D, metrics) of pix2pixHD's objective."""
        fake = self.G(x)
        pred_fake = self.d_forward(cond, fake)
        g_gan = sum(F.mse_loss(s[-1], torch.ones_like(s[-1])) for s in pred_fake)
        pred_real = self.d_forward(cond, real)
        fm = torch.zeros((), device=real.device)
        w = 4.0 / (self.n_layers_D + 1) / self.num_D * self.lambda_feat
        for sf, sr in zip(pred_fake, pred_real):
            for f, r in zip(sf[:-1], sr[:-1]):
                fm = fm + w * F.l1_loss(f, r.detach())
        vgg = torch.zeros((), device=real.device)
        if self.V is not None:
            vf, vr = self.V(fake), self.V(real)
            vgg = self.lambda_feat * sum(wt * F.l1_loss(a, b.detach())
                                         for wt, a, b in zip(VGG_WEIGHTS, vf, vr))
        pred_fake_d = self.d_forward(cond, fake.detach())
        d_real = sum(F.mse_loss(s[-1], torch.ones_like(s[-1])) for s in pred_real)
        d_fake = sum(F.mse_loss(s[-1], torch.zeros_like(s[-1])) for s in pred_fake_d)
        metrics = {"G_GAN": g_gan, "G_GAN_Feat": fm, "G_VGG": vgg, "D_real": d_real,
                   "D_fake": d_fake}
        return g_gan + fm + vgg, 0.5 * (d_real + d_fake), metrics

    def step(self, x, cond, real):
        """One pix2pixHD update -> detached metrics."""
        loss_g, loss_d, metrics = self.losses(x, cond, real)
        self.opt_g.zero_grad(set_to_none=True)
        loss_g.backward()
        self.opt_g.step()
        self.opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        self.opt_d.step()
        for s in self.scheds:
            s.step()
        return {k: v.detach() for k, v in metrics.items()}


def load_port_init(oracle, model):
    """The port's G, D and VGG weights into the oracle's modules through
    ``pix2pixhd_format``'s state-dict maps (the same tensors: both are
    torch layouts)."""
    g = model.netG
    oracle.G.load_state_dict(p2p.global_generator_state_dict(
        g.state_dict(), g.n_downsampling, g.n_blocks, inner="block"))
    d_sd = p2p.multiscale_discriminator_state_dict(
        model.netD.state_dict(), oracle.num_D, oracle.n_layers_D, spelling="scale{i}_layer{n}")
    for i, d in enumerate(oracle.Ds):
        j = oracle.num_D - 1 - i   # pix2pixHD's scale 0 is the coarsest
        d.load_state_dict({f"stages.{n}.0.{leaf}": d_sd[f"scale{j}_layer{n}.0.{leaf}"]
                           for n in range(oracle.n_layers_D + 2) for leaf in ("weight", "bias")})
    if oracle.V is not None:
        with torch.no_grad():
            for name, i in oracle.V.index.items():
                src = getattr(model.vgg, name)
                oracle.V.features[i].weight.copy_(src.weight)
                oracle.V.features[i].bias.copy_(src.bias)


def oracle_inputs(batch, label_nc, masked_image=True):
    """(x, cond, real) NCHW in plain torch: one-hot (ids outside [0,
    label_nc) a zero row) ⊕ pix2pixHD's instance edges [⊕ the box-masked
    RGB] for G; one-hot ⊕ edges for D; the image in [-1, 1] (a uint8 image
    normalized as x / 127.5 - 1)."""
    label = batch["label"].to(torch.int64)
    onehot = (label[:, None] == torch.arange(label_nc, device=label.device)[None, :, None, None])
    t = batch["inst"].to(torch.int64)
    edge = torch.zeros_like(t, dtype=torch.bool)
    edge[:, :, 1:] |= t[:, :, 1:] != t[:, :, :-1]
    edge[:, :, :-1] |= t[:, :, 1:] != t[:, :, :-1]
    edge[:, 1:, :] |= t[:, 1:, :] != t[:, :-1, :]
    edge[:, :-1, :] |= t[:, 1:, :] != t[:, :-1, :]
    cond = torch.cat([onehot.float(), edge[:, None].float()], 1)
    img = batch["image"]
    real = (img.float() / 127.5 - 1.0 if img.dtype == torch.uint8 else img.float())
    real = real.permute(0, 3, 1, 2).contiguous()
    if not masked_image:
        return cond, cond, real
    h, w = real.shape[2:]
    ys = torch.arange(h, device=real.device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=real.device, dtype=torch.float32)[None, None, :]
    y0, x0, bh, bw = (batch["boxes"].float()[:, k, None, None] for k in range(4))
    m = ((ys >= y0) & (ys < y0 + bh) & (xs >= x0) & (xs < x0 + bw)).float()[:, None]
    return torch.cat([cond, real * (1.0 - m)], 1), cond, real


def conv_flops(h, w, cin, cout, k, stride=1):
    return (h // stride) * (w // stride) * cout * cin * k * k * 2


def model_flops_per_image(H, W, label_nc=35, ngf=64, n_down=4, n_blocks=9,
                          ndf=64, n_layers_D=3, num_D=2):
    """The JAX tool's analytic FLOP count of one train step per image
    (JAX ``tools/bench_torch_oracle.py:71``, unchanged): G forward x3, the
    D forward-equivalents x8 over its scales, VGG forward x4 (its taps
    counted as that tool counts them)."""
    in_nc = label_nc + 1 + 3
    g = conv_flops(H, W, in_nc, ngf, 7)
    h, w, c = H, W, ngf
    for _ in range(n_down):
        g += conv_flops(h, w, c, c * 2, 3, 2)
        h, w, c = h // 2, w // 2, c * 2
    g += n_blocks * 2 * conv_flops(h, w, c, c, 3)
    for _ in range(n_down):
        g += conv_flops(h * 2, w * 2, c, c // 2, 3)
        h, w, c = h * 2, w * 2, c // 2
    g += conv_flops(H, W, ngf, 3, 7)

    d_in = label_nc + 1 + 3
    d1 = 0
    h, w = H, W
    c = d_in
    nf = ndf
    d1 += conv_flops(h, w, c, nf, 4, 2)
    h, w = h // 2, w // 2
    for _ in range(1, n_layers_D):
        nf2 = min(nf * 2, 512)
        d1 += conv_flops(h, w, nf, nf2, 4, 2)
        h, w, nf = h // 2, w // 2, nf2
    nf2 = min(nf * 2, 512)
    d1 += conv_flops(h, w, nf, nf2, 4) + conv_flops(h, w, nf2, 1, 4)
    d_total = 0
    for s in range(num_D):
        sc = 2**s
        d_total += d1 / (sc * sc)

    vgg = 0
    h, w, cin = H, W, 3
    for bi, block in enumerate(VGG_CFG):
        if bi > 0:
            h, w = h // 2, w // 2
        for j, c in enumerate(block):
            vgg += conv_flops(h, w, cin, c, 3)
            cin = c
            if bi > 0 and j == 0:
                break

    total = g * 3 + d_total * 8 + vgg * 4
    return total, {"G_fwd": g, "D1_fwd": d1, "VGG_fwd": vgg}


def build(arch, bs, hw, device, seed=0):
    """(oracle at pix2pixHD's init, (x, cond, real)) for the masked-RGB
    config at ``arch`` (``roofline_step.FLAGSHIP`` keys)."""
    torch.manual_seed(seed)
    nc = arch["label_nc"]
    oracle = Oracle(nc + 1 + 3, nc + 1, arch["ngf"], arch["n_downsample_global"],
                    arch["n_blocks_global"], arch["ndf"], arch["n_layers_D"], arch["num_D"],
                    device=device)
    oracle.G.apply(weights_init)
    oracle.Ds.apply(weights_init)
    oracle.V.apply(weights_init)
    batch = synthetic_batch(np.random.RandomState(seed), bs, hw=hw, label_nc=nc)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return oracle, oracle_inputs(batch, nc)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batches", default="1,4")
    p.add_argument("--smoke", action="store_true", help="tiny widths and 64x128")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "bench_torch_oracle.json"))
    args = p.parse_args(argv)
    device = rs.device_of(args.gpu_ids)
    arch, hw = (rs.SMOKE, rs.SMOKE_HW) if args.smoke else (rs.FLAGSHIP, rs.HW)
    name = rs.device_line(device)
    key = "h100_img_per_s" if "H100" in name else f"{device.type}_img_per_s"
    tflop_img, parts = model_flops_per_image(*hw, arch["label_nc"], arch["ngf"],
                                             arch["n_downsample_global"], arch["n_blocks_global"],
                                             arch["ndf"], arch["n_layers_D"], arch["num_D"])
    tflop_512 = model_flops_per_image(256, 512)[0]
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    before = read_launches()
    rows, rates = [], {}
    try:
        for tier, tf32 in TIERS.items():
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            for bs in (int(b) for b in args.batches.split(",")):
                oracle, (x, cond, real) = build(arch, bs, hw, device)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                dt = measure_steps(lambda s, b: oracle.step(x, cond, real), None, None,
                                   args.iters, device)
                row = {"tier": tier, "bs": bs, "ms_per_step": dt * 1e3, "img_per_s": bs / dt,
                       "model_tflops_achieved": tflop_img * bs / dt / 1e12,
                       "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                          if device.type == "cuda" else None),
                       "wall_s": time.perf_counter() - t0}
                print(json.dumps(row), flush=True)
                rows.append(row)
                rates.setdefault(tier, {})[str(bs)] = row["img_per_s"]
                del oracle, x, cond, real
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    after = read_launches()
    if after != before:
        raise AssertionError(f"the oracle launched port kernels: {before} -> {after}")
    report = {
        "device": name, "shape": list(hw), "iters": args.iters,
        "model_tflop_per_img_at_shape": tflop_img / 1e12,
        "model_tflop_per_img_512x256": tflop_512 / 1e12,
        "parts_gflop_fwd": {k: v / 1e9 for k, v in parts.items()},
        key: rates, "rows": rows, "port_kernel_launches": after,
    }
    rs.write_json(args.out, report)
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}), flush=True)
    return report


if __name__ == "__main__":
    main()

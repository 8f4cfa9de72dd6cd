"""Networks — PyTorch counterparts of ``models/networks.py`` in the JAX
package (pix2pixHD lineage): the GlobalGenerator, the 1024p LocalEnhancer,
the instance-feature Encoder, the multiscale PatchGAN discriminator and the
VGG19 feature taps (mask2image), and the two-stream
structure generator with its layout discriminator (box2mask), NHWC
activations.

Module and parameter names follow the JAX param tree (``conv_in``,
``down{i}``, ``res{i}.conv1|conv2``, ``up{i}``, ``conv_out``, the batch
norm ``norm*`` modules; the LocalEnhancer's ``global.*`` trunk and
``local{n}_conv_in|down|res{i}|up``; the Encoder's, as the
GlobalGenerator's; ``scale{i}.layer{n}`` for D; ``conv{b}_{c}`` for
VGG; ``enc_in``, ``enc_down{i}``, ``cls_fuse``, ``cls_embed``,
``{ctx,obj}_up{i}``, ``{ctx,obj}_out`` and ``d.layer{n}`` for box2mask), so
``utils/checkpoint.py`` maps a JAX npz sidecar onto ``state_dict`` keys one
to one.

Init follows the reference's ``weights_init``: conv weights ~ N(0, 0.02),
biases zero, batch-norm weight ~ N(1, 0.02), bias zero, drawn from an
explicit ``torch.Generator`` (the same distribution as the JAX init, not
the same bits) by ``reset_parameters``. A module built without it holds
zeros, never uninitialized memory.

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
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.reflect, self.dead_bias = reflect, dead_bias

    def forward(self, x, x2=None, padded: bool = False):
        """``padded``: x already carries the reflect pad (PaddedStemInput).

        ``x2``: the conv over the channel concat x ⊕ x2, as two partial
        convs over one weight, ``conv(x, W[:, :cx]) + conv(x2, W[:, cx:])``
        (the JAX ``Conv(...)(x, x2)``). When one side stacks k times the
        other's batch (D's batched [real; fake] apply: the conditioning once,
        the images stacked, on either side), the smaller side's partial conv
        runs once and is tiled; batches neither of which divides the other
        raise."""
        b = None if self.dead_bias else self.bias
        if x2 is not None:
            if self.reflect:
                raise ValueError("the split-input form takes no reflect pad")
            cx = x.shape[-1]
            y = nnops.conv2d(x, self.weight[:, :cx], b, stride=self.stride,
                             padding=self.padding)
            y2 = nnops.conv2d(x2, self.weight[:, cx:], None, stride=self.stride,
                              padding=self.padding)
            if y2.shape[0] != y.shape[0]:
                small, big = sorted((y.shape[0], y2.shape[0]))
                if big % small:
                    raise ValueError(f"split-input conv: batches {y.shape[0]} and "
                                     f"{y2.shape[0]}, neither divides the other")
                if y.shape[0] == small:
                    y = y.repeat(big // small, 1, 1, 1)
                else:
                    y2 = y2.repeat(big // small, 1, 1, 1)
            return y + y2
        if self.reflect and not padded:
            x = nnops.reflect_pad(x, self.reflect)
        return nnops.conv2d(x, self.weight, b, stride=self.stride, padding=self.padding)


class ConvTranspose(nn.Module):
    """torch.nn.ConvTranspose2d(k3, s2, p1, op1) twin on NHWC."""

    def __init__(self, cin, cout, dead_bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dead_bias = dead_bias

    def forward(self, x):
        b = None if self.dead_bias else self.bias
        return nnops.conv_transpose2d(x, self.weight, b)


def norm_act(x, norm: str = "instance", act: str = "relu",
             residual: Optional[torch.Tensor] = None):
    """Parameterless norm + act: IN goes through the fused kernels
    (``kernels/instance_norm.py``, forward and backward), which add
    ``residual`` before ``act``."""
    if norm == "instance":
        return kin.instance_norm_act(x, act, residual)
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


class _GlobalBackbone(nn.Module):
    """The GlobalGenerator without its head: c7s1-ngf, n_downsampling
    stride-2 convs, n_blocks resnet blocks, mirrored transposed-conv ups
    (JAX ``_GlobalBackbone``, ``networks.py:358-403``), the trunk of the
    LocalEnhancer. Input NHWC or a ``PaddedStemInput``; output NHWC
    (B,H,W,ngf) after the last up's norm and ReLU."""

    def __init__(self, input_nc, ngf=64, n_downsampling=4, n_blocks=9, norm="instance"):
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
        return h


class GlobalGenerator(_GlobalBackbone):
    """pix2pixHD GlobalGenerator: the trunk, then c7s1-output_nc + tanh.
    Input NHWC (B,H,W,input_nc) or a ``PaddedStemInput``; output NHWC
    (B,H,W,output_nc) in [-1, 1]."""

    def __init__(self, input_nc, output_nc=3, ngf=64, n_downsampling=4,
                 n_blocks=9, norm="instance"):
        super().__init__(input_nc, ngf, n_downsampling, n_blocks, norm)
        self.conv_out = Conv(ngf, output_nc, 7, reflect=3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)

    def forward(self, x):
        return torch.tanh(self.conv_out(super().forward(x)))


class LocalEnhancer(nn.Module):
    """pix2pixHD LocalEnhancer (JAX ``networks.py:406-508``): the global
    trunk (``global``, at ngf * 2^n_local_enhancers) runs on the input
    average-pooled n_local_enhancers times; branch n (``local{n}_*``, at
    ngf * 2^(N-n)) takes the input pooled N-n times through a c7s1 stem and
    one stride-2 down, adds the trunk's (or the previous branch's) output,
    refines with n_blocks_local resnet blocks and upsamples once; the head
    is c7s1-output_nc + tanh. The input is the unpadded NHWC tensor (its
    pyramid pools it before any pad). The JAX package's packed stems and
    packed-output up are TPU layouts of the same math and have no
    counterpart."""

    def __init__(self, input_nc, output_nc=3, ngf=32, n_downsample_global=4,
                 n_blocks_global=9, n_local_enhancers=1, n_blocks_local=3,
                 norm="instance"):
        super().__init__()
        self.norm, self.n_local_enhancers = norm, n_local_enhancers
        self.n_blocks_local = n_blocks_local
        db = norm == "instance"
        self.add_module("global", _GlobalBackbone(
            input_nc, ngf * 2**n_local_enhancers, n_downsample_global, n_blocks_global, norm))
        for n in range(1, n_local_enhancers + 1):
            c = ngf * 2 ** (n_local_enhancers - n)
            self.add_module(f"local{n}_conv_in", Conv(input_nc, c, 7, reflect=3, dead_bias=db))
            self.add_module(f"local{n}_norm_in", NormAct(c, norm, "relu"))
            self.add_module(f"local{n}_down", Conv(c, 2 * c, 3, 2, 1, dead_bias=db))
            self.add_module(f"local{n}_norm_down", NormAct(2 * c, norm, "relu"))
            for i in range(n_blocks_local):
                self.add_module(f"local{n}_res{i}", ResnetBlock(2 * c, norm))
            self.add_module(f"local{n}_up", ConvTranspose(2 * c, c, dead_bias=db))
            self.add_module(f"local{n}_norm_up", NormAct(c, norm, "relu"))
        self.conv_out = Conv(ngf, output_nc, 7, reflect=3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)

    def forward(self, x):
        pyramid = [x]
        for _ in range(self.n_local_enhancers):
            pyramid.append(nnops.avg_pool_3x3s2(pyramid[-1]))
        out = getattr(self, "global")(pyramid[-1])
        for n in range(1, self.n_local_enhancers + 1):
            def layer(name, n=n):
                return getattr(self, f"local{n}_{name}")

            h = layer("norm_in")(layer("conv_in")(pyramid[self.n_local_enhancers - n]))
            h = layer("norm_down")(layer("down")(h))
            h = h + out     # the trunk's (or the previous branch's) features
            for i in range(self.n_blocks_local):
                h = layer(f"res{i}")(h)
            out = layer("norm_up")(layer("up")(h))
        return torch.tanh(self.conv_out(out))


class Encoder(nn.Module):
    """pix2pixHD instance-feature Encoder (JAX ``networks.py:591-631``): a
    conv encoder-decoder (c7s1-nef, n_downsampling stride-2 convs, as many
    transposed-conv ups, c7s1-feat_num + tanh), then instance-wise average
    pooling: every pixel takes the mean feature of its instance.

    Raw Cityscapes ids (class * 1000 + k) map to a static segment space of
    label_nc * instance_slots segments, class * slots + k % slots (clipped):
    two instances of one class collide only when its k differ by a
    multiple of ``instance_slots`` (64), as in the JAX package."""

    def __init__(self, input_nc=3, feat_num=3, nef=16, n_downsampling=4, norm="instance",
                 label_nc=35, instance_slots=64):
        super().__init__()
        self.n_downsampling = n_downsampling
        self.label_nc, self.instance_slots = label_nc, instance_slots
        db = norm == "instance"
        self.conv_in = Conv(input_nc, nef, 7, reflect=3, dead_bias=db)
        self.norm_in = NormAct(nef, norm, "relu")
        for i in range(n_downsampling):
            cin, cout = nef * 2**i, nef * 2 ** (i + 1)
            self.add_module(f"down{i}", Conv(cin, cout, 3, 2, 1, dead_bias=db))
            self.add_module(f"norm_down{i}", NormAct(cout, norm, "relu"))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up{i}", ConvTranspose(nef * mult, nef * mult // 2, dead_bias=db))
            self.add_module(f"norm_up{i}", NormAct(nef * mult // 2, norm, "relu"))
        self.conv_out = Conv(nef, feat_num, 7, reflect=3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)

    def forward(self, img, inst):
        """img (B,H,W,3) in [-1, 1], inst (B,H,W) int ids -> (B,H,W,feat_num)."""
        h = self.norm_in(self.conv_in(img))
        for i in range(self.n_downsampling):
            h = getattr(self, f"norm_down{i}")(getattr(self, f"down{i}")(h))
        for i in range(self.n_downsampling):
            h = getattr(self, f"norm_up{i}")(getattr(self, f"up{i}")(h))
        h = torch.tanh(self.conv_out(h))
        ids = inst.to(torch.int64)
        slots = self.instance_slots
        seg = torch.clamp((ids // 1000) * slots + (ids % 1000) % slots,
                          0, self.label_nc * slots - 1)
        return nnops.segment_mean_2d(h, seg, self.label_nc * slots)


def _reset_convs(module: nn.Module, generator: torch.Generator) -> None:
    """Reference ``weights_init``: conv and linear weights ~ N(0, 0.02) (the
    JAX ``conv_init``, which the structure generator's ``cls_embed`` Dense
    takes too), batch-norm weights ~ N(1, 0.02), biases zero, in
    registration order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, ConvTranspose, nn.Linear)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, NormAct) and m.norm == "batch":
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()


class NLayerDiscriminator(nn.Module):
    """PatchGAN: Conv4x4 s2 -> LReLU 0.2, then (n_layers - 1) Conv4x4 s2 +
    norm + LReLU doubling channels (cap 512), one Conv4x4 s1 + norm + LReLU,
    and a Conv4x4 s1 -> 1 logit map (no sigmoid). Every conv pads 2 with
    zeros (pix2pixHD's ceil((4-1)/2)). Under IN the convs before a norm
    keep dead biases; ``layer0``'s and the last layer's are live.

    ``forward(x, x2)`` returns every layer's output, logits last (or only
    the logits when ``get_interm_feat`` is off); x ⊕ x2 is the input
    (``Conv``'s split form: x the conditioning, x2 the image)."""

    def __init__(self, input_nc, ndf=64, n_layers=3, norm="instance",
                 get_interm_feat=True):
        super().__init__()
        self.n_layers, self.get_interm_feat = n_layers, get_interm_feat
        db = norm == "instance"
        self.layer0 = Conv(input_nc, ndf, 4, stride=2, padding=2)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer{n}", Conv(prev, nf, 4, stride=2, padding=2, dead_bias=db))
            self.add_module(f"norm{n}", NormAct(nf, norm, "lrelu"))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"layer{n_layers}", Conv(prev, nf, 4, stride=1, padding=2, dead_bias=db))
        self.add_module(f"norm{n_layers}", NormAct(nf, norm, "lrelu"))
        self.add_module(f"layer{n_layers + 1}", Conv(nf, 1, 4, stride=1, padding=2))

    def forward(self, x, x2=None):
        h = nnops.leaky_relu(self.layer0(x, x2), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{n}")(getattr(self, f"layer{n}")(h))
            feats.append(h)
        h = getattr(self, f"layer{self.n_layers + 1}")(h)
        feats.append(h)
        return feats if self.get_interm_feat else [h]


class MultiscaleDiscriminator(nn.Module):
    """num_D PatchGANs (``scale{i}``) on an AvgPool(3, 2, 1,
    count_include_pad=False) pyramid of x and x2. Output: a list over
    scales (index 0 = full resolution) of per-layer feature lists."""

    def __init__(self, input_nc, ndf=64, n_layers=3, num_D=2, norm="instance",
                 get_interm_feat=True):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            self.add_module(
                f"scale{i}",
                NLayerDiscriminator(input_nc, ndf, n_layers, norm, get_interm_feat),
            )

    def forward(self, x, x2=None):
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{i}")(x, x2))
            if i != self.num_D - 1:
                x = nnops.avg_pool_3x3s2(x)
                if x2 is not None:
                    x2 = nnops.avg_pool_3x3s2(x2)
        return results

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)


class Vgg19Features(nn.Module):
    """VGG19 feature taps at relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1
    (torchvision feature indices 1, 6, 11, 20, 29), on [-1, 1] images as
    the reference feeds them (no ImageNet normalization). The literal form
    of the JAX package's parity tier; its space-to-depth block 1 was a TPU
    layout and has no counterpart. conv5_2..conv5_4 are kept as parameters
    (the checkpoint layout is unchanged) but not run: no tap reads them."""

    CFG = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)

    def __init__(self):
        super().__init__()
        cin = 3
        for b, widths in enumerate(self.CFG):
            for c, width in enumerate(widths):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv(cin, width, 3, padding=1))
                cin = width

    def forward(self, x):
        taps = []
        h = x
        for b, widths in enumerate(self.CFG):
            if b > 0:
                h = nnops.max_pool_2x2(h)
            n_run = 1 if b == len(self.CFG) - 1 else len(widths)
            for c in range(n_run):
                h = nnops.relu(getattr(self, f"conv{b + 1}_{c + 1}")(h))
                if c == 0:
                    taps.append(h)
        return taps

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)


class TwoStreamStructureGenerator(nn.Module):
    """The box2mask structure generator (JAX ``networks.py:707-803``): a
    shared encoder over the masked one-hot layout ⊕ the box mask, class
    conditioning at the bottleneck (a box-masked class map into the 1x1
    ``cls_fuse``, then the bias-free ``cls_embed`` shift added after
    ``cls_norm`` and before the ReLU: both survive IN, which cancels a
    spatially constant pre-norm signal), resnet blocks, and two decoders
    with additive U-Net skips: ``ctx`` (label_nc layout logits) and ``obj``
    (one object-mask logit). ``forward`` -> (layout_logits, mask_logit,
    merged), merged = softmax(ctx) outside the soft object mask and the
    class one-hot inside it. The null class (an all-zero one-hot) gives a
    zero class map and a zero shift."""

    def __init__(self, label_nc=35, ngf=64, n_downsampling=3, n_blocks=4, norm="instance"):
        super().__init__()
        self.label_nc, self.norm = label_nc, norm
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        db = norm == "instance"
        self.enc_in = Conv(label_nc + 1, ngf, 7, reflect=3, dead_bias=db)
        self.enc_norm_in = NormAct(ngf, norm, "relu")
        for i in range(n_downsampling):
            cin, cout = ngf * 2**i, ngf * 2 ** (i + 1)
            self.add_module(f"enc_down{i}", Conv(cin, cout, 3, 2, 1, dead_bias=db))
            self.add_module(f"enc_norm_down{i}", NormAct(cout, norm, "relu"))
        ch = ngf * 2**n_downsampling
        self.cls_fuse = Conv(ch + label_nc, ch, 1, dead_bias=db)
        self.cls_norm = NormAct(ch, norm, "none")
        self.cls_embed = nn.utils.skip_init(nn.Linear, label_nc, ch, bias=False)
        nn.init.zeros_(self.cls_embed.weight)
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ch, norm))
        for tag, out_nc in (("ctx", label_nc), ("obj", 1)):
            for i in range(n_downsampling):
                mult = 2 ** (n_downsampling - i)
                cout = ngf * mult // 2
                self.add_module(f"{tag}_up{i}", ConvTranspose(ngf * mult, cout, dead_bias=db))
                self.add_module(f"{tag}_norm_up{i}", NormAct(cout, norm, "relu"))
            self.add_module(f"{tag}_out", Conv(ngf, out_nc, 7, reflect=3))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)

    def forward(self, masked_layout, boxmask, class_onehot):
        """masked_layout (B,H,W,label_nc), boxmask (B,H,W,1), class_onehot
        (B,label_nc)."""
        h = self.enc_norm_in(self.enc_in(torch.cat([masked_layout, boxmask], -1)))
        skips = []
        for i in range(self.n_downsampling):
            skips.append(h)
            h = getattr(self, f"enc_norm_down{i}")(getattr(self, f"enc_down{i}")(h))
        # the box mask at the bottleneck by a reshape-max, as the JAX package
        # pools it: H and W must be multiples of the bottleneck's
        b, hh, ww, _ = h.shape
        fy, fx = boxmask.shape[1] // hh, boxmask.shape[2] // ww
        if (fy * hh, fx * ww) != tuple(boxmask.shape[1:3]):
            raise ValueError(
                f"box mask {tuple(boxmask.shape[1:3])} does not pool onto the "
                f"{hh}x{ww} bottleneck: fineSize must be divisible by "
                f"2^n_downsample_global")
        bm = boxmask.reshape(b, hh, fy, ww, fx, 1).amax(dim=(2, 4))
        cmap = class_onehot[:, None, None, :] * bm
        h = self.cls_norm(self.cls_fuse(torch.cat([h, cmap], -1)))
        h = nnops.relu(h + self.cls_embed(class_onehot)[:, None, None, :])
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)

        def decoder(tag, h):
            for i in range(self.n_downsampling):
                h = getattr(self, f"{tag}_norm_up{i}")(getattr(self, f"{tag}_up{i}")(h))
                h = h + skips[self.n_downsampling - 1 - i]   # U-Net skip, after the act
            return getattr(self, f"{tag}_out")(h)

        layout_logits = decoder("ctx", h)
        mask_logit = decoder("obj", h)
        obj_mask = torch.clamp(torch.sigmoid(mask_logit) * boxmask, 0.0, 1.0)
        ctx_probs = torch.softmax(layout_logits, dim=-1)
        merged = ctx_probs * (1.0 - obj_mask) + class_onehot[:, None, None, :] * obj_mask
        return layout_logits, mask_logit, merged


class LayoutDiscriminator(nn.Module):
    """box2mask's conditional PatchGAN (JAX ``networks.py:806-829``) over the
    layout ⊕ the tiled class one-hot ⊕ the box mask. The layout comes first
    (layer0's weight slices its label_nc channels before the conditioning's
    label_nc + 1) and may stack k inputs along the batch ([gt; merged]); the
    conditioning is built once at the box mask's batch and ``Conv``'s split
    form tiles its partial conv."""

    def __init__(self, label_nc=35, ndf=64, n_layers=3, norm="instance",
                 get_interm_feat=True):
        super().__init__()
        self.d = NLayerDiscriminator(2 * label_nc + 1, ndf, n_layers, norm, get_interm_feat)

    def forward(self, layout, boxmask, class_onehot):
        b, h, w = boxmask.shape[0], layout.shape[1], layout.shape[2]
        cls = class_onehot[:, None, None, :].expand(b, h, w, class_onehot.shape[-1])
        return self.d(layout, torch.cat([cls, boxmask], -1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_convs(self, generator)


def define_D(opt, generator: torch.Generator) -> MultiscaleDiscriminator:
    """``define_D``: D's input is the conditioning (one-hot ⊕ edge) ⊕ RGB,
    initialized from ``generator``."""
    cond_nc = opt.label_nc + (0 if opt.no_instance else 1)
    d = MultiscaleDiscriminator(
        cond_nc + opt.output_nc,
        ndf=opt.ndf,
        n_layers=opt.n_layers_D,
        num_D=opt.num_D,
        norm=opt.norm,
        get_interm_feat=not opt.no_ganFeat_loss,
    )
    d.reset_parameters(generator)
    return d


def define_G(opt, input_nc: int, generator: torch.Generator) -> nn.Module:
    """``define_G`` for ``--netG global``, ``local`` and ``twostream``,
    initialized from ``generator``; ``input_nc`` is the generator input's
    channels (the structure generator's follow label_nc)."""
    if opt.netG == "twostream":
        if getattr(opt, "use_dropout", False):
            raise ValueError("--use_dropout is not supported for netG=twostream")
        g = TwoStreamStructureGenerator(
            label_nc=opt.label_nc, ngf=opt.ngf, n_downsampling=opt.n_downsample_global,
            n_blocks=opt.n_blocks_global, norm=opt.norm)
    elif opt.netG == "local":
        g = LocalEnhancer(
            input_nc, output_nc=opt.output_nc, ngf=opt.ngf,
            n_downsample_global=opt.n_downsample_global,
            n_blocks_global=opt.n_blocks_global,
            n_local_enhancers=opt.n_local_enhancers, n_blocks_local=opt.n_blocks_local,
            norm=opt.norm)
    elif opt.netG == "global":
        g = GlobalGenerator(
            input_nc, output_nc=opt.output_nc, ngf=opt.ngf,
            n_downsampling=opt.n_downsample_global, n_blocks=opt.n_blocks_global,
            norm=opt.norm)
    else:
        raise ValueError(f"unknown netG: {opt.netG}")
    g.reset_parameters(generator)
    return g


def define_E(opt, generator: torch.Generator) -> Encoder:
    """The instance-feature Encoder of ``--instance_feat`` / ``--label_feat``
    (JAX ``Pix2PixHDModel.__post_init__``), initialized from ``generator``."""
    e = Encoder(3, feat_num=opt.feat_num, nef=opt.nef, n_downsampling=opt.n_downsample_E,
                norm=opt.norm, label_nc=opt.label_nc)
    e.reset_parameters(generator)
    return e

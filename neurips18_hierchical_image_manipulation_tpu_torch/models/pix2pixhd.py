"""mask2image model — PyTorch counterpart of ``models/pix2pixhd.py`` in the
JAX package: ``generator_input_nc``, ``encode_input`` and ``inference``
(serving) and, when ``opt.isTrain``, the multiscale discriminator, VGG19
and the GAN objective ``losses`` / ``d_losses`` (training; ``g_only`` is
the G half of the image-pool split step, JAX ``losses(..., g_only=True)``,
``pix2pixhd.py:313``).

The objective runs each network under a ``{net: {name: tensor}}`` dict
(``torch.func.functional_call``): the parameters themselves, or the bf16
casts the train step makes of them (``train/steps.py``), so that the fp32
masters take the gradients. G's terms see D through detached parameters
(the JAX ``stop_gradient``), its input live.

The generator is conditioned on the label one-hot, the instance edge
plane and the box-masked RGB (the fork's change to pix2pixHD), all built
in one pass by the encode kernel (``kernels/encode.py``), and, under
``--instance_feat`` / ``--label_feat``, the instance features (the
Encoder's, ``netE``, trained with G; or ``batch["feat"]``):

  * a GlobalGenerator under instance norm, ``n_downsampling >= 1``, even
    H, W and no features (the JAX package's stem-pack conditions): the
    kernel emits the input already reflect-padded by 3 and wraps it in
    ``PaddedStemInput``, so the stem conv pads nothing itself;
  * otherwise (the LocalEnhancer, whose pyramid pools the input first;
    features, concatenated after the kernel; ``--norm batch``, odd sizes):
    the unpadded tensor.

Spans (``train/profiler.span``): ``inference`` is ``himan.infer`` around
``himan.infer.encode`` and ``himan.infer.G`` (the two timed on the card);
in the objective each network's applications are
``himan.step.forward.{encode,G,D,VGG}``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
from torch.func import functional_call

from ..kernels import encode as kenc
from ..losses import discriminator_loss, feature_matching_loss, gan_loss, vgg_loss
from ..ops.nnops import PaddedStemInput, ids_int32
from ..train.profiler import span
from . import networks

# batch keys that hold pixel coordinates: never a dtype witness (the JAX
# package keeps boxes fp32 under its bf16 policy, train/steps._COORD_KEYS)
_COORD_KEYS = frozenset({"boxes"})


class Pix2PixHDModel:
    def __init__(self, opt, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(int(opt.seed))
        self.netG = networks.define_G(opt, self.generator_input_nc(), gen)
        self.netG.to(self.device).train(opt.isTrain)
        self.netD = self.vgg = None
        if opt.isTrain:
            self.netD = networks.define_D(opt, gen).to(self.device)
            if not opt.no_vgg_loss:
                # the perceptual loss's fixed feature extractor: never trained
                self.vgg = networks.Vgg19Features()
                self.vgg.reset_parameters(gen)
                self.vgg.requires_grad_(False)
                self.vgg.to(self.device)
        self.netE = None
        if self.use_features():
            self.netE = networks.define_E(opt, gen).to(self.device).train(opt.isTrain)

    def use_features(self) -> bool:
        return bool(getattr(self.opt, "instance_feat", False)
                    or getattr(self.opt, "label_feat", False))

    def generator_input_nc(self) -> int:
        nc = self.opt.label_nc
        if not self.opt.no_instance:
            nc += 1
        if getattr(self.opt, "use_masked_image", False):
            nc += 3
        if self.use_features():
            nc += self.opt.feat_num
        return nc

    def _padded_stem(self, h: int, w: int) -> bool:
        """The JAX package's stem-pack conditions (``pix2pixhd.py:157-160``):
        a GlobalGenerator under IN with a down and even H, W, and no encoder
        features (they join the input after the encode kernel). The
        LocalEnhancer pools its input before any pad."""
        g = self.netG
        return (isinstance(g, networks.GlobalGenerator) and g.norm == "instance"
                and g.n_downsampling >= 1 and h % 2 == 0 and w % 2 == 0
                and not self.use_features())

    def encode_input(self, batch: Dict[str, torch.Tensor]):
        """batch: label (B,H,W) int ids; inst (B,H,W) int; image (B,H,W,3)
        in [-1,1] float, or raw uint8 (--uint8_transfer), normalized here
        in the dtype the batch or the generator computes in; boxes (B,4);
        feat (B,H,W,feat_num), optional, the instance features (else the
        Encoder's, under --instance_feat / --label_feat).
        Returns the generator input: a NHWC tensor or a PaddedStemInput."""
        return self._g_input(self._normalized(batch))

    def _normalized(self, batch, param_dtype: Optional[torch.dtype] = None):
        """The batch with a uint8 image normalized to [-1, 1] in the dtype
        of its float leaves, else ``param_dtype`` (the dtype the generator
        computes in)."""
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
                param_dtype or next(self.netG.parameters()).dtype,
            )
            batch["image"] = img.to(dt) / 127.5 - 1.0
        return batch

    def _ids(self, batch):
        label = ids_int32(batch["label"]).contiguous()
        inst = None if self.opt.no_instance else ids_int32(batch["inst"]).contiguous()
        dt = batch["image"].dtype if "image" in batch else torch.float32
        return label, inst, dt

    def _instance_features(self, batch, params=None):
        """JAX ``_instance_features``: ``batch["feat"]`` when given
        (cluster-sampled or precomputed maps), else the Encoder on the real
        image, pooled over ``inst`` (--instance_feat) or ``label``
        (--label_feat)."""
        if "feat" in batch:
            return batch["feat"]
        seg = batch["inst"] if getattr(self.opt, "instance_feat", False) else batch["label"]
        return self._apply(params, "E", batch["image"], seg)

    def _g_input(self, batch, params=None):
        """One-hot ⊕ edge ⊕ masked RGB from the encode kernel, ⊕ the
        instance features when the model has them (the JAX channel order,
        ``pix2pixhd.py:144-156``)."""
        label, inst, dt = self._ids(batch)
        image = boxes = None
        if getattr(self.opt, "use_masked_image", False):
            image = batch["image"].contiguous()
            boxes = batch["boxes"].to(torch.float32).contiguous()
        h, w = label.shape[1:3]
        nc = self.opt.label_nc
        if self._padded_stem(h, w):
            return PaddedStemInput(kenc.encode(label, inst, image, boxes, nc, pad=3, dtype=dt))
        g = kenc.encode(label, inst, image, boxes, nc, pad=0, dtype=dt)
        if self.use_features():
            g = torch.cat([g, self._instance_features(batch, params).to(dt)], -1)
        return g

    def _cond(self, batch):
        """D's conditioning: one-hot ⊕ edge, no RGB (the JAX package's mode
        2: D pools it for its coarser scale itself)."""
        label, inst, dt = self._ids(batch)
        return kenc.encode_cond(label, inst, self.opt.label_nc, dtype=dt)

    @torch.inference_mode()
    def inference(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,H,W,3) NHWC generator output in [-1, 1]."""
        with span("himan.infer", timed=True):
            with span("himan.infer.encode"):
                g_input = self.encode_input(batch)
            with span("himan.infer.G", timed=True):
                return self.netG(g_input)

    # ---- training: the fused G + D objective ----

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The networks by their JAX param-tree names: G, D, VGG and E."""
        return {k: m for k, m in (("G", self.netG), ("D", self.netD), ("VGG", self.vgg),
                                  ("E", self.netE)) if m is not None}

    def _params(self, params, net):
        return params[net] if params is not None else dict(self.nets()[net].named_parameters())

    def _apply(self, params, net, *args):
        """``net`` run under ``params[net]`` (its own parameters when
        ``params`` is None)."""
        return functional_call(self.nets()[net], self._params(params, net), args)

    def _d_pair(self, params, cond, real, fake):
        """One batched D apply over [real; fake] with live D parameters
        (IN is per sample, so batching is exact; the conditioning's partial
        conv runs once and is tiled) -> (D(real), D(fake))."""
        d_rf = self._apply(params, "D", cond, torch.cat([real, fake], 0))
        nb = real.shape[0]
        return [[f[:nb] for f in sc] for sc in d_rf], [[f[nb:] for f in sc] for sc in d_rf]

    def wants_rng(self) -> bool:
        """True when the train step must hand ``losses`` a per-step
        generator (``--use_dropout``: G's training forward is random)."""
        return bool(getattr(self.opt, "use_dropout", False))

    def losses(self, batch: Dict[str, torch.Tensor], params=None, g_only: bool = False,
               rng: Optional[Union[torch.Generator, Mapping]] = None):
        """-> (total, metrics, fake). ``params``: ``{G, D, VGG: {name:
        tensor}}`` to run the networks under (None: their own parameters).
        ``total.backward()`` gives both gradients at the same (θG, θD), as
        the JAX package's one gradient of its fused objective does: G's
        terms see D with its parameters detached but its input live; D's
        terms see one batched apply over [real; fake.detach()] with live D
        parameters, whose D(real) the feature-matching loss reuses,
        detached. ``g_only``: G's terms alone (D's apply on real, for
        feature matching, under the detached parameters). ``rng``: the
        generator G's dropout draws from (``--use_dropout``, JAX
        ``pix2pixhd.py:313-330``), or the keep mask of each ``ResnetBlock``
        (``networks.dropout_masks``)."""
        opt = self.opt
        g_params = self._params(params, "G")
        if self.wants_rng() and rng is None:
            raise ValueError("--use_dropout needs a per-step generator; the train "
                             "step must pass losses(..., rng=generator)")
        with span("himan.step.forward.encode"):
            batch = self._normalized(batch, next(iter(g_params.values())).dtype)
            real = batch.get("image")
            g_input, cond = self._g_input(batch, params), self._cond(batch)
        with span("himan.step.forward.G"), \
                networks.dropout_masks(rng if self.wants_rng() else None):
            fake = functional_call(self.netG, g_params, (g_input,))
        use_lsgan = not opt.no_lsgan
        d_frozen = {k: v.detach() for k, v in self._params(params, "D").items()}
        with span("himan.step.forward.D"):
            d_fake_for_g = functional_call(self.netD, d_frozen, (cond, fake))
        loss_g_gan = gan_loss(d_fake_for_g, True, use_lsgan)
        d_real = d_fake = None
        if not g_only:
            with span("himan.step.forward.D"):
                d_real, d_fake = self._d_pair(params, cond, real, fake.detach())
        elif not opt.no_ganFeat_loss:
            with span("himan.step.forward.D"):
                d_real = functional_call(self.netD, d_frozen, (cond, real))
        loss_g_feat = 0.0
        if not opt.no_ganFeat_loss:
            loss_g_feat = feature_matching_loss(
                d_fake_for_g, d_real, n_layers_D=opt.n_layers_D, num_D=opt.num_D,
                lambda_feat=opt.lambda_feat,
            )
        loss_g_vgg = 0.0
        if self.vgg is not None:
            with span("himan.step.forward.VGG"):
                loss_g_vgg = opt.lambda_feat * vgg_loss(
                    lambda x: self._apply(params, "VGG", x), fake, real)
        total = loss_g_gan + loss_g_feat + loss_g_vgg
        metrics = {"G_GAN": loss_g_gan, "G_GAN_Feat": loss_g_feat, "G_VGG": loss_g_vgg}
        if not g_only:
            loss_d, loss_d_real, loss_d_fake = discriminator_loss(d_real, d_fake, use_lsgan)
            total = total + loss_d
            metrics.update(D_real=loss_d_real, D_fake=loss_d_fake)
        return total, _detached(metrics, real.device), fake

    def d_losses(self, batch: Dict[str, torch.Tensor], fake: torch.Tensor, params=None):
        """D-only objective against a given (e.g. pool-replayed) fake ->
        (loss_d, {D_real, D_fake})."""
        with span("himan.step.forward.encode"):
            batch = self._normalized(batch,
                                     next(iter(self._params(params, "D").values())).dtype)
            cond = self._cond(batch)
        with span("himan.step.forward.D"):
            d_real, d_fake = self._d_pair(params, cond, batch["image"], fake.detach())
        loss_d, loss_d_real, loss_d_fake = discriminator_loss(
            d_real, d_fake, not self.opt.no_lsgan
        )
        return loss_d, _detached({"D_real": loss_d_real, "D_fake": loss_d_fake}, fake.device)


def _detached(metrics, device):
    """Loss terms as detached fp32 0-dim tensors (a disabled term is 0)."""
    return {
        k: (v.detach() if torch.is_tensor(v) else torch.tensor(float(v), device=device))
        for k, v in metrics.items()
    }

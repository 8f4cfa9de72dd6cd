"""box2mask model — PyTorch counterpart of ``models/box2mask.py`` in the JAX
package (``BoxToMaskModel``, ``:42-182``): the structure-generator stage.

The two-stream generator (``networks.TwoStreamStructureGenerator``)
inpaints the semantic layout inside a box: the object stream gives a
sigmoid object mask for the class, the context stream a softmax layout;
merged = the context overwritten by the class inside the mask. The
objective: the context CE weighted by 1 - the GT object mask, the object
BCE inside the box (both times ``--lambda_recon``), the optional
negative-class penalty (``--lambda_ctx_neg``, fp32), and LSGAN through the
layout discriminator, whose conditioning is the class one-hot and the box
mask.

As in ``Pix2PixHDModel``, the objective runs each network under a ``{net:
{name: tensor}}`` dict (``torch.func.functional_call``), so that the train
steps of ``train/steps.py`` (fp32 and the bf16 tier) take this model
unchanged. G's GAN term sees D through detached parameters, its input
live; D's terms see one batched apply over [gt; merged.detach()] with live
parameters.

Batches are ``data/bbox.BboxCropDataset`` crops: masked_layout and
gt_layout (B,S,S) int ids, boxmask and gt_objmask (B,S,S,1) float, cls (B,)
int, -1 for a background box (its one-hot is all zeros).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import functional_call

from ..losses import discriminator_loss, gan_loss, layout_ce_loss, object_mask_loss
from ..ops.onehot_edges import one_hot_label
from . import networks
from .pix2pixhd import _detached


class BoxToMaskModel:
    def __init__(self, opt, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(int(opt.seed))
        self.netG = networks.define_G(opt, opt.label_nc + 1, gen)
        self.netG.to(self.device).train(opt.isTrain)
        self.netD = None
        if opt.isTrain:
            # no intermediate features: box2mask has no feature-matching term
            self.netD = networks.LayoutDiscriminator(
                opt.label_nc, ndf=opt.ndf, n_layers=opt.n_layers_D, norm=opt.norm,
                get_interm_feat=False)
            self.netD.reset_parameters(gen)
            self.netD.to(self.device)

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The networks by their JAX param-tree names: G and D."""
        return {k: m for k, m in (("G", self.netG), ("D", self.netD)) if m is not None}

    def _params(self, params, net):
        return params[net] if params is not None else dict(self.nets()[net].named_parameters())

    def encode_input(self, batch: Dict[str, torch.Tensor]):
        """-> (masked one-hot with the box interior zeroed, boxmask, class
        one-hot), in the box mask's dtype."""
        boxmask = batch["boxmask"]
        dt = boxmask.dtype
        nc = self.opt.label_nc
        masked_oh = one_hot_label(batch["masked_layout"], nc, dt) * (1.0 - boxmask)
        return masked_oh, boxmask, one_hot_label(batch["cls"], nc, dt)

    def losses(self, batch: Dict[str, torch.Tensor], params=None):
        """-> (total, metrics, merged). ``params``: ``{G, D: {name: tensor}}``
        to run the networks under (None: their own parameters)."""
        opt = self.opt
        masked_oh, boxmask, cls_oh = self.encode_input(batch)
        layout_logits, mask_logit, merged = functional_call(
            self.netG, self._params(params, "G"), (masked_oh, boxmask, cls_oh))
        gt_ids, gt_obj = batch["gt_layout"], batch["gt_objmask"]
        # the context stream is not supervised at object pixels (the
        # gradient the paper's CE on the merged map gives it)
        loss_recon = opt.lambda_recon * layout_ce_loss(layout_logits, gt_ids, 1.0 - gt_obj)
        loss_obj = opt.lambda_recon * object_mask_loss(mask_logit, gt_obj, boxmask)
        lam_neg = getattr(opt, "lambda_ctx_neg", 0.0)
        loss_ctx_neg = 0.0
        if lam_neg:
            # -log(1 - p_own_class) of the context softmax at object pixels,
            # in fp32; the null class one-hots to zeros: no penalty
            ctx_p = torch.softmax(layout_logits.to(torch.float32), dim=-1)
            p_own = (ctx_p * cls_oh[:, None, None, :].to(torch.float32)).sum(-1, keepdim=True)
            obj = gt_obj.to(torch.float32)
            neg = -torch.log1p(-torch.clamp_max(p_own, 1.0 - 1e-4)) * obj
            loss_ctx_neg = lam_neg * neg.sum() / torch.clamp_min(obj.sum(), 1.0)

        use_lsgan = not opt.no_lsgan
        d_frozen = {k: v.detach() for k, v in self._params(params, "D").items()}
        loss_g_gan = gan_loss(
            functional_call(self.netD, d_frozen, (merged, boxmask, cls_oh)), True, use_lsgan)
        gt_oh = one_hot_label(gt_ids, opt.label_nc, merged.dtype)
        d_rf = functional_call(self.netD, self._params(params, "D"),
                               (torch.cat([gt_oh, merged.detach()], 0), boxmask, cls_oh))
        nb = gt_oh.shape[0]
        loss_d, loss_d_real, loss_d_fake = discriminator_loss(
            [f[:nb] for f in d_rf], [f[nb:] for f in d_rf], use_lsgan)

        total = loss_recon + loss_obj + loss_ctx_neg + loss_g_gan + loss_d
        metrics = {"G_GAN": loss_g_gan, "G_recon": loss_recon, "G_obj": loss_obj,
                   "D_real": loss_d_real, "D_fake": loss_d_fake}
        if lam_neg:
            metrics["G_ctxneg"] = loss_ctx_neg
        return total, _detached(metrics, boxmask.device), merged

    @torch.inference_mode()
    def inference(self, batch: Dict[str, torch.Tensor], return_ctx: bool = False):
        """-> (merged layout probs, object mask probs[, context probs]): the
        context stream's softmax for remove-mode fills, where the merged map
        is all zeros under a saturated mask and the null class."""
        masked_oh, boxmask, cls_oh = self.encode_input(batch)
        layout_logits, mask_logit, merged = self.netG(masked_oh, boxmask, cls_oh)
        obj = torch.sigmoid(mask_logit) * boxmask
        if return_ctx:
            return merged, obj, torch.softmax(layout_logits, dim=-1)
        return merged, obj

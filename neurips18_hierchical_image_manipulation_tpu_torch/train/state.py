"""GAN train state: the two Adam optimizers (G, D), their per-step LR
schedules and the step count — counterpart of ``GANTrainState`` and
``make_optimizers`` in ``train/state.py`` of the JAX package (``:17``):
separate ``Adam(lr, betas=(beta1, 0.999), eps=1e-8)`` for every non-D
module (G, and E under instance features) and for D, the LR constant for
``niter`` epochs and then decayed linearly (``schedule.py``), stepped once
per train step; ``--niter_fix_global`` freezes the LocalEnhancer's trunk
for its first epochs.

``state_dict`` / ``load_state_dict`` carry both Adams' moments, both
schedules' positions and the step count, which the JAX package's
checkpoints keep too (``opt_state_g``, ``opt_state_d``, ``step``), so a
resumed run continues exactly (``utils/checkpoint.CheckpointManager``)."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .schedule import linear_decay_factor


@dataclass
class GANTrainState:
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    sched_g: torch.optim.lr_scheduler.LambdaLR
    sched_d: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    def state_dict(self):
        return {"opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "sched_g": self.sched_g.state_dict(), "sched_d": self.sched_d.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd) -> None:
        for k in ("opt_g", "opt_d", "sched_g", "sched_d"):
            getattr(self, k).load_state_dict(sd[k])
        self.step = int(sd["step"])


def _until(step: int, threshold: int, factor) -> float:
    """``factor(step)`` from ``threshold`` on, 0 before it."""
    return factor(step) if step >= threshold else 0.0


def make_optimizers(opt, model, steps_per_epoch: int) -> GANTrainState:
    """The Adam pair: G's over every non-D network (G, and the Encoder E
    under instance features, which pix2pixHD trains with G), D's over D.

    ``--niter_fix_global N`` with ``--netG local`` (JAX ``_freeze_paths_until``
    / ``make_optimizers``, ``train/state.py:59-100``): for the first N *
    steps_per_epoch steps the updates of every G-side parameter whose name
    holds ``global`` (the LocalEnhancer's trunk) are zero. As in the JAX
    package, Adam runs over the trunk from step 0, so its moments do
    accumulate while it is frozen, and nothing is rebuilt when the freeze
    ends: the trunk is a parameter group of its own whose LR factor is 0
    below the threshold (``addcdiv_`` by -0.0 leaves a parameter as it was).
    The position is the schedule's step count, which a checkpoint carries."""
    factor = functools.partial(
        linear_decay_factor, niter=opt.niter, niter_decay=opt.niter_decay,
        steps_per_epoch=steps_per_epoch,
    )

    def adam(groups, lambdas):
        o = torch.optim.Adam(groups, lr=opt.lr, betas=(opt.beta1, 0.999), eps=1e-8)
        return o, torch.optim.lr_scheduler.LambdaLR(o, lambdas)

    g_side = [(n, p) for net in (model.netG, getattr(model, "netE", None)) if net is not None
              for n, p in net.named_parameters()]
    if getattr(opt, "niter_fix_global", 0) > 0 and opt.netG == "local":
        threshold = opt.niter_fix_global * steps_per_epoch
        groups = [{"params": [p for n, p in g_side if "global" not in n]},
                  {"params": [p for n, p in g_side if "global" in n]}]
        lambdas = [factor, functools.partial(_until, threshold=threshold, factor=factor)]
    else:
        groups, lambdas = [p for _, p in g_side], factor
    opt_g, sched_g = adam(groups, lambdas)
    opt_d, sched_d = adam(model.netD.parameters(), factor)
    return GANTrainState(opt_g, opt_d, sched_g, sched_d)

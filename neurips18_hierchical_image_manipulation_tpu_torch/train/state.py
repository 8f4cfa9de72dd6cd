"""GAN train state: the two Adam optimizers (G, D), their per-step LR
schedules and the step count — counterpart of ``GANTrainState`` and
``make_optimizers`` in ``train/state.py`` of the JAX package (``:17``): separate ``Adam(lr, betas=(beta1, 0.999), eps=1e-8)`` for
every non-D module (G) and for D, the LR constant for ``niter`` epochs and
then decayed linearly (``schedule.py``), stepped once per train step.

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


def make_optimizers(opt, model, steps_per_epoch: int) -> GANTrainState:
    """The Adam pair over ``model.netG`` and ``model.netD``. The JAX
    package's ``--niter_fix_global`` freezes the LocalEnhancer's trunk;
    ``--netG local`` is not ported, so there is nothing to freeze here."""
    factor = functools.partial(
        linear_decay_factor, niter=opt.niter, niter_decay=opt.niter_decay,
        steps_per_epoch=steps_per_epoch,
    )

    def adam(module):
        o = torch.optim.Adam(module.parameters(), lr=opt.lr, betas=(opt.beta1, 0.999), eps=1e-8)
        return o, torch.optim.lr_scheduler.LambdaLR(o, factor)

    opt_g, sched_g = adam(model.netG)
    opt_d, sched_d = adam(model.netD)
    return GANTrainState(opt_g, opt_d, sched_g, sched_d)

"""LR schedule: constant for ``niter`` epochs, then linear decay to 0 over
``niter_decay`` epochs, per step — counterpart of ``train/schedule.py`` in
the JAX package (the reference decrements at the END of each epoch past
niter, so 1-indexed epoch niter+1 still runs at lr0)."""

from __future__ import annotations


def linear_decay_factor(step: int, niter: int, niter_decay: int, steps_per_epoch: int) -> float:
    """lr / lr0 at 0-indexed ``step``."""
    epoch = step // max(steps_per_epoch, 1)
    decay_epochs = max(epoch - niter, 0)
    return max(1.0 - decay_epochs / max(niter_decay, 1), 0.0)


def linear_decay_schedule(lr0: float, niter: int, niter_decay: int, steps_per_epoch: int):
    """step -> lr."""
    def schedule(step: int) -> float:
        return lr0 * linear_decay_factor(step, niter, niter_decay, steps_per_epoch)

    return schedule

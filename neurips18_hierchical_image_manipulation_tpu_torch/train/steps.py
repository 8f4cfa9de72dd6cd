"""The GAN train step — counterpart of ``make_train_step`` in
``train/steps.py`` of the JAX package: both gradients are taken at the
same (θG, θD), then both optimizers step (the reference's
loss_G.backward(); step(); loss_D.backward(); step() with every gradient
evaluated before either step; see ``Pix2PixHDModel.losses``).

fp32 only in this slice: the batch is used as it comes, so the box
coordinates stay fp32 (the JAX package's ``_COORD_KEYS`` keep them out of
its bf16 cast)."""

from __future__ import annotations


def make_train_step(model):
    """-> step(state, batch) -> (metrics, fake): one update of G and D;
    metrics are detached fp32 0-dim tensors, fake the detached G output."""

    def step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        total, metrics, fake = model.losses(batch)
        total.backward()
        for o in (state.opt_g, state.opt_d, state.sched_g, state.sched_d):
            o.step()
        state.step += 1
        return metrics, fake.detach()

    return step

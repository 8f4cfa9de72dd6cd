"""The GAN train steps — counterparts of ``train/steps.py`` in the JAX
package.

``make_train_step`` (JAX ``make_train_step``, ``:70``): both gradients are
taken at the same (θG, θD), then both optimizers step (the reference's
loss_G.backward(); step(); loss_D.backward(); step() with every gradient
evaluated before either step; see ``Pix2PixHDModel.losses``).

``make_pooled_train_steps`` (JAX ``:248-329``), the ``--pool_size > 0``
path: a G step over G's terms alone, then a D step against the fake the
image pool hands back (``utils/image_pool.py``, on the host between them).

The bf16 tier (JAX ``_make_loss_fn``, ``:46-67``): the parameters stay fp32
masters. At the step boundary G's, D's and VGG's floating parameters and
the batch's float leaves are cast to bf16, except the box coordinates
(``_COORD_KEYS``: bf16 would move box edges by pixels). The cast is a
differentiable ``Tensor.to`` fed to ``torch.func.functional_call``, so the
fp32 masters take the gradients; every conv, IN and loss then runs in bf16
with fp32 statistics and sums, and losses and metrics come out fp32. Not
``torch.autocast``: it would keep IN, the losses and the tanh in fp32, a
different function from the JAX tier.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.pix2pixhd import _COORD_KEYS


def cast_params(model, dtype):
    """``{net: {name: parameter cast to dtype}}`` of G, D and VGG; the
    casts carry the gradient back to the fp32 masters."""
    return {net: {n: p.to(dtype) if p.is_floating_point() else p
                  for n, p in m.named_parameters()}
            for net, m in model.nets().items()}


def cast_batch(batch, dtype):
    """The batch's float leaves in dtype, the box coordinates kept."""
    return {k: v if k in _COORD_KEYS or not v.is_floating_point() else v.to(dtype)
            for k, v in batch.items()}


def _loss_inputs(model, batch, compute_dtype: Optional[torch.dtype]):
    """(params, batch) for ``model.losses``: the parameters themselves
    (None) and the batch as it is in fp32, bf16 casts of both otherwise."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return None, batch
    return cast_params(model, compute_dtype), cast_batch(batch, compute_dtype)


def make_train_step(model, compute_dtype: Optional[torch.dtype] = None):
    """-> step(state, batch) -> (metrics, fake): one update of G and D;
    metrics are detached fp32 0-dim tensors, fake the detached G output."""

    def step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        total, metrics, fake = model.losses(b, params)
        total.backward()
        for o in (state.opt_g, state.opt_d, state.sched_g, state.sched_d):
            o.step()
        state.step += 1
        return metrics, fake.detach()

    return step


def make_pooled_train_steps(model, compute_dtype: Optional[torch.dtype] = None):
    """-> (g_step, d_step) for the image-pool path:

      g_step(state, batch)            -> (metrics_G, fake)  updates G
      d_step(state, batch, fake_pool) -> metrics_D          updates D

    g_step sees D's current parameters detached and counts the step; with
    a passthrough pool (the fresh fake) the two equal the fused step."""

    def g_step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        total, metrics, fake = model.losses(b, params, g_only=True)
        total.backward()
        state.opt_g.step()
        state.sched_g.step()
        state.step += 1
        return metrics, fake.detach()

    def d_step(state, batch, fake_pool):
        state.opt_d.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        if params is not None:
            fake_pool = fake_pool.to(compute_dtype)
        loss, metrics = model.d_losses(b, fake_pool, params)
        loss.backward()
        state.opt_d.step()
        state.sched_d.step()
        return metrics

    return g_step, d_step

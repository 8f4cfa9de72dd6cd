"""The GAN train steps — counterparts of ``train/steps.py`` in the JAX
package.

``make_train_step`` (JAX ``make_train_step``, ``:70``): both gradients are
taken at the same (θG, θD), then both optimizers step (the reference's
loss_G.backward(); step(); loss_D.backward(); step() with every gradient
evaluated before either step; see ``Pix2PixHDModel.losses``).

``make_pooled_train_steps`` (JAX ``:248-329``), the ``--pool_size > 0``
path: a G step over G's terms alone, then a D step against the fake the
image pool hands back (``utils/image_pool.py``, on the host between them).

``make_resident_train_step`` (JAX ``:86-156``): the device-resident batch
sampled and trained on in one step, a function of (seed, step).

``--use_dropout``: the model's ``losses`` takes the step's dropout
generator, seeded from (seed, step) like the resident draws
(``dropout_generator``).

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

# the streams a step draws from, each seeded afresh from (seed, tag, n)
_SHUFFLE_TAG, _SAMPLE_TAG, _DROPOUT_TAG = 0x5EED, 0xA3C0, 0xD50


def seeded_generator(device, seed: int, tag: int, n: int) -> torch.Generator:
    """A generator on ``device`` seeded from a fixed integer mix of (seed,
    tag, n): the same numbers give the same stream in any process, so a
    stream that is a function of the step resumes exactly."""
    mix = (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9
           + int(n) * 0x94D049BB133111EB) % 2**63
    return torch.Generator(torch.device(device)).manual_seed(mix)


def dropout_generator(model, step: int) -> Optional[torch.Generator]:
    """The step's dropout generator when the model wants one (JAX
    ``_make_loss_fn``'s per-step rng, ``steps.py:46-67``), else None: a
    function of (``--seed``, step), advanced by nothing else."""
    if not (callable(getattr(model, "wants_rng", None)) and model.wants_rng()):
        return None
    return seeded_generator(model.device, model.opt.seed, _DROPOUT_TAG, step)


def _rng_kw(model, step):
    rng = dropout_generator(model, step)
    return {} if rng is None else {"rng": rng}


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
        total, metrics, fake = model.losses(b, params, **_rng_kw(model, state.step))
        total.backward()
        for o in (state.opt_g, state.opt_d, state.sched_g, state.sched_d):
            o.step()
        state.step += 1
        return metrics, fake.detach()

    return step


def make_resident_train_step(model, sample_fn, n_samples: int, batch_size: int,
                             compute_dtype: Optional[torch.dtype] = None, shuffle: bool = True,
                             seed: int = 0):
    """The fused resident step (JAX ``make_resident_train_step``,
    ``steps.py:86-156``): the batch is sampled on the device from the
    resident stores, then trained on, with no host-to-device copy.

      epoch, i = divmod(state.step, steps_per_epoch)
      perm     = randperm(n_samples), generator seeded from (seed, epoch)
      idx      = perm[i * batch_size : (i + 1) * batch_size]
      batch    = sample_fn(data, idx, generator seeded from (seed, step))

    Every generator is seeded afresh from the step's numbers and advanced by
    nothing else, so sampling is a function of (seed, state.step): a run
    resumed from a checkpoint's step continues the same stream. The laws
    are the host loader's (a fair shuffle, uniform crops, fair flips); the
    stream is the card's own.

    Returns ``step(state, data) -> (metrics, fake)`` and
    ``step_with_batch(state, data) -> (metrics, fake, batch)``, the latter
    for display iterations, which show the batch."""
    train_step = make_train_step(model, compute_dtype)
    steps_per_epoch = max(n_samples // batch_size, 1)   # drop_last, as the loaders do
    device = model.device
    perms = {}   # the current epoch's permutation, a function of (seed, epoch)

    def batch_of(state, data):
        epoch, i = divmod(state.step, steps_per_epoch)
        perm = perms.get(epoch)
        if perm is None:
            perms.clear()
            perm = perms[epoch] = (
                torch.randperm(n_samples, device=device,
                               generator=seeded_generator(device, seed, _SHUFFLE_TAG, epoch))
                if shuffle else torch.arange(n_samples, device=device))
        idx = perm[i * batch_size: (i + 1) * batch_size]
        return dict(sample_fn(data, idx,
                              seeded_generator(device, seed, _SAMPLE_TAG, state.step)))

    def step(state, data):
        return train_step(state, batch_of(state, data))

    def step_with_batch(state, data):
        batch = batch_of(state, data)
        metrics, fake = train_step(state, batch)
        return metrics, fake, batch

    return step, step_with_batch


def make_pooled_train_steps(model, compute_dtype: Optional[torch.dtype] = None):
    """-> (g_step, d_step) for the image-pool path:

      g_step(state, batch)            -> (metrics_G, fake)  updates G
      d_step(state, batch, fake_pool) -> metrics_D          updates D

    g_step sees D's current parameters detached and counts the step; with
    a passthrough pool (the fresh fake) the two equal the fused step."""

    def g_step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        total, metrics, fake = model.losses(b, params, g_only=True,
                                            **_rng_kw(model, state.step))
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

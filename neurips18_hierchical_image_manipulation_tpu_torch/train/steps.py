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

``make_dp_train_step`` (JAX ``:332-375``) and
``make_resident_dp_train_step`` (JAX ``:159-246``): the same steps over a
``parallel.DataMesh``. Each rank takes its rows of the global batch,
computes its gradients at the same (θG, θD) through the same step body and
averages them over the mesh (the JAX ``lax.pmean``): one ``all_reduce`` of
each network's gradients flattened into one buffer, and one of the
metrics. Every rank then takes the same optimizer steps, so the replicas
stay equal. Not ``DistributedDataParallel``: its hooks reduce one module's
gradients as ``backward`` reaches them, where this step evaluates G and D
at the same parameters through ``functional_call`` and reduces both after
one backward. Under ``--norm batch`` each rank's statistics are its own
rows', as in the JAX package's ``shard_map`` (no ``SyncBatchNorm``).

``--use_dropout``: the model's ``losses`` takes the step's dropout
generator, seeded from (seed, step) like the resident draws
(``dropout_generator``), and from the rank too under a mesh.

``--debug_nans`` (JAX ``train/loop.py:30-31``): every step checks its
loss, its metrics and its gradients (after the mesh's mean) with one host
sync, and raises ``FloatingPointError`` naming the first non-finite one,
before any optimizer steps.

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


def seeded_generator(device, seed: int, tag: int, n: int,
                     fold: Optional[int] = None) -> torch.Generator:
    """A generator on ``device`` seeded from a fixed integer mix of (seed,
    tag, n) and, where given, ``fold`` (a rank: the JAX ``fold_in`` of the
    device index): the same numbers give the same stream in any process,
    so a stream that is a function of the step resumes exactly."""
    mix = (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9
           + int(n) * 0x94D049BB133111EB)
    if fold is not None:
        mix += (int(fold) + 1) * 0xD6E8FEB86659FD93
    return torch.Generator(torch.device(device)).manual_seed(mix % 2**63)


def dropout_generator(model, step: int, fold: Optional[int] = None) -> Optional[torch.Generator]:
    """The step's dropout generator when the model wants one (JAX
    ``_make_loss_fn``'s per-step rng, ``steps.py:46-67``), else None: a
    function of (``--seed``, step[, rank]), advanced by nothing else."""
    if not (callable(getattr(model, "wants_rng", None)) and model.wants_rng()):
        return None
    return seeded_generator(model.device, model.opt.seed, _DROPOUT_TAG, step, fold)


def _rng_kw(model, step, fold=None):
    rng = dropout_generator(model, step, fold)
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


def all_reduce_grads(model, mesh, axes) -> None:
    """Each trained network's gradients averaged over the mesh: flattened
    into one buffer, one ``mesh.all_reduce_mean`` a network, copied back."""
    for net, m in model.nets().items():
        ps = [p for p in m.parameters() if p.grad is not None]
        if net == "VGG" or not ps:
            continue
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        mesh.all_reduce_mean(flat, axes)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def all_reduce_metrics(metrics, mesh, axes):
    """The metrics averaged over the mesh, in one ``all_reduce``."""
    keys = sorted(metrics)
    flat = mesh.all_reduce_mean(torch.stack([metrics[k].to(torch.float32) for k in keys]), axes)
    return dict(zip(keys, flat.unbind()))


def check_finite(model, total, metrics, nets=None) -> None:
    """``--debug_nans``: raise FloatingPointError naming the first
    non-finite tensor of the loss, the metrics and the trained networks'
    gradients; one host sync when all are finite."""
    named = [("loss", total)] + [(f"metric {k}", v) for k, v in metrics.items()]
    named += [(f"gradient {net}.{n}", p.grad) for net, m in model.nets().items()
              if net != "VGG" and (nets is None or net in nets)
              for n, p in m.named_parameters() if p.grad is not None]
    flags = torch.stack([torch.isfinite(t.detach()).all() for _, t in named])
    if bool(flags.all()):
        return
    bad = int((~flags).nonzero()[0])
    raise FloatingPointError(f"--debug_nans: non-finite {named[bad][0]} at this step")


def _dp_axes(mesh, axis):
    if mesh is None:
        return None, None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return axes, mesh.axis_index(axes)


def _make_step(model, compute_dtype, mesh=None, axis="data", debug_nans=False):
    axes, rank = _dp_axes(mesh, axis)

    def step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        total, metrics, fake = model.losses(b, params, **_rng_kw(model, state.step, rank))
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            all_reduce_grads(model, mesh, axes)
            metrics = all_reduce_metrics(metrics, mesh, axes)
        if debug_nans:
            check_finite(model, total, metrics)
        for o in (state.opt_g, state.opt_d, state.sched_g, state.sched_d):
            o.step()
        state.step += 1
        return metrics, fake.detach()

    return step


def make_train_step(model, compute_dtype: Optional[torch.dtype] = None,
                    debug_nans: bool = False):
    """-> step(state, batch) -> (metrics, fake): one update of G and D;
    metrics are detached fp32 0-dim tensors, fake the detached G output."""
    return _make_step(model, compute_dtype, debug_nans=debug_nans)


def make_dp_train_step(model, mesh, compute_dtype: Optional[torch.dtype] = None,
                       axis="data", debug_nans: bool = False):
    """The data-parallel step (JAX ``make_dp_train_step``): ``step(state,
    shard)`` with this rank's rows of the global batch (``shard_batch``);
    gradients and metrics are averaged over ``axis`` of ``mesh`` (a tuple
    of axes for the hybrid ``('dcn', 'data')`` mesh: one reduction per
    axis), dropout draws from (seed, step, rank). Returns the mean metrics
    and this rank's fake."""
    return _make_step(model, compute_dtype, mesh, axis, debug_nans)


def shard_batch(batch, mesh, axis="data"):
    """This rank's rows of a global batch (JAX ``shard_batch``, ``P(axes)``):
    rank r of ``axis`` takes rows [r * bs_dev, (r + 1) * bs_dev) of every
    tensor, array or list."""
    axes, r = _dp_axes(mesh, axis)
    n = mesh.axis_size(axes)

    def rows(v):
        if len(v) % n:
            raise ValueError(f"global batch {len(v)} not divisible by mesh size {n}")
        k = len(v) // n
        return v[r * k:(r + 1) * k]

    return {k: rows(v) for k, v in batch.items()}


def _broadcast(t: torch.Tensor, device: torch.device) -> None:
    """Rank 0's ``t`` on every rank; a CPU tensor (Adam's step count) goes
    through ``device`` where the backend is NCCL."""
    if t.device == device or torch.distributed.get_backend() == "gloo":
        torch.distributed.broadcast(t, 0)
        return
    tmp = t.to(device)
    torch.distributed.broadcast(tmp, 0)
    t.copy_(tmp)


@torch.no_grad()
def replicate(model, state) -> None:
    """Broadcast rank 0's parameters and buffers, both optimizers' states
    and the step count (JAX ``replicate``), so every replica starts equal."""
    dev = model.device
    for m in model.nets().values():
        for t in list(m.parameters()) + list(m.buffers()):
            _broadcast(t.data, dev)
    for o in (state.opt_g, state.opt_d):
        for s in o.state.values():
            for v in s.values():
                if torch.is_tensor(v):
                    _broadcast(v, dev)
    step = torch.tensor([state.step], dtype=torch.int64, device=dev)
    _broadcast(step, dev)
    state.step = int(step)


def _resident_batches(model, sample_fn, n_samples, batch_size, shuffle, seed, rows, fold):
    """batch_of(state, data): the step's rows ``rows`` (start, count) of
    the global batch, the epoch's permutation a function of (seed, epoch)
    and the draws of (seed, step[, fold])."""
    steps_per_epoch = max(n_samples // batch_size, 1)   # drop_last, as the loaders do
    device = model.device
    perms = {}   # the current epoch's permutation

    def batch_of(state, data):
        epoch, i = divmod(state.step, steps_per_epoch)
        perm = perms.get(epoch)
        if perm is None:
            perms.clear()
            perm = perms[epoch] = (
                torch.randperm(n_samples, device=device,
                               generator=seeded_generator(device, seed, _SHUFFLE_TAG, epoch))
                if shuffle else torch.arange(n_samples, device=device))
        start = i * batch_size + rows[0]
        idx = perm[start:start + rows[1]]
        return dict(sample_fn(data, idx,
                              seeded_generator(device, seed, _SAMPLE_TAG, state.step, fold)))

    return batch_of


def _with_batch(train_step, batch_of):
    def step(state, data):
        return train_step(state, batch_of(state, data))

    def step_with_batch(state, data):
        batch = batch_of(state, data)
        metrics, fake = train_step(state, batch)
        return metrics, fake, batch

    return step, step_with_batch


def make_resident_train_step(model, sample_fn, n_samples: int, batch_size: int,
                             compute_dtype: Optional[torch.dtype] = None, shuffle: bool = True,
                             seed: int = 0, debug_nans: bool = False):
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
    return _with_batch(make_train_step(model, compute_dtype, debug_nans),
                       _resident_batches(model, sample_fn, n_samples, batch_size, shuffle,
                                         seed, (0, batch_size), None))


def make_resident_dp_train_step(model, mesh, sample_fn, n_samples: int, batch_size: int,
                                compute_dtype: Optional[torch.dtype] = None,
                                shuffle: bool = True, seed: int = 0, axis="data",
                                debug_nans: bool = False):
    """The data-parallel fused resident step (JAX
    ``make_resident_dp_train_step``): every rank holds the same resident
    stores and the same epoch permutation of (seed, epoch), so step k's
    global batch is the single-device fused stream's; rank r takes
    ``perm[i * bs + r * bs_dev : ... + bs_dev]`` and samples it with draws
    of (seed, step, r), then the DP step trains on it. ``batch_size`` is
    the global batch and must divide by the mesh size."""
    axes, r = _dp_axes(mesh, axis)
    n = mesh.axis_size(axes)
    if batch_size % n:
        raise ValueError(f"global batch {batch_size} not divisible by mesh size {n}")
    bs_dev = batch_size // n
    return _with_batch(make_dp_train_step(model, mesh, compute_dtype, axis, debug_nans),
                       _resident_batches(model, sample_fn, n_samples, batch_size, shuffle,
                                         seed, (r * bs_dev, bs_dev), r))


def make_pooled_train_steps(model, compute_dtype: Optional[torch.dtype] = None,
                            debug_nans: bool = False):
    """-> (g_step, d_step) for the image-pool path:

      g_step(state, batch)            -> (metrics_G, fake)  updates G
      d_step(state, batch, fake_pool) -> metrics_D          updates D

    g_step sees D's current parameters detached and counts the step; with
    a passthrough pool (the fresh fake) the two equal the fused step."""
    g_nets = ("G", "E")

    def g_step(state, batch):
        state.opt_g.zero_grad(set_to_none=True)
        params, b = _loss_inputs(model, batch, compute_dtype)
        total, metrics, fake = model.losses(b, params, g_only=True,
                                            **_rng_kw(model, state.step))
        total.backward()
        if debug_nans:
            check_finite(model, total, metrics, g_nets)
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
        if debug_nans:
            check_finite(model, loss, metrics, ("D",))
        state.opt_d.step()
        state.sched_d.step()
        return metrics

    return g_step, d_step

"""Training loop — counterpart of ``train/loop.py`` in the JAX package:
epochs over the loader, the G+D step (fp32, or the bf16 tier under
``--dtype bfloat16``), the loss line every ``print_freq`` steps with the
throughput (``img_per_s_per_chip``, ``:198-201``), the HTML visuals every
``display_freq`` steps, ``latest`` every ``save_latest_freq`` steps,
``{epoch}`` and ``latest`` every ``save_epoch_freq`` epochs and a final
``latest``, each a resumable checkpoint (``utils/checkpoint``).

Two paths run an epoch:

  * the fused resident path (``:112-131``, ``:172-214``), when the loader
    is device-resident (``--device_resident_data``), ``--fused_resident_step``
    holds (the default) and no image pool splits the step: each iteration
    samples its batch on the device from ``state.step`` and trains on it
    (``steps.make_resident_train_step``), with no host-to-device copy;
    display iterations take the batch back for the visuals. Sampling is a
    function of (seed, step), so a resumed run continues the same stream
    and the resume's skip only aligns the epoch's bookkeeping;
  * the streamed path (``:216-246``): the loader's batches, staged on the
    device ``--device_prefetch`` batches ahead (``prefetch.device_prefetch``;
    0 stages each in line). Under ``--no-fused_resident_step`` (or an image
    pool) a resident loader's own batches take this path, as in the JAX
    package: its host shuffle of each epoch, a gather on the card a batch.

Under a data-parallel ``mesh`` (``parallel.make_data_mesh``; JAX ``:75-85``,
``:102-106``, ``:133-150``) the step is ``steps.make_dp_train_step`` (each
rank stages its rows of the global batch) or, fused,
``steps.make_resident_dp_train_step``; rank 0's parameters and optimizer
states are broadcast once after the restore, which every rank makes. Only
rank 0 prints the loss line and writes ``loss_log.txt``, the HTML page,
checkpoints, ``iter.txt`` and ``--profile_dir`` traces, and
``img_per_s_per_chip`` divides by the world size. ``--pool_size > 0`` is
refused with a mesh, as in the JAX package (the pool is one process's
buffer).

``--pool_size > 0`` takes the split G/D steps with the host-side image
pool between them (``:86-100``) for a model with a D-only objective
(``d_losses``: mask2image); box2mask has none and trains the fused step,
as in the JAX package. ``--debug_nans`` makes every step check its losses,
metrics and gradients (``steps.check_finite``). ``--load_pretrain DIR``
initializes the networks from another run's ``--which_epoch`` weights once
the state is built and before a resume. ``--continue_train`` restores
``--which_epoch`` and resumes at ``iter.txt``'s epoch, skipping the batches
of it already done. The streaming loader's shuffle order is not part of a
checkpoint (as in the JAX package, whose loop calls no ``get_state`` of
the grain iterator either; ``--data_backend grain`` takes the same skip):
a resumed streamed run repeats the straight run's batches exactly under
``--serial_batches`` (and under grain's shuffle within the first epoch),
except where box2mask's ``--bg_box_prob`` places background boxes by the
loader's own epoch count, which a new process starts at 0 (so does the JAX
package's; grain's shuffle of epoch e is seeded by it too).
``--profile_dir`` traces the 21st step of the run (``trace``, the step the
JAX loop traces).
"""

from __future__ import annotations

import itertools
import time

import torch

from ..utils.checkpoint import CheckpointManager, load_pretrain_into
from ..utils.image_pool import ImagePool
from ..utils.imaging import tensor2im, tensor2label
from ..utils.visualizer import Visualizer
from .prefetch import H2DStager, device_prefetch, ready, to_device
from .profiler import ThroughputMeter, trace
from .state import make_optimizers
from .steps import (
    make_dp_train_step,
    make_pooled_train_steps,
    make_resident_dp_train_step,
    make_resident_train_step,
    make_train_step,
    replicate,
    shard_batch,
)

PROFILE_STEP = 20   # --profile_dir traces the step after this many


def _host(t):
    """A device tensor as numpy: floats (bf16 too) as fp32, ids as they are."""
    return t.to(torch.float32).cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def _pooled(opt, model) -> bool:
    return opt.pool_size > 0 and hasattr(model, "d_losses")


def make_step_fn(opt, model, mesh=None):
    """-> step(state, batch) -> (metrics, fake) for the options' path."""
    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    debug_nans = getattr(opt, "debug_nans", False)
    if mesh is not None:
        return make_dp_train_step(model, mesh, compute_dtype, debug_nans=debug_nans)
    if not _pooled(opt, model):
        return make_train_step(model, compute_dtype, debug_nans)
    pool = ImagePool(opt.pool_size, seed=opt.seed)
    g_step, d_step = make_pooled_train_steps(model, compute_dtype, debug_nans)

    def step(state, batch):
        metrics, fake = g_step(state, batch)
        pooled = torch.from_numpy(pool.query(_host(fake))).to(fake.device)
        return {**metrics, **d_step(state, batch, pooled)}, fake

    return step


class _Silent:
    """The visualizer of a rank other than 0: prints and writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def train(opt, model, loader, make_visuals=None, mesh=None):
    """Run epochs up to ``niter + niter_decay``; returns the train state."""
    if mesh is not None and getattr(opt, "pool_size", 0) > 0:
        # the JAX loop's refusal, word for word
        raise ValueError(
            "--pool_size > 0 is incompatible with multi-chip training "
            "(mesh): the image-pool replay is a host-side buffer. Use "
            "pool_size=0 on a mesh (the reference's pool is also "
            "single-process-only)."
        )
    main = mesh is None or mesh.rank == 0
    visualizer = Visualizer(opt) if main else _Silent()
    ckpt = CheckpointManager(opt)
    state = make_optimizers(opt, model, max(len(loader), 1))
    if getattr(opt, "load_pretrain", ""):
        load_pretrain_into(model, opt.load_pretrain, opt.which_epoch)
    start_epoch, epoch_iter0 = 1, 0
    if opt.continue_train:
        if ckpt.exists(opt.which_epoch):
            ckpt.restore(opt.which_epoch, model, state)
            start_epoch, epoch_iter0 = ckpt.read_iter()
            if main:
                print(f"resumed from {opt.which_epoch} at epoch {start_epoch}")
        elif main:
            print(
                f"WARNING: --continue_train set but no '{opt.which_epoch}' "
                "checkpoint found — training from scratch"
            )
    if mesh is not None:
        replicate(model, state)
    device = model.device
    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    debug_nans = getattr(opt, "debug_nans", False)
    fused = (hasattr(loader, "fused_sampler") and getattr(opt, "fused_resident_step", True)
             and not _pooled(opt, model))
    if fused:
        sample_fn, resident = loader.fused_sampler()
        kw = dict(shuffle=not opt.serial_batches, seed=opt.seed, debug_nans=debug_nans)
        if mesh is None:
            fused_step, fused_step_wb = make_resident_train_step(
                model, sample_fn, loader.n_samples, opt.batchSize, compute_dtype, **kw)
        else:
            fused_step, fused_step_wb = make_resident_dp_train_step(
                model, mesh, sample_fn, loader.n_samples, opt.batchSize, compute_dtype, **kw)
    else:
        step_fn = make_step_fn(opt, model, mesh)
        depth = getattr(opt, "device_prefetch", 0)
        to_dev = (H2DStager(device) if depth > 0 and device.type == "cuda"
                  else lambda hb: to_device(hb, device))
        stage = to_dev if mesh is None else (lambda hb: to_dev(shard_batch(hb, mesh)))
    meter = ThroughputMeter(opt.batchSize, mesh.world_size if mesh is not None else 1,
                            window=opt.print_freq, device=device)
    profile_dir = getattr(opt, "profile_dir", "") if main else ""

    def after_step(epoch, i, metrics, fake, host_batch, iter_start):
        """The loss line, the visuals and the periodic ``latest``."""
        ips = meter.tick()
        if main and state.step % opt.print_freq == 0:
            errors = {k: float(v) for k, v in metrics.items()}
            if ips:
                errors["img_per_s_per_chip"] = ips
            visualizer.print_current_errors(epoch, i + 1, errors, time.time() - iter_start)
            visualizer.plot_current_errors(errors, state.step)
        if main and make_visuals is not None and state.step % opt.display_freq == 0:
            visualizer.display_current_results(
                make_visuals(host_batch(), _host(fake)), epoch, state.step)
        if main and state.step % opt.save_latest_freq == 0:
            ckpt.save("latest", model, state, epoch, i + 1)

    def fused_epoch(epoch, skip):
        for i in range(skip, max(loader.n_samples // opt.batchSize, 1)):
            iter_start = time.time()
            want_batch = (main and make_visuals is not None
                          and (state.step + 1) % opt.display_freq == 0)
            with trace(profile_dir if state.step == PROFILE_STEP else None):
                if want_batch:
                    metrics, fake, batch = fused_step_wb(state, resident)
                else:
                    metrics, fake = fused_step(state, resident)
                    batch = None
            after_step(epoch, i, metrics, fake,
                       lambda: {k: _host(v) for k, v in batch.items()}, iter_start)

    def streamed_epoch(epoch, skip):
        batches = device_prefetch(itertools.islice(loader, skip, None), stage, depth)
        for i, (staged, host_batch) in enumerate(batches, start=skip):
            iter_start = time.time()
            with trace(profile_dir if state.step == PROFILE_STEP else None):
                metrics, fake = step_fn(state, ready(staged))
            after_step(epoch, i, metrics, fake,
                       lambda: {k: _host(v) if torch.is_tensor(v) else v
                                for k, v in host_batch.items()}, iter_start)

    n_epochs = opt.niter + opt.niter_decay
    for epoch in range(start_epoch, n_epochs + 1):
        epoch_start = time.time()
        skip = epoch_iter0 if epoch == start_epoch else 0
        (fused_epoch if fused else streamed_epoch)(epoch, skip)
        if main and epoch % opt.save_epoch_freq == 0:
            ckpt.save(epoch, model, state, epoch + 1, 0)
            ckpt.save("latest", model, state, epoch + 1, 0)
        if main:
            print(
                f"End of epoch {epoch} / {n_epochs} \t"
                f" Time Taken: {time.time() - epoch_start:.0f} sec",
                flush=True,
            )
    # always leave a resumable `latest` at the end, whatever the periodic
    # freqs were
    if main:
        ckpt.save("latest", model, state, n_epochs + 1, 0)
    return state


def mask2image_visuals(host_batch, fake, label_nc=35):
    """JAX ``loop.py:282-289``: the label map, the fake and the real image
    of the batch's first sample, as uint8 HWC."""
    vis = {
        "input_label": tensor2label(host_batch["label"], label_nc),
        "synthesized_image": tensor2im(fake),
    }
    if "image" in host_batch:
        vis["real_image"] = tensor2im(host_batch["image"])
    return vis


def box2mask_visuals(host_batch, merged, label_nc=35):
    """JAX ``loop.py:292-297``: the masked layout, the merged prediction and
    the GT layout of the batch's first sample, palette RGB."""
    return {
        "masked_layout": tensor2label(host_batch["masked_layout"], label_nc),
        "predicted_layout": tensor2label(merged, label_nc),
        "gt_layout": tensor2label(host_batch["gt_layout"], label_nc),
    }

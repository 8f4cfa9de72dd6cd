"""Training loop — counterpart of the streamed path of ``train/loop.py`` in
the JAX package: epochs over the loader, the G+D step (fp32, or the bf16
tier under ``--dtype bfloat16``), the loss line every ``print_freq``
steps, the HTML visuals every ``display_freq`` steps (``:229-245``),
``latest`` every ``save_latest_freq`` steps, ``{epoch}`` and ``latest``
every ``save_epoch_freq`` epochs and a final ``latest``, each a resumable
checkpoint (``utils/checkpoint.CheckpointManager``).

``--pool_size > 0`` takes the split G/D steps with the host-side image
pool between them (``:86-100``) for a model with a D-only objective
(``d_losses``: mask2image); box2mask has none and trains the fused step,
as in the JAX package. ``--continue_train`` restores
``--which_epoch`` and resumes at ``iter.txt``'s epoch, skipping the batches
of it already done (``:61-71``, ``:250-262``). The loader's shuffle order
is not part of a checkpoint (as in the JAX package): a resumed run repeats
the straight run's batches exactly under ``--serial_batches``, except where
box2mask's ``--bg_box_prob`` places background boxes by the loader's own
epoch count, which a new process starts at 0 (so does the JAX package's).
"""

from __future__ import annotations

import time

import torch

from ..utils.checkpoint import CheckpointManager
from ..utils.image_pool import ImagePool
from ..utils.imaging import tensor2im, tensor2label
from ..utils.visualizer import Visualizer
from .state import make_optimizers
from .steps import make_pooled_train_steps, make_train_step


def to_device(host_batch, device):
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in host_batch.items()
        if not isinstance(v, list)
    }


def _host(t):
    return t.to(torch.float32).cpu().numpy()


def make_step_fn(opt, model):
    """-> step(state, batch) -> (metrics, fake) for the options' path."""
    compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else None
    if opt.pool_size <= 0 or not hasattr(model, "d_losses"):
        return make_train_step(model, compute_dtype)
    pool = ImagePool(opt.pool_size, seed=opt.seed)
    g_step, d_step = make_pooled_train_steps(model, compute_dtype)

    def step(state, batch):
        metrics, fake = g_step(state, batch)
        pooled = torch.from_numpy(pool.query(_host(fake))).to(fake.device)
        return {**metrics, **d_step(state, batch, pooled)}, fake

    return step


def train(opt, model, loader, make_visuals=None):
    """Run epochs up to ``niter + niter_decay``; returns the train state."""
    visualizer = Visualizer(opt)
    ckpt = CheckpointManager(opt)
    state = make_optimizers(opt, model, max(len(loader), 1))
    start_epoch, epoch_iter0 = 1, 0
    if opt.continue_train:
        if ckpt.exists(opt.which_epoch):
            ckpt.restore(opt.which_epoch, model, state)
            start_epoch, epoch_iter0 = ckpt.read_iter()
            print(f"resumed from {opt.which_epoch} at epoch {start_epoch}")
        else:
            print(
                f"WARNING: --continue_train set but no '{opt.which_epoch}' "
                "checkpoint found — training from scratch"
            )
    step_fn = make_step_fn(opt, model)
    n_epochs = opt.niter + opt.niter_decay
    for epoch in range(start_epoch, n_epochs + 1):
        epoch_start = time.time()
        skip = epoch_iter0 if epoch == start_epoch else 0
        for i, host_batch in enumerate(loader):
            if i < skip:
                continue
            iter_start = time.time()
            metrics, fake = step_fn(state, to_device(host_batch, model.device))
            if state.step % opt.print_freq == 0:
                errors = {k: float(v) for k, v in metrics.items()}
                visualizer.print_current_errors(epoch, i + 1, errors, time.time() - iter_start)
                visualizer.plot_current_errors(errors, state.step)
            if make_visuals is not None and state.step % opt.display_freq == 0:
                visualizer.display_current_results(
                    make_visuals(host_batch, _host(fake)), epoch, state.step)
            if state.step % opt.save_latest_freq == 0:
                ckpt.save("latest", model, state, epoch, i + 1)
        if epoch % opt.save_epoch_freq == 0:
            ckpt.save(epoch, model, state, epoch + 1, 0)
            ckpt.save("latest", model, state, epoch + 1, 0)
        print(
            f"End of epoch {epoch} / {n_epochs} \t"
            f" Time Taken: {time.time() - epoch_start:.0f} sec",
            flush=True,
        )
    # always leave a resumable `latest` at the end, whatever the periodic
    # freqs were
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

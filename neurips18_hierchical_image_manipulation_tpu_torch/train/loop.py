"""Training loop — counterpart of the streamed path of ``train/loop.py`` in
the JAX package: epochs over the loader, the G+D step, the loss line every
``print_freq`` steps, ``latest`` params every ``save_latest_freq`` steps,
``{epoch}`` and ``latest`` every ``save_epoch_freq`` epochs, and a final
``latest`` at the end. Checkpoints are the JAX sidecar layout
(``utils/checkpoint.save_params``). The HTML visuals, ``iter.txt`` resume
and optimizer-state checkpoints wait for a later slice."""

from __future__ import annotations

import time

import torch

from ..utils.checkpoint import save_params
from ..utils.visualizer import Visualizer
from .state import make_optimizers
from .steps import make_train_step


def to_device(host_batch, device):
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in host_batch.items()
        if not isinstance(v, list)
    }


def train(opt, model, loader):
    """Run ``niter + niter_decay`` epochs; returns the train state."""
    visualizer = Visualizer(opt)
    state = make_optimizers(opt, model, max(len(loader), 1))
    step_fn = make_train_step(model)
    print("note: --display_freq has no effect (the HTML visuals are not ported yet)")
    n_epochs = opt.niter + opt.niter_decay
    for epoch in range(1, n_epochs + 1):
        epoch_start = time.time()
        for i, host_batch in enumerate(loader):
            iter_start = time.time()
            metrics, _ = step_fn(state, to_device(host_batch, model.device))
            if state.step % opt.print_freq == 0:
                errors = {k: float(v) for k, v in metrics.items()}
                visualizer.print_current_errors(epoch, i + 1, errors, time.time() - iter_start)
            if state.step % opt.save_latest_freq == 0:
                save_params(opt, "latest", model)
        if epoch % opt.save_epoch_freq == 0:
            save_params(opt, epoch, model)
            save_params(opt, "latest", model)
        print(
            f"End of epoch {epoch} / {n_epochs} \t"
            f" Time Taken: {time.time() - epoch_start:.0f} sec",
            flush=True,
        )
    # always leave a `latest` at the end, whatever the periodic freqs were
    save_params(opt, "latest", model)
    return state

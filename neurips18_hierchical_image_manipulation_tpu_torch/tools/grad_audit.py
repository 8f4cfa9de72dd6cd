"""One train step's gradients on one device held to the same step on another.

The card's checks elsewhere hold each hand-written kernel to its plain
PyTorch version, and both sides share every PyTorch op, so an op that is
wrong on the card alone (ROADMAP §C.12: AvgPool2d's input gradient on a
channels_last view) passes them. Here the whole step runs twice from the
same parameters and batch: on the card (the kernels) and on the CPU (the
plain versions, another summation order in every op), and every trained
parameter's gradient is compared tensor by tensor.

  * ``step_gradients``: one ``train/steps.make_train_step`` step -> its
    losses and the gradient of every parameter of G, D and E (never the
    frozen VGG) in fp64 on the model's device; the parameters are put
    back, so the step can be taken again from the same point.
  * ``tensor_diffs``: per tensor, max |a - b| / max |b|, the share of the
    elements of nonzero b whose sign a does not share (Adam's first update
    is sign(g) * lr), ||a - b|| / ||b||, the cosine of a and b and
    ||a|| / ||b||.
  * ``bar_of``: the bar from a device's spreads against itself, as the
    C.12 probe built its own: per metric SPREAD_FACTOR times the largest
    spread over the tensors, within FLOORS and CAPS; ||a - b|| / ||b||
    against the fixed REL_L2_BAR (max |diff| and the flips are set by
    the few elements a rounding change moves most; the norm is not, and
    it sees a gradient of the right signs at the wrong scale).
  * ``check_step``: the card's spread against itself (the step run twice,
    and once with a 1-ulp nudge of its input image, or of every parameter
    where the inputs are one-hot maps: the size of the rounding differences
    another summation order makes), its ``bar_of``, and every tensor of
    the card's step against the CPU's within it.
  * ``check_bf16``: the bf16 tier's gradients against an fp32 step, per
    tensor against BF16_COS, BF16_FLIPS and BF16_NORM.

``chip_smoke.py`` phase 38 runs these on the card against the CPU;
``tests/test_torch_grad_audit.py`` runs them on the CPU against itself
(oneDNN off on one side) and plants a wrong pool backward.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional

import torch

from ..models.factory import precision_scope
from ..train.state import make_optimizers
from ..train.steps import make_train_step

SPREAD_FACTOR = 2.0      # the bar: this many times the card's own spread ...
FLOORS = {"max_rel": 1e-2, "flips": 2e-3}    # ... never below these
CAPS = {"max_rel": 0.3, "flips": 0.02}       # ... nor above these (C.12 at the init: 0.83
                                             # and 20.5 %; sound steps on the card 0.16 and
                                             # 0.4 % at most)
REL_L2_BAR = 0.05        # sound steps on the card 0.0104 at most; a gradient 1.5x off 0.5
LOSS_RTOL = 1e-4         # each loss term, unless the spread is larger
BF16_COS = 0.8           # bf16 tier against the fp32 step, per tensor: at the init bf16
BF16_FLIPS = 0.2         # rounding leaves G's first layers at cosine 0.87-0.95 and up to
                         # 16 % flipped; C.12 in the bf16 tier 0.42 and 34 %
BF16_NORM = 0.2          # | ||a|| / ||b|| - 1 |: sound steps on the card 0.08 at most (but
                         # the Encoder's, ROADMAP C.14); a gradient 1.5x off 0.5


def trained(model) -> Dict[str, torch.nn.Module]:
    """The networks a train step updates: G, D and, under instance
    features, E."""
    return {net: m for net, m in model.nets().items() if net != "VGG"}


def copy_params(src, dst) -> None:
    """``src``'s parameters and buffers into ``dst`` (another device)."""
    for net, m in src.nets().items():
        dst.nets()[net].load_state_dict(m.state_dict())


@contextlib.contextmanager
def _restored(model):
    saved = {net: {k: v.detach().clone() for k, v in m.state_dict().items()}
             for net, m in model.nets().items()}
    try:
        yield
    finally:
        for net, m in model.nets().items():
            m.load_state_dict(saved[net])


def _nudged(batch, model, nudge):
    """The batch with its image one ulp up (``nudge`` "image"), or the
    batch as it is after every trained parameter went one ulp up
    ("params"; inside ``_restored``)."""
    if nudge == "image":
        b = dict(batch)
        b["image"] = torch.nextafter(batch["image"], torch.full_like(batch["image"], 2.0))
        return b
    with torch.no_grad():
        for m in trained(model).values():
            for p in m.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    return batch


def step_gradients(model, batch, compute_dtype: Optional[torch.dtype] = None,
                   nudge: Optional[str] = None):
    """One ``make_train_step`` step on ``batch`` -> ({loss: float},
    {"net.name": fp64 gradient on the model's device}); the parameters
    (and buffers) are as they were afterwards. ``nudge``: "image" or
    "params" (``_nudged``)."""
    step = make_train_step(model, compute_dtype)
    with _restored(model), precision_scope(model):
        b = _nudged(batch, model, nudge) if nudge else batch
        state = make_optimizers(model.opt, model, 1000)
        metrics, _ = step(state, b)
        grads = {f"{net}.{n}": p.grad.detach().double()
                 for net, m in trained(model).items() for n, p in m.named_parameters()
                 if p.grad is not None}
        for m in model.nets().values():
            m.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in metrics.items()}, grads


def tensor_diffs(a, b):
    """Per tensor of ``b`` (the reference): max |a - b| / max |b|, the share
    of b's nonzero elements whose sign a does not share, ||a - b|| / ||b||,
    the cosine and ||a|| / ||b||. A tensor whose reference is all zero is left
    out (no gradient reaches it on either side). Each pair is compared on
    b's device."""
    if set(a) != set(b):
        raise AssertionError(f"gradients on one side only: {sorted(set(a) ^ set(b))}")
    out = {}
    for k, gb in b.items():
        ga, scale = a[k].to(gb.device), float(gb.abs().max())
        if scale == 0.0:
            continue
        nz = gb != 0
        na, nb = float(ga.norm()), float(gb.norm())
        out[k] = {"max_rel": float((ga - gb).abs().max()) / scale,
                  "flips": float((torch.sign(ga[nz]) != torch.sign(gb[nz])).double().mean()),
                  "rel_l2": float((ga - gb).norm()) / nb,
                  "cos": float((ga * gb).sum()) / max(na * nb, 1e-300),
                  "norm_ratio": na / nb}
    return out


def _loss_rel(a, b):
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}


def worst(diffs, key):
    """(largest value of ``key`` over the tensors, the tensor)."""
    k = max(diffs, key=lambda t: diffs[t][key])
    return diffs[k][key], k


def bar_of(*spreads):
    """The bar from ``tensor_diffs`` of a device's gradients against its
    own: per metric of FLOORS, SPREAD_FACTOR x its largest value over the
    tensors and the spreads, within FLOORS and CAPS; ``rel_l2`` REL_L2_BAR."""
    bar = {m: min(CAPS[m], max(FLOORS[m], SPREAD_FACTOR * max(worst(d, m)[0] for d in spreads)))
           for m in FLOORS}
    return {**bar, "rel_l2": REL_L2_BAR}


def check_step(model, ref_model, batch, ref_batch, nudge="image", ref=None):
    """``model``'s step (the card's) against ``ref_model``'s (the CPU's)
    from the same parameters and batch (or against ``ref``, the losses and
    gradients of an earlier ``check_step``'s CPU step). ``model`` runs
    twice and once nudged: its spread is the largest difference of those
    two from its first run over the tensors, for each metric; the bar its
    ``bar_of``; each loss within the larger of LOSS_RTOL and SPREAD_FACTOR
    x its spread -> a report with ``misses`` (empty when every tensor and
    loss is within its bar, ``ref_losses`` among its keys), and the CPU's
    gradients, moved to the card."""
    losses, got = step_gradients(model, batch)
    again_losses, again = step_gradients(model, batch)
    nudged_losses, nudged = step_gradients(model, batch, nudge=nudge)
    t = time.perf_counter()
    ref_losses, ref = ref if ref is not None else step_gradients(ref_model, ref_batch)
    ref_s = time.perf_counter() - t
    dev = next(iter(got.values())).device
    ref = {k: v.to(dev) for k, v in ref.items()}
    spreads = [tensor_diffs(again, got), tensor_diffs(nudged, got)]
    spread = {m: max(worst(d, m)[0] for d in spreads) for m in ("max_rel", "flips", "rel_l2")}
    bar = bar_of(*spreads)
    rows = tensor_diffs(got, ref)
    misses = over_bars(rows, bar)
    loss_spread = {k: max(v, _loss_rel(nudged_losses, losses)[k])
                   for k, v in _loss_rel(again_losses, losses).items()}
    loss_rel = _loss_rel(losses, ref_losses)
    loss_bar = {k: max(LOSS_RTOL, SPREAD_FACTOR * loss_spread[k]) for k in loss_rel}
    misses += [f"loss {k}" for k in loss_rel if loss_rel[k] > loss_bar[k]]
    return {"losses": losses, "ref_losses": ref_losses, "loss_rel": loss_rel,
            "loss_bar": loss_bar, "tensors": len(rows), "spread": spread, "bar": bar,
            "ref_step_s": ref_s,
            "worst_max_rel": worst(rows, "max_rel"), "worst_flips": worst(rows, "flips"),
            "worst_rel_l2": worst(rows, "rel_l2"),
            "misses": misses, "per_tensor": rows}, ref


def over_bars(diffs, bar):
    """The tensors of ``diffs`` over any metric of ``bar`` (``bar_of``'s)."""
    return [k for k, d in diffs.items() if any(d[m] > v for m, v in bar.items())]


def bf16_misses(rows):
    return [k for k, d in rows.items() if d["cos"] < BF16_COS or d["flips"] > BF16_FLIPS
            or abs(d["norm_ratio"] - 1.0) > BF16_NORM]


def check_bf16(model_bf16, batch, ref_grads):
    """The bf16 tier's step (``model_bf16``: fp32 masters, bf16 compute) on
    ``batch`` against the fp32 gradients ``ref_grads``: each tensor's
    cosine at least BF16_COS, its flipped-sign share at most BF16_FLIPS and
    its norm within BF16_NORM of the reference's -> a report with
    ``misses``."""
    losses, got = step_gradients(model_bf16, batch, torch.bfloat16)
    rows = tensor_diffs(got, ref_grads)
    return {"losses": losses, "tensors": len(rows),
            "worst_cos": min((d["cos"], k) for k, d in rows.items()),
            "worst_flips": worst(rows, "flips"),
            "worst_norm": max((abs(d["norm_ratio"] - 1.0), k) for k, d in rows.items()),
            "bar_cos": BF16_COS, "bar_flips": BF16_FLIPS, "bar_norm": BF16_NORM,
            "misses": bf16_misses(rows), "per_tensor": rows}

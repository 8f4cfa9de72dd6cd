"""The reference's train steps: gradients over a batch in blocks of rows
(exact: instance norm is per sample and every loss term is a mean or a ratio
of sums over the batch), then Adam on G and on D (pix2pixHD's Adam(lr,
(beta1, 0.999), eps 1e-8); both gradients taken at the same parameters).
"""

from __future__ import annotations

import torch

from . import registry
from .precision import mode


def build(cfg, train: bool, device, weights, model=None):
    """The reference of ``cfg`` on ``device`` with ``weights`` ({net: {name:
    tensor}}) loaded; ``model``: the model's module, by default the one that
    declares ``cfg["model"]`` (``registry.py``)."""
    ref = (model or registry.find(cfg["model"])).Reference(cfg, train)
    for net, m in ref.nets.items():
        m.to(device)
        m.load_state_dict(weights[net], strict=True)
    return ref


def _rows(b, lo, hi):
    return {k: v[lo:hi] for k, v in b.items()}


def steps(ref, batches, block: int, lr: float, beta1: float, precision: str = "fp32"):
    """Train ``ref`` one step on each batch -> {"metrics": [per step {name:
    float}], "grad": {leaf: norm of its first gradient}, "change": {leaf:
    norm of its change over the steps}}; leaves are ``net.name``."""
    g_side = [p for n in ref.G_NETS for p in ref.nets[n].parameters()]
    opt_g = torch.optim.Adam(g_side, lr=lr, betas=(beta1, 0.999), eps=1e-8)
    opt_d = torch.optim.Adam(ref.nets["D"].parameters(), lr=lr, betas=(beta1, 0.999), eps=1e-8)
    named = {f"{net}.{n}": p for net in (*ref.G_NETS, "D") for n, p in
             ref.nets[net].named_parameters()}
    start = {k: p.detach().clone() for k, p in named.items()}
    out = {"metrics": [], "grad": {}, "change": {}}
    with mode(precision):
        for i, b in enumerate(batches):
            full = ref.full(b)
            n = b["label"].shape[0]
            grads = {k: None for k in named}
            sums = {}
            for lo in range(0, n, block):
                loss_g, loss_d, metrics = ref.block_losses(_rows(b, lo, lo + block), full)
                for side, loss in (("G", loss_g), ("D", loss_d)):
                    keys = [k for k in named if (k.split(".")[0] == "D") == (side == "D")
                            and named[k].requires_grad]
                    gs = torch.autograd.grad(loss, [named[k] for k in keys], allow_unused=True,
                                             retain_graph=False)
                    for k, g in zip(keys, gs):
                        if g is not None:
                            grads[k] = g if grads[k] is None else grads[k] + g
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v.detach())
                del loss_g, loss_d, metrics
            for k, p in named.items():
                p.grad = grads[k]
            if i == 0:
                out["grad"] = {k: float(g.norm()) for k, g in grads.items() if g is not None}
            opt_g.step()
            opt_d.step()
            for p in named.values():
                p.grad = None
            out["metrics"].append(sums)
    out["change"] = {k: float((p.detach() - start[k]).norm()) for k, p in named.items()}
    return out

"""What every cell shares: the files found by name, the weights made from
the seed, the port's imports, the device's description and the readings of
the correctness check."""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile

import torch

from .reference import registry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "neurips18_hierchical_image_manipulation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "neurips18_hierchical_image_manipulation_tpu")
INIT_STD = 0.02      # pix2pixHD's weights_init: conv and linear weights ~ N(0, 0.02)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def named_file(kind: str, name: str, ext: str = ".json") -> str:
    """``port_bench/<kind>/<name><ext>``; raises if it is not there."""
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def port_module(sub: str):
    """A module of the port, ``<port>.<sub>``."""
    import importlib

    return importlib.import_module(f"{PORT}.{sub}")


def loaded_forbidden():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def seed_mix(seed: int, tag: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9) % 2**63


def make_weights(cfg, seed: int, device, train: bool = True, model=None):
    """{net: {name: tensor}} for the reference's networks of ``cfg``, made on
    ``device`` from ``seed``: every weight of two or more dimensions N(0,
    INIT_STD), drawn for a network in one call, every bias zero. ``model``:
    the model's module, by default the one that declares ``cfg["model"]``
    (``reference/registry.py``)."""
    with torch.device("meta"):
        ref = (model or registry.find(cfg["model"])).Reference(cfg, train)
    gen = torch.Generator(device).manual_seed(seed_mix(seed, 0x3E1))
    out = {}
    for net, m in ref.nets.items():
        named = list(m.named_parameters())
        mats = [(n, p.shape) for n, p in named if p.dim() >= 2]
        flat = torch.randn(sum(s.numel() for _, s in mats), generator=gen, device=device)
        flat.mul_(INIT_STD)
        sd = dict(zip([n for n, _ in mats],
                      (t.view(s) for t, (_, s) in zip(flat.split([s.numel() for _, s in mats]),
                                                       mats))))
        sd.update({n: torch.zeros(p.shape, device=device) for n, p in named if p.dim() < 2})
        out[net] = sd
    return out


def scratch_dir() -> str:
    """A new directory for this run's files under the run's TMPDIR."""
    return tempfile.mkdtemp(prefix="port_bench_", dir=tempfile.gettempdir())


def device_info(device, count: int):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quantile(values, q: float) -> float:
    """The q-quantile of all values (linear interpolation between order
    statistics)."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: the gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's} (a leaf
    the program lacks reads 0)."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves) if leaves else 0.0
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def worst(gaps: dict):
    """(the largest gap, its leaf); (nan, None) with no leaves."""
    if not gaps:
        return float("nan"), None
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _loss_gap(p, r):
    return abs(sum(p.values()) - sum(r.values())) / abs(sum(r.values()))


def train_readings(prog, ref):
    """-> (the training check's numbers, the leaves they come from).

    ``loss``: the first step's relative gap of the sum of its loss terms;
    ``loss_worst``: the worst step's. ``grad_worst``: the worst leaf's gap
    of the first gradient's norm (each leaf's gap over the larger of its
    reference norm and the median leaf's); ``grad``: the median leaf's.
    ``change``: the worst leaf's gap of the norm of the parameters' change
    over the checked steps, leaving out the leaves whose reference gradient
    is under a thousandth of the median leaf's (they move under Adam by
    round-off alone). A cell's limits name the numbers it compares."""
    steps = [_loss_gap(p, r) for p, r in zip(prog["metrics"], ref["metrics"])]
    g_leaves = list(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in g_leaves)
    moved = [k for k in g_leaves if ref["grad"][k] >= 1e-3 * med]
    grad_gaps = leaf_gaps(prog["grad"], ref["grad"], g_leaves)
    change, change_leaf = worst(leaf_gaps(prog["change"], ref["change"], moved))
    grad_worst, grad_leaf = worst(grad_gaps)
    return {"loss": steps[0], "loss_worst": max(steps), "grad": statistics.median(
        grad_gaps.values()), "grad_worst": grad_worst, "change": change}, {
        "grad_leaf": grad_leaf, "change_leaf": change_leaf,
        "left_out_of_change": sorted(set(g_leaves) - set(moved))}


def judge(readings: dict, limits: dict):
    """(correct, {name: [value, limit]}): correct when every number is
    finite and within its limit."""
    check = {k: [readings.get(k, float("nan")), limits[k]] for k in limits}
    ok = all(v == v and abs(v) != float("inf") and v <= lim for v, lim in check.values())
    return ok, check

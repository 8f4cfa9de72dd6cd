"""The flagship train step's time on the card under two trees of the port
(the pool repair of ROADMAP §C.12 against its parent), in one process.

    python reports/torch_r14/pool_cost.py --old DIR --new DIR --out FILE [--gpu_ids 0]

Each tree's port package (a checkout, or a ``git archive`` of another
commit unpacked into a git-ignored directory) is imported under a name of
its own (its imports are package-relative; each builds its own kernels),
so both run in one session on one card. For each (dtype, batch) of CASES:
``make_train_step`` on the flagship (label_nc 35, ngf 64, 4 downs, 9
resblocks, the 2-scale 3-layer D, VGG19) at 512x256 from seed 0 under each
tree, a synthetic batch, WARMUP steps each, then ROUNDS rounds of old,
new, new, old, each ITERS steps timed by the host clock after a sync on
each side (``train/profiler.measure_steps``). JSON to ``--out``: every
reading, the means, new / old - 1, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

PKG = "neurips18_hierchical_image_manipulation_tpu_torch"
CASES = (("float32", 1, 20), ("float32", 4, 8), ("bfloat16", 1, 40), ("bfloat16", 4, 30),
         ("bfloat16", 32, 8))   # (dtype, batch, steps a reading)
WARMUP = 3
ROUNDS = 2
HW = (256, 512)


def load_tree(root, alias):
    """The port package under ``root`` as module ``alias``; -> a function
    importing its submodules by name."""
    pkg_dir = os.path.join(os.path.abspath(root), PKG)
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return lambda name: importlib.import_module(f"{alias}.{name}")


def build(sub, dtype, bs, gpu_ids):
    """(the step as a no-argument call, the device) of the flagship under
    one tree."""
    import numpy as np
    import torch

    rs = sub("tools.roofline_step")
    opt = sub("configs.options").MaskToImageTrainOptions(gpu_ids=gpu_ids, batchSize=bs,
                                                         dtype=dtype, **rs.FLAGSHIP)
    model = sub("models.factory").create_model(opt)
    batch = sub("data.synthetic").synthetic_batch(np.random.RandomState(0), bs, hw=HW,
                                                  label_nc=opt.label_nc)
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    step = sub("train.steps").make_train_step(model,
                                              torch.bfloat16 if dtype == "bfloat16" else None)
    state = sub("train.state").make_optimizers(opt, model, 1000)
    return (lambda: step(state, batch)), model.device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", required=True)
    p.add_argument("--new", required=True)
    p.add_argument("--gpu_ids", default="0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    trees = {"old": load_tree(args.old, "himan_old"), "new": load_tree(args.new, "himan_new")}
    profiler = trees["new"]("train.profiler")
    rows = []
    for dtype, bs, iters in CASES:
        steps = {}
        for tag, sub in trees.items():
            fn, dev = build(sub, dtype, bs, args.gpu_ids)
            for _ in range(WARMUP):
                fn()
            steps[tag] = fn
        ms = {"old": [], "new": []}
        for _ in range(ROUNDS):
            for tag in ("old", "new", "new", "old"):   # both trees' models: one tier
                ms[tag].append(1e3 * profiler.measure_steps(
                    lambda s, b, fn=steps[tag]: fn(), None, None, iters, dev))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        row = {"dtype": dtype, "bs": bs, "iters": iters, "ms_per_step": ms,
               "mean_ms": mean, "new_over_old_minus_1": mean["new"] / mean["old"] - 1}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del steps
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rs = trees["new"]("tools.roofline_step")
    report = {"device": rs.device_line(dev), "old": args.old, "new": args.new,
              "hw": list(HW), "rounds": ROUNDS, "rows": rows}
    rs.write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()

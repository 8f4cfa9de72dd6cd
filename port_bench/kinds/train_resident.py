"""Traffic kind ``train_resident``: the port's fused resident train step.

The port's train options over a dataroot of the seed's scenes under
``--device_resident_data`` give ``data.loader.CreateDataLoader`` a
``DeviceResidentBboxLoader``; ``models.factory.create_model`` builds the
model and the weights made from the seed are loaded into it;
``train.steps.make_resident_train_step`` over ``loader.fused_sampler()``
is the step that ``train/loop.py``'s fused path calls, and the window calls
it back to back.

Set-up drives that step object from the seed through its first
``check_steps`` steps (their losses, the first gradient from G's and D's
Adam moments, the parameters' change after them), then ``warmup_steps``
more. After the window, with the program's state freed, the reference
trains from the same weights on the batches of the same records, and the
two are compared.

Traffic parameters: ``dtype``, ``batch``, ``scenes``, ``check_steps``,
``warmup_steps``, ``trace_steps``, ``ref_block`` (rows a reference block).
"""

from __future__ import annotations

import gc
import os

import torch

from .. import common, flops
from ..scenes import make_scenes, write_dataroot
from ..reference import data as rdata
from ..reference import train as rtrain


def _options(ctx, root):
    cfg, tr = ctx.cfg, ctx.traffic
    options = common.port_module("configs.options")
    argv = ["--gpu_ids", "0" if ctx.device.type == "cuda" else "-1",
            "--dataroot", root, "--checkpoints_dir", os.path.join(root, "checkpoints"),
            "--name", "port_bench", "--batchSize", str(tr["batch"]), "--dtype", tr["dtype"],
            "--device_resident_data", "--seed", str(ctx.seed % 2**32), "--nThreads", "1"]
    for k, v in cfg["options"].items():
        argv += [f"--{k}", str(v)]
    return options.parse_cli(getattr(options, cfg["train_options"]), argv)


def _adam_first_grads(model, state, beta1):
    """{net.name: norm} of the first gradient, from Adam's first moment
    after one step (exp_avg = (1 - beta1) * g)."""
    out = {}
    for net, opt in (("G", state.opt_g), ("D", state.opt_d)):
        for n, p in model.nets()[net].named_parameters():
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out[f"{net}.{n}"] = float(st["exp_avg"].float().norm()) / (1.0 - beta1)
    return out


def _changes(model, start):
    return {f"{net}.{n}": float((p.detach().float() - start[net][n]).norm())
            for net in ("G", "D") for n, p in model.nets()[net].named_parameters()}


def run(ctx):
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    bs = tr["batch"]
    root = common.scratch_dir()
    ctx.cleanup.append(root)
    scenes = ctx.timed("scenes", lambda: make_scenes(cfg, ctx.seed, tr["scenes"]))
    ctx.timed("dataroot", lambda: write_dataroot(root, scenes, "train"))
    opt = _options(ctx, root)
    loader_mod = common.port_module("data.loader")
    factory = common.port_module("models.factory")
    steps_mod = common.port_module("train.steps")
    state_mod = common.port_module("train.state")
    loader = ctx.timed("loader", lambda: loader_mod.CreateDataLoader(opt))
    model = ctx.timed("model", lambda: factory.create_model(opt))

    def load():
        w = common.make_weights(cfg, ctx.seed, dev, train=True, model=ctx.model)
        for net, m in model.nets().items():
            m.load_state_dict(w[net], strict=True)
        return w

    weights = ctx.timed("weights", load)
    sample_fn, data = loader.fused_sampler()
    drawn = []

    def sample(d, idx, gen):
        if ctx.recording:
            drawn.append(idx)
        return ctx.fault.batch(sample_fn(d, idx, gen))

    state = state_mod.make_optimizers(opt, model, max(len(loader), 1))
    ctx.fault.state(state)
    cdt = torch.bfloat16 if tr["dtype"] == "bfloat16" else None
    step, _ = steps_mod.make_resident_train_step(model, sample, loader.n_samples, bs, cdt,
                                                 shuffle=True, seed=opt.seed)

    def check_steps():
        prog = {"metrics": []}
        ctx.recording = True
        for i in range(tr["check_steps"]):
            metrics, _ = step(state, data)
            prog["metrics"].append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                prog["grad"] = _adam_first_grads(model, state, opt.beta1)
        ctx.recording = False
        prog["change"] = _changes(model, weights)
        return prog

    prog = ctx.timed("check_steps", check_steps)
    idx = [i.tolist() for i in drawn]
    del weights, drawn

    def warm():
        for _ in range(tr["warmup_steps"]):
            step(state, data)
        common.sync(dev)

    ctx.timed("warmup", warm)
    launches = ctx.launch_counter()
    n, elapsed = ctx.window(lambda: step(state, data))
    per_step = ctx.launches_since(launches, n)
    trace = None
    if ctx.trace:
        trace = ctx.profile(lambda: step(state, data), tr["trace_steps"])
    ctx.close_window(calls=n, per_call=per_step, seconds=elapsed)
    ctx.metrics["train_samples_per_s"] = n * bs / elapsed
    hw = (cfg["options"]["fineSize"],) * 2
    ctx.reading(kind="train", trace=trace, step_s=elapsed / n, calls=n,
                work=flops.train_step(cfg, bs, hw, 2 if tr["dtype"] == "bfloat16" else 4,
                                      model=ctx.model),
                tier=tr["dtype"])
    ctx.attempted, ctx.failed = n, 0

    del step, state, model, loader, data, sample_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.log("check: reference")
    ctx.check = {"idx": idx, "scenes": scenes, "program": prog,
                 "reference": reference(ctx, idx, scenes)}
    ctx.log("check: done")
    ctx.readings, ctx.extra["check_info"] = common.train_readings(prog, ctx.check["reference"])


def reference(ctx, idx, scenes, precision="fp32"):
    """The reference's readings over the same weights and records."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    o = cfg["options"]
    recs = rdata.records(scenes["inst"], o.get("min_box_size", 16))
    batches = [rdata.batch(scenes, recs, rows, o["fineSize"], o["contextMargin"], dev)
               for rows in idx]
    ref = rtrain.build(cfg, True, dev,
                       common.make_weights(cfg, ctx.seed, dev, train=True, model=ctx.model),
                       model=ctx.model)
    return rtrain.steps(ref, batches, tr["ref_block"], cfg["lr"], cfg["beta1"], precision)

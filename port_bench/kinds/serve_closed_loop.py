"""Traffic kind ``serve_closed_loop``: the port's mask2image serving forward,
``Pix2PixHDModel.inference`` (the encode, then G), one request at a time.

Requests are the context windows of the seed's scenes (the first ``pool``
object records, cycled): label and instance ids, RGB and the object box, as
host arrays. ``clients`` (1) client sends the next request when the last
one's image is back on the host. A request's latency runs from handing its
host arrays over to holding its output image on the host; ``serve_ms_p50``
and ``serve_ms_p95`` are over every request of the window.

The check: ``check_requests`` requests drawn from the seed among the first
``check_of`` of the window keep their images; after the window the
reference generates each and ``image`` is the largest absolute difference.

Traffic parameters: ``dtype``, ``batch`` (1), ``clients`` (1), ``scenes``,
``pool``, ``warmup_requests``, ``trace_requests``, ``check_requests``,
``check_of``.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import common, flops
from ..reference import data as rdata
from ..reference import train as rtrain
from ..reference.precision import mode
from ..scenes import make_scenes

KEYS = ("label", "inst", "image", "boxes")


def _options(ctx, root):
    cfg = ctx.cfg
    options = common.port_module("configs.options")
    argv = ["--gpu_ids", "0" if ctx.device.type == "cuda" else "-1",
            "--checkpoints_dir", os.path.join(root, "checkpoints"), "--name", "port_bench",
            "--dtype", ctx.traffic["dtype"], "--seed", str(ctx.seed % 2**32)]
    for k, v in cfg["options"].items():
        argv += [f"--{k}", str(v)]
    return options.parse_cli(getattr(options, cfg["test_options"]), argv)


def requests(ctx, scenes):
    """The pool of requests: [{key: (1, ...) host array}], the program's
    ``KEYS`` and the box mask the reference reads."""
    o = ctx.cfg["options"]
    recs = rdata.records(scenes["inst"], o.get("min_box_size", 16))[: ctx.traffic["pool"]]
    out = []
    for r in recs:
        c = rdata.crop(scenes, r, o["fineSize"], o["contextMargin"])
        out.append({k: np.ascontiguousarray(c[k][None]) for k in KEYS + ("boxmask",)})
    return out


def run(ctx):
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    if tr["batch"] != 1 or tr["clients"] != 1:
        raise ValueError("serve_closed_loop serves one client at batch 1")
    root = common.scratch_dir()
    ctx.cleanup.append(root)
    scenes = ctx.timed("scenes", lambda: make_scenes(cfg, ctx.seed, tr["scenes"]))
    pool = ctx.timed("requests", lambda: requests(ctx, scenes))
    opt = _options(ctx, root)
    factory = common.port_module("models.factory")
    model = ctx.timed("model", lambda: factory.create_model(opt))
    ctx.timed("weights", lambda: model.netG.load_state_dict(
        common.make_weights(cfg, ctx.seed, dev, train=False, model=ctx.model)["G"], strict=True))
    rng = np.random.RandomState([ctx.seed & 0xFFFFFFFF, ctx.seed >> 32, 0x5E7])
    keep = set(rng.choice(tr["check_of"], tr["check_requests"], replace=False).tolist())
    kept, lat, count = {}, [], [0]

    def serve():
        i = count[0]
        req = pool[i % len(pool)]
        t0 = time.perf_counter()
        out = model.inference({k: torch.from_numpy(req[k]).to(dev) for k in KEYS})
        img = ctx.fault.output(out).to(torch.float32).cpu().numpy()
        lat.append(time.perf_counter() - t0)
        if ctx.recording and i in keep:
            kept[i] = img
        count[0] += 1

    def warm():
        for _ in range(tr["warmup_requests"]):
            serve()

    ctx.timed("warmup", warm)
    count[0], lat[:] = 0, []
    ctx.recording = True
    launches = ctx.launch_counter()
    n, elapsed = ctx.window(serve)
    ctx.recording = False
    per_req = ctx.launches_since(launches, n)
    window_lat = list(lat)
    trace = ctx.profile(serve, tr["trace_requests"]) if ctx.trace else None
    ctx.close_window(calls=n, per_call=per_req, seconds=elapsed)
    ctx.metrics["serve_ms_p50"] = 1e3 * common.quantile(window_lat, 0.50)
    ctx.metrics["serve_ms_p95"] = 1e3 * common.quantile(window_lat, 0.95)
    hw = (cfg["options"]["fineSize"],) * 2
    ctx.reading(kind="serve", trace=trace, calls=n, step_s=elapsed / n,
                work={"g_forward": flops.g_forward(cfg, 1, hw, model=ctx.model)}, tier=tr["dtype"])
    ctx.attempted, ctx.failed = n, 0
    ctx.extra["requests_checked"] = len(kept)

    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.log("check: reference")
    ctx.check = {"pool": pool, "kept": kept, "reference": reference(ctx, pool, kept)}
    ctx.log("check: done")
    ctx.readings = {"image": image_gap(kept, ctx.check["reference"])}


def reference(ctx, pool, kept, precision="fp32"):
    """{request: the reference's image} of the kept requests."""
    ref = rtrain.build(ctx.cfg, False, ctx.device,
                       common.make_weights(ctx.cfg, ctx.seed, ctx.device, train=False,
                                           model=ctx.model), model=ctx.model)
    out = {}
    with torch.no_grad(), mode(precision):
        for i in kept:
            b = {k: torch.from_numpy(v).to(ctx.device) for k, v in pool[i % len(pool)].items()}
            out[i] = ref.generate(b).cpu().numpy()
    return out


def image_gap(kept, ref):
    """The largest absolute difference of a kept image from the
    reference's; inf when no request was kept."""
    if not kept:
        return float("inf")
    return max(float(np.abs(ref[i] - img).max()) for i, img in kept.items())


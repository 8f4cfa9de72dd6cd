"""Attribute the flagship train step's CUDA kernels to source sites.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.trace_attrib \\
        [TRACE_DIR] [TOP] [--dtype bfloat16|float32] [--bs 32] [--steps 3] [--out FILE]

Counterpart of ``tools/trace_attrib.py`` in the JAX package, which summed a
TPU trace's device events by their HLO ``source`` line. Here a site is the
``nn.Module`` path under the network's name (``G.res3.conv1``,
``D.scale1.layer2``, ``VGG.conv4_1``) and the operation that launched the
kernel: the outermost aten op inside the module (``aten::convolution``),
the autograd node of a backward kernel (``ConvolutionBackward0``,
``_InstanceNormActBackward``), or the port kernel's own name
(``in_fwd_cluster_kernel``), since the port's kernels launch through
``ctypes`` and no aten op encloses them.

The tool runs the step (``tools/roofline_step.flagship``: BASELINE.json
config 3 at ``--bs``/``--dtype``) with a ``torch.profiler`` trace of
``--steps`` steps written under TRACE_DIR. Only while it profiles are the
networks' modules wrapped in ``record_function`` ranges (forward hooks the
tool installs and removes; the kernel wrappers are never wrapped). Each
kernel is attributed by its launch (``cudaLaunchKernel`` or
``cuLaunchKernel``, joined by the correlation id): the innermost module
range enclosing the launch on its thread; a backward kernel, whose thread
runs no module range, through the profiler's autograd sequence number: the
``evaluate_function`` node enclosing its launch names the forward op of the
same sequence number (the last forward op to record it: ops that create no
node record the number the next node takes), and the module range
enclosing that op is the site.

A kernel launched outside every module range is sited by the innermost
range around its launch: the port's spans (``train/profiler.span``:
``himan.step.sample``, ``himan.step.cast``, ``himan.step.optimizer``, the
loss terms inside ``himan.step.forward``, ...) or a library's own
(``Optimizer.step#Adam.step``), and ``(top)`` only outside all of them. A
backward kernel whose forward op ran outside every module range is sited
by the innermost span around that op, as ``<span> (backward)`` (the cast's
backward: ``himan.step.cast (backward)``), and ``(backward)`` only where
none encloses it.

Per site: device ms a step, its share, its class (``profile_decode``),
kernels a step, TFLOP/s from ``roofline_step``'s true-MAC FLOPs of the
module's convolutions, and GB/s from its forward non-conv bytes. Beside it
the device time by class and every unclassified kernel by name. JSON to
``--out`` (default under ``reports/torch_r13/``), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import bisect
import os
from collections import defaultdict

from . import profile_decode
from . import roofline_step as rs

MODULE = "module: "
SPAN = "himan."     # the port's spans (train/profiler.span)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")


class _Intervals:
    """Complete events of one thread, for 'which enclose time t' queries."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def enclosing(self, t):
        """Events whose [ts, ts + dur] holds t, outermost first."""
        i = bisect.bisect_right(self.starts, t)
        out = [e for e in self.ev[:i] if e["ts"] + e.get("dur", 0.0) >= t]
        return sorted(out, key=lambda e: (e["ts"], -e.get("dur", 0.0)))


def _op_in(frames, start_ts):
    """The outermost cpu op among frames that starts at or after start_ts."""
    for e in frames:
        if e.get("cat") == "cpu_op" and e["ts"] >= start_ts:
            return e
    return None


def _node_name(e):
    return e["name"].split(": ", 1)[1] if ": " in e["name"] else e["name"]


def attribute(events, steps=1, unmatched=None):
    """[(site, kernel name, ms a step)] for every kernel of a Chrome trace's
    events (see the module docstring). ``unmatched``, a dict, collects the
    backward nodes whose forward op or module was not found."""
    host = defaultdict(list)
    launch = {}
    fwd_by_seq = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("cpu_op", "user_annotation"):
            host[e["tid"]].append(e)
            seq = args.get("Sequence number")
            if (cat == "cpu_op" and seq is not None and not args.get("Fwd thread id")
                    and not e["name"].startswith("autograd::")):
                # ops that create no node record the sequence number the next
                # node will take: the node's op is the last to record it
                prev = fwd_by_seq.get(seq)
                if prev is None or e["ts"] > prev["ts"]:
                    fwd_by_seq[seq] = e
        elif cat in ("cuda_runtime", "cuda_driver") and e["name"] in LAUNCHES:
            launch[args.get("correlation")] = e
    threads = {tid: _Intervals(evs) for tid, evs in host.items()}

    def innermost(frames, prefix=MODULE):
        """The innermost range among frames named ``prefix...``."""
        found = [f for f in frames if f.get("cat") == "user_annotation"
                 and f["name"].startswith(prefix)]
        return found[-1] if found else None

    out = []
    for k in profile_decode.kernel_events(events):
        ms = float(k.get("dur", 0.0)) / 1e3 / steps
        name = k.get("name", "?")
        port = profile_decode.kernel_kind(name) == "port kernels"
        la = launch.get((k.get("args") or {}).get("correlation"))
        if la is None or la["tid"] not in threads:
            out.append(("(no launch)", name, ms))
            continue
        frames = threads[la["tid"]].enclosing(la["ts"])
        mod = innermost(frames)
        if mod is not None:
            op = _op_in(frames, mod["ts"])
            tag = profile_decode.kernel_tag(name) if port or op is None else op["name"]
            out.append((f"{mod['name'][len(MODULE):]} [{tag}]", name, ms))
            continue
        nodes = [f for f in frames if f["name"].startswith("autograd::engine::evaluate_function")]
        if nodes:
            node = nodes[-1]
            seq = (node.get("args") or {}).get("Sequence number")
            fwd = fwd_by_seq.get(seq)
            where, fmod = "(backward)", None
            if fwd is not None:
                fframes = threads[fwd["tid"]].enclosing(fwd["ts"])
                fmod, fspan = innermost(fframes), innermost(fframes, SPAN)
                if fmod is not None:
                    where = fmod["name"][len(MODULE):]
                elif fspan is not None:
                    where = f"{fspan['name']} (backward)"
            if fmod is None and unmatched is not None:
                key = (_node_name(node), fwd["name"] if fwd is not None else None)
                unmatched[key] = unmatched.get(key, 0.0) + ms
            tag = profile_decode.kernel_tag(name) if port else _node_name(node)
            out.append((f"{where} [{tag}]", name, ms))
            continue
        annos = [f for f in frames if f.get("cat") == "user_annotation"]
        op = _op_in(frames, frames[0]["ts"]) if frames else None
        where = annos[-1]["name"] if annos else "(top)"
        tag = profile_decode.kernel_tag(name) if port or op is None else op["name"]
        out.append((f"{where} [{tag}]", name, ms))
    return out


def _module_of(site):
    return site.rsplit(" [", 1)[0]


def site_rows(attributed, flops_by_site=None, bytes_by_site=None, steps=1, top=None):
    """Per site: ms a step, share, class, kernels a step, TFLOP/s, GB/s."""
    flops_by_site, bytes_by_site = flops_by_site or {}, bytes_by_site or {}
    agg = defaultdict(lambda: [0.0, defaultdict(float), 0])
    names = defaultdict(lambda: defaultdict(float))
    for site, name, ms in attributed:
        a = agg[site]
        a[0] += ms
        a[1][profile_decode.kernel_kind(name)] += ms
        a[2] += 1
        names[site][profile_decode.kernel_tag(name)[:80]] += ms
    total = sum(a[0] for a in agg.values()) or 1.0
    # GB/s of a module's forward non-conv time against its forward bytes
    nonconv_ms = defaultdict(float)
    for site, (ms, kinds, _) in agg.items():
        if "Backward" not in site and "(backward)" not in site:
            nonconv_ms[_module_of(site)] += sum(v for k, v in kinds.items()
                                                if not profile_decode.is_conv(k))
    rows = []
    for site, (ms, kinds, n) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        mod, op = _module_of(site), site.rsplit(" [", 1)[-1].rstrip("]")
        cls = max(kinds.items(), key=lambda kv: kv[1])[0]
        if op == "aten::convolution":
            fl = flops_by_site.get(f"{mod} [fwd]")
        elif op == "ConvolutionBackward0":
            fl = (flops_by_site.get(f"{mod} [dgrad]", 0.0)
                  + flops_by_site.get(f"{mod} [wgrad]", 0.0)) or None
        else:
            fl = None
        nb = bytes_by_site.get(mod) if not profile_decode.is_conv(cls) else None
        rows.append({
            "site": site, "ms_per_step": ms, "pct": 100 * ms / total, "class": cls,
            "n_per_step": n // steps,
            "kernels": dict(sorted(names[site].items(), key=lambda kv: -kv[1])[:3]),
            "tflops": fl / (ms * 1e-3) / 1e12 if fl and ms else None,
            "gbs": (nb / (nonconv_ms[mod] * 1e-3) / 1e9
                    if nb and nonconv_ms.get(mod) and "Backward" not in site else None),
        })
    return rows[:top] if top else rows


def profile_step(model, step, state, batch, trace_dir, steps=3, flops_by_site=None,
                 bytes_by_site=None):
    """Profile ``steps`` steps (after one warm-up step) with the module
    ranges on; write the Chrome trace under ``trace_dir`` -> the report
    (sites, classes, the unclassified kernels)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    device = model.device
    step(state, batch)
    rs.sync(device)
    ranges = []

    def enter(p):
        r = record_function(MODULE + p)
        r.__enter__()
        ranges.append(r)

    def leave(p):
        ranges.pop().__exit__(None, None, None)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with rs.module_hooks(model, enter, leave), profile(activities=acts) as prof:
        for _ in range(steps):
            step(state, batch)
        rs.sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"step_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    events = profile_decode.load_trace(path)
    report = profile_decode.decode(events, steps, top=None)
    unmatched = {}
    attributed = attribute(events, steps, unmatched)
    rows = site_rows(attributed, flops_by_site, bytes_by_site, steps)
    report.update(trace=path, rows=rows,
                  unattributed_ms_per_step=sum(ms for s, _, ms in attributed
                                               if s.startswith("(no launch)")),
                  backward_unmatched=[{"node": k[0], "forward_op": k[1], "ms_per_step": v}
                                      for k, v in sorted(unmatched.items(),
                                                         key=lambda kv: -kv[1])])
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace_dir", nargs="?", default=rs.TRACE_DIR)
    p.add_argument("top", nargs="?", type=int, default=40)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "trace_attrib.json"))
    rs.add_config_args(p)
    args = p.parse_args(argv)
    rs.device_of(args.gpu_ids)
    opt, model, batch, cdt = rs.flagship(args)
    doc = rs.collect(opt, model, batch, cdt)
    step, state = rs.make_step(opt, model, cdt)
    report = profile_step(model, step, state, batch, args.trace_dir, args.steps,
                          {k: v["flops"] for k, v in doc["sites"].items()},
                          {k: v["bytes"] for k, v in doc["sites"].items()})
    report["measured_step_ms"] = 1e3 * rs.measure_steps(step, state, batch, 5, model.device)
    report.update(device=rs.device_line(model.device), config=doc["config"],
                  rows=report["rows"][:args.top])
    rs.write_json(args.out, report)
    total = report["device_ms_per_step"]
    print(f"steps={args.steps}  total_device={total:.2f} ms/step  "
          f"unclassified {report['unclassified_pct']:.2f} %")
    print(f"{'ms/step':>9} {'%':>5} {'TFLOP/s':>8} {'GB/s':>7} {'n':>4}  site")
    for r in report["rows"]:
        print(f"{r['ms_per_step']:9.3f} {r['pct']:5.1f} {r['tflops'] or 0:8.1f} "
              f"{r['gbs'] or 0:7.0f} {r['n_per_step']:4d}  {r['site'][:110]}")
    for r in report["unclassified_kernels"]:
        print(f"unclassified {r['ms_per_step']:9.4f} ms  {r['name'][:150]}")
    return report


if __name__ == "__main__":
    main()

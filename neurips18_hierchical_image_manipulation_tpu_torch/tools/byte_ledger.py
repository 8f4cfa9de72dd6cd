"""Per-tensor byte ledger of the flagship train step.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.byte_ledger \\
        --saved [--remat] [--remat_policy none|block|conv_out] [--trace DIR] [--out FILE]

Counterpart of ``tools/byte_ledger.py`` in the JAX package, over the same
config (``tools/roofline_step.flagship``: BASELINE.json config 3, bs 32,
512x256, bf16 over fp32 masters, VGG + FM, masked RGB). Two views:

``--saved``: ``torch.autograd.graph.saved_tensors_hooks`` held over the
  flagship objective (``Pix2PixHDModel.losses`` as the bf16 train step
  calls it) ledger every tensor the backward keeps: its shape and dtype,
  the ``nn.Module`` that saved it (forward hooks the tool installs), and
  whether it is an argument (a parameter or a batch tensor) or an
  activation. Tensors are deduplicated by storage: the views of one buffer
  count once, at the buffer's size. The dtype column is the fp32-straggler
  audit of the bf16 tier (every activation should be bf16). ``--remat`` /
  ``--remat_policy`` build the generator with the port's resblock
  recomputation (``models/networks.remat_policy``).

``--trace DIR``: the non-conv device time of the step by kernel, from the
  newest ``torch.profiler`` trace under DIR (``tools/trace_attrib.py``
  writes one, ``--steps`` steps), beside ``roofline_step``'s byte
  reckoning of the same step (``--specs``; collected on the device when
  the file is missing): the bytes of each aten op and of each port kernel,
  and GB/s where a port kernel's time and bytes meet.

JSON to ``--out`` (default ``reports/torch_r13/byte_ledger.json``), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import torch

from ..train.steps import _loss_inputs
from . import profile_decode
from . import roofline_step as rs

# port kernel name prefixes -> the wrapper whose bytes roofline_step reckons
PORT_KERNELS = (("in_fwd_", "instance_norm"), ("in_bwd_", "instance_norm_bwd"),
                ("reflect_pad_fwd_", "reflect_pad_fwd"), ("reflect_pad_bwd_", "reflect_pad_bwd"),
                ("loss_group_kernel_bwd", "loss_group_bwd"), ("loss_group_kernel", "reduce_group"),
                ("encode_kernel", "encode"))


def saved_ledger(args):
    """The ``saved_residuals`` counterpart: every tensor the backward of
    the flagship objective keeps, deduplicated by storage."""
    opt, model, batch, cdt = rs.flagship(args, remat=args.remat,
                                         remat_policy=args.remat_policy or "none")
    params, b = _loss_inputs(model, batch, cdt)
    arg_ptrs = {t.untyped_storage().data_ptr()
                for t in [*(p for m in model.nets().values() for p in m.parameters()),
                          *batch.values()] if torch.is_tensor(t)}
    stack, storages, packs = [], {}, [0]

    def pack(t):
        packs[0] += 1
        st = t.untyped_storage()
        key = (st.data_ptr(), str(t.device))
        if key not in storages:
            storages[key] = dict(
                site=stack[-1] if stack else "(top)", dtype=str(t.dtype).replace("torch.", ""),
                kind="argument" if st.data_ptr() in arg_ptrs else "activation",
                shape=list(t.shape), nbytes=st.nbytes())
        return t

    with rs.module_hooks(model, stack.append, lambda p: stack.pop()), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total = model.losses(b, params)[0]
    del total
    rows = {}
    for s in storages.values():
        r = rows.setdefault((s["site"], s["dtype"], s["kind"]), {
            "site": s["site"], "dtype": s["dtype"], "kind": s["kind"], "count": 0,
            "mb": 0.0, "example_shape": s["shape"]})
        r["count"] += 1
        r["mb"] += s["nbytes"] / 1e6
    out = sorted(rows.values(), key=lambda r: -r["mb"])
    act = [r for r in out if r["kind"] == "activation"]
    return {
        "config": f"flagship bs{args.bs} {rs.SMOKE_HW if args.smoke else rs.HW} "
                  f"{args.dtype} VGG+FM",
        "remat": bool(args.remat),
        "remat_policy": args.remat_policy or "none",
        "n_residuals": packs[0],
        "n_storages": len(storages),
        "total_mb": sum(s["nbytes"] for s in storages.values()) / 1e6,
        "activation_mb_total": sum(r["mb"] for r in act),
        "activation_mb_fp32": sum(r["mb"] for r in act if r["dtype"] == "float32"),
        "argument_mb_total": sum(r["mb"] for r in out if r["kind"] == "argument"),
        "note": "every tensor the backward keeps, by storage (views of one buffer count "
                "once, at the buffer's size); activation rows are what recomputation can "
                "trade; fp32 activation rows are the bf16 tier's dtype-audit targets",
        "rows": [r for r in out if r["mb"] > 1.0 or r["dtype"] == "float32"],
        "all_rows_mb": sum(r["mb"] for r in out),
    }


def _port_wrapper(name):
    for prefix, wrapper in PORT_KERNELS:
        if prefix in name:
            return wrapper
    return None


def trace_ledger(trace_dir, doc, steps):
    """Non-conv device time by kernel from the trace; bytes from the
    reckoning (``doc``: a ``roofline_step.collect`` document)."""
    events = profile_decode.load_trace(trace_dir)
    groups = {}
    for e in profile_decode.kernel_events(events):
        kind = profile_decode.kernel_kind(e["name"])
        if profile_decode.is_conv(kind):
            continue
        key = profile_decode.kernel_tag(e["name"])[:160]
        g = groups.setdefault(key, {"kernel": key, "class": kind, "count": 0, "ms": 0.0})
        g["count"] += 1
        g["ms"] += float(e.get("dur", 0.0)) / 1e3
    port_ms = defaultdict(float)
    for g in groups.values():
        g["ms"] /= steps
        g["count"] //= steps
        w = _port_wrapper(g["kernel"])
        if w is not None:
            port_ms[w] += g["ms"]
    port = [{"wrapper": w, "gb": nb / 1e9, "ms": port_ms.get(w, 0.0),
             "gbs": nb / 1e9 / (port_ms[w] * 1e-3) if port_ms.get(w) else None}
            for w, nb in sorted(doc["port_kernel_bytes"].items(), key=lambda kv: -kv[1])]
    rows = sorted(groups.values(), key=lambda g: -g["ms"])
    return {
        "trace": profile_decode.newest_trace(trace_dir),
        "steps_in_trace": steps,
        "nonconv_ms_per_step": sum(g["ms"] for g in rows),
        "nonconv_gb_per_step": doc["nonconv_bytes"] / 1e9,
        "aten_gb_per_step": doc["aten_bytes"] / 1e9,
        "note": "device ms by kernel from the trace; bytes from roofline_step's "
                "reckoning: every distinct tensor an aten op reads or writes, once, "
                "and the port kernels' bytes from their wrappers' arguments",
        "port_kernels": port,
        "aten_ops_gb": [{"op": k, "gb": v / 1e9} for k, v in list(doc["op_bytes"].items())[:40]],
        "rows": rows[:40],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--saved", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat_policy", default=None)
    p.add_argument("--trace", default=None)
    p.add_argument("--steps", type=int, default=3, help="steps the trace holds")
    p.add_argument("--specs", default=rs.SPECS, help="roofline_step's --specs document")
    p.add_argument("--out", default=os.path.join(rs.REPORTS, "byte_ledger.json"))
    rs.add_config_args(p)
    args = p.parse_args(argv)
    device = rs.device_of(args.gpu_ids)
    report = {"device": rs.device_line(device)}
    if args.saved:
        report["saved_residuals"] = saved_ledger(args)
    if args.trace:
        if os.path.exists(args.specs):
            with open(args.specs) as f:
                doc = json.load(f)
        else:
            doc = rs.collect(*rs.flagship(args))
            rs.write_json(args.specs, doc)
        report["trace_nonconv"] = trace_ledger(args.trace, doc, args.steps)
    rs.write_json(args.out, report)
    for sec in ("saved_residuals", "trace_nonconv"):
        if sec in report:
            print(sec, json.dumps({k: v for k, v in report[sec].items()
                                   if k not in ("rows", "port_kernels", "aten_ops_gb")},
                                  indent=1))
            for r in report[sec]["rows"][:15]:
                print("  ", r)
    return report


if __name__ == "__main__":
    main()

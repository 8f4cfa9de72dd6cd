"""The readings that the limits of a cell's correctness check are set from.

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,... \\
        [--control_seeds 1,2,3] [--faults unchanged,half_batch] [--seconds 2] [--out FILE]

For each of ``--seeds``, one run of the cell (a short window, the check as a
run makes it) gives the program's readings: the lower readings. For each of
``--control_seeds`` the control, the reference computed one precision below
the cell's (bf16 cells: fp8 convolution operands; fp32 cells: TF32), is put
in the program's place and read against the fp32 reference by the same
comparison: the upper readings. Each of ``--faults`` is planted under the
timed path (``faults.py``) on the control seeds and read the same way. Runs
in one process on the card, like the benchmark; the benchmark's own runs
never run it. JSON to ``--out`` and standard output: every reading, and per
number the largest sound reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import common  # noqa: E402
from port_bench.kinds import serve_closed_loop, train_resident  # noqa: E402
from port_bench.run import execute  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def control_readings(run, raw=None):
    """The control in the program's place, read against the reference;
    ``raw`` (a dict) takes what they were read from."""
    precision = CONTROL[run.traffic["dtype"]]
    chk = run.check
    if run.traffic["kind"] == "train_resident":
        ctl = train_resident.reference(run, chk["idx"], chk["scenes"], precision)
        readings, info = common.train_readings(ctl, chk["reference"])
        if raw is not None:
            raw.update(info=info, control=ctl)
        return readings
    ctl = serve_closed_loop.reference(run, chk["pool"], chk["kept"], precision)
    return {"image": serve_closed_loop.image_gap(ctl, chk["reference"])}


def one(workload, seed, seconds, fault="none", control=False, **kw):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", "0"]
    res, run = execute(argv, fault=fault, **kw)
    row = {"seed": seed, "fault": fault, "readings": run.readings,
           "correct": res["correct"], "metrics": res["metrics"],
           "info": run.extra.get("check_info")}
    if run.traffic["kind"] == "train_resident":
        row["raw"] = {"program": run.check["program"], "reference": run.check["reference"]}
    if control:
        raw = {}
        row["control"] = control_readings(run, raw)
        row["control_info"] = raw.get("info")
        if "control" in raw:
            row["raw"]["control"] = raw["control"]
    del run
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    print(json.dumps(row), file=sys.stderr, flush=True)
    return row


def summarize(rows):
    sound = [r["readings"] for r in rows if r["fault"] == "none"]
    ctl = [r["control"] for r in rows if "control" in r]
    keys = sorted(sound[0]) if sound else []
    out = {"lower": {k: max(s[k] for s in sound) for k in keys}}
    if ctl:
        out["control_upper"] = {k: min(c[k] for c in ctl) for k in keys}
    for f in sorted({r["fault"] for r in rows} - {"none"}):
        fr = [r["readings"] for r in rows if r["fault"] == f]
        out[f"fault_{f}"] = {k: min(x[k] for x in fr) for k in keys}
    return out


def main(argv=None, **kw):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    rows = [one(a.workload, s, a.seconds, control=s in ctl, **kw) for s in seeds]
    for f in [f for f in a.faults.split(",") if f]:
        rows += [one(a.workload, s, a.seconds, fault=f, **kw) for s in ctl]
    report = {"workload": a.workload, "device": torch.cuda.get_device_name(0)
              if torch.cuda.is_available() else "cpu", "rows": rows, "summary": summarize(rows)}
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report["summary"]))
    return report


if __name__ == "__main__":
    main()

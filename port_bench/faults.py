"""Faults planted under the timed path, for the tests and the calibration
runs that show the correctness check fails on them. A run of the benchmark
plants ``none``.

* ``unchanged``: the train step returns its state unchanged (neither
  optimizer moves a parameter);
* ``half_batch``: the step trains on the first half of its batch's rows,
  the mean taken over them;
* ``altered``: a served image comes back with one value changed where it is
  produced.
"""

from __future__ import annotations

NAMES = ("none", "unchanged", "half_batch", "altered")


class Fault:
    def __init__(self, name):
        if name not in NAMES:
            raise ValueError(f"fault {name!r}: one of {NAMES}")
        self.name = name

    def state(self, state):
        if self.name == "unchanged":
            for o in (state.opt_g, state.opt_d):
                o.step = lambda *a, **k: None

    def batch(self, batch):
        if self.name != "half_batch":
            return batch
        n = next(iter(batch.values())).shape[0]
        return {k: v[: n // 2] for k, v in batch.items()}

    def output(self, out):
        if self.name == "altered":
            out = out.clone()
            out.view(-1)[0] += 0.5
        return out

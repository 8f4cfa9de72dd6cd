"""sample_ms.train: the card's ms a step in the port's ``himan.step.sample``
span (the resident sampler: the epoch's permutation and ``sample_fn``),
over the profiled sub-window. Moves ``train_samples_per_s``."""

from port_bench.spans import per_call_ms


def read(r):
    return per_call_ms(r, "train", "himan.step.sample")

"""g_trunk_ms.train: the card's ms a step in the port's ``himan.G.trunk``
span (the LocalEnhancer's global trunk, its forward on the pooled input),
over the profiled sub-window. Moves ``train_samples_per_s``."""

from port_bench.spans import per_call_ms


def read(r):
    return per_call_ms(r, "train", "himan.G.trunk")

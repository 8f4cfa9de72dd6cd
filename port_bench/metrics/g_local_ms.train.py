"""g_local_ms.train: the card's ms a step in the port's ``himan.G.local1``
span (the LocalEnhancer's full-size branch, its forward from the stem
through the up), over the profiled sub-window. Moves
``train_samples_per_s``."""

from port_bench.spans import per_call_ms


def read(r):
    return per_call_ms(r, "train", "himan.G.local1")

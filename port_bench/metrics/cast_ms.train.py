"""cast_ms.train: the card's ms a step in the port's ``himan.step.cast``
span (the bf16 tier's casts of G's, D's and VGG's parameters and of the
batch), over the profiled sub-window. Moves ``train_samples_per_s``."""

from port_bench.spans import per_call_ms


def read(r):
    return per_call_ms(r, "train", "himan.step.cast")

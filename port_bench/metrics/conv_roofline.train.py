"""conv_roofline.train: the step's convolution FLOPs (``flops.train_step``)
over the card's time in convolution kernels (the frozen classes' data
gradient, weight gradient and forward / other algorithms), as a share of
the tier's peak, in %. Moves ``train_samples_per_s``."""

from port_bench.trace import CONV_CLASSES, kernel_class


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    conv_s = t.seconds_where(lambda name: kernel_class(name) in CONV_CLASSES)
    if conv_s <= 0:
        return None
    achieved = r["work"]["conv"] * t.calls / conv_s
    return 100.0 * achieved / r["peaks"]["flops_per_s"][r["tier"]]

"""in_roofline.train: the step's instance-norm bytes (``flops.train_step``:
every IN site's forward and backward, counted from the configuration's
shapes) over 3.35 TB/s, as a share of the card's time in the port's IN
kernels (names holding ``in_fwd_`` or ``in_bwd_``, from
``csrc/instance_norm.cu``), in %. Moves ``train_samples_per_s``."""

NAMES = ("in_fwd_", "in_bwd_")


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    in_s = t.seconds_where(lambda name: any(k in name.lower() for k in NAMES))
    if in_s <= 0:
        return None
    least_s = (r["work"]["in_fwd_bytes"] + r["work"]["in_bwd_bytes"]) * t.calls \
        / r["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / in_s

"""device_idle.train: the share of the profiled sub-window of train steps in
which no operation ran on the card, in %. Moves ``train_samples_per_s``."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

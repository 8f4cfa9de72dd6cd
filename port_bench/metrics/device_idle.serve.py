"""device_idle.serve: the share of the profiled sub-window of served
requests in which no operation ran on the card, in %. Moves
``serve_ms_p50``."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

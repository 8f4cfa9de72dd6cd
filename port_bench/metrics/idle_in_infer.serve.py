"""idle_in_infer.serve: the share of the profiled sub-window of served
requests in which no operation ran on the card while the host was inside
the port's ``himan.infer`` span (its ``record_function`` range in the
trace, on the device operations' clock), in %. ``device_idle.serve`` less
this is the idle outside the program: the copies in and out and the
serving loop. Moves ``serve_ms_p50``."""


def _busy(device):
    """The union of the device operations' intervals, in order."""
    out = []
    for _, ts, dur in device:
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return out


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None or t.window_s <= 0 or not t.device:
        return None
    spans = [(ts, ts + dur) for name, ts, dur in t.host if name == "himan.infer"]
    if len(spans) != t.calls:
        return None
    busy = _busy(t.device)
    idle = 0.0
    for a, b in spans:
        idle += (b - a) - sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
    return 100.0 * idle / t.window_s

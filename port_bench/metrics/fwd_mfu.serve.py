"""fwd_mfu.serve: the served forward's G FLOPs (``flops.g_forward``) over
the card's busy time a request in the profiled sub-window, as a share of
the fp32 peak (67 TFLOP/s: the serving tier's full-fp32 convolutions), in
%. Moves ``serve_ms_p50``."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve" or t is None or not t.device:
        return None
    busy = t.busy_s()
    if busy <= 0:
        return None
    return 100.0 * r["work"]["g_forward"] * t.calls / busy / r["peaks"]["flops_per_s"][r["tier"]]

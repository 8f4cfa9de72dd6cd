"""g_fwd_ms.serve: the card's ms a request in the port's ``himan.infer.G``
span (the generator's forward), over the profiled sub-window. Moves
``serve_ms_p50``."""

from port_bench.spans import per_call_ms


def read(r):
    return per_call_ms(r, "serve", "himan.infer.G")

"""The port kernels' wrappers in one table: their launch counters, and a
stand-in that sees every call a path makes of them.

Each wrapper counts its launches on a function attribute (``.launches``;
``.variants`` where its plan picks among launch shapes) and bumps it only
where it launches its kernel. ``counters`` names them; ``read_launches``,
``read_variants`` and ``zero_launches`` read and reset them.

``intercept(on_call)`` replaces each wrapper a path calls (``CALLED``) by a
stand-in that hands every call, one on a CPU tensor too, to
``on_call(name, wrapper, *args, **kwargs)`` and returns what that returns.
A wrapper finds its own counter through its module's global name, so the
stand-in forwards attribute reads and writes to the wrapper it replaces:
counting goes on unchanged inside, and stand-ins nest.
"""

from __future__ import annotations

import contextlib
from unittest import mock

from . import conv_in as kconv
from . import encode as kenc
from . import instance_norm as kin
from . import losses as klosses
from . import reflect_pad as krp

# kernel name -> (module, attribute) of the wrapper that counts its launches
COUNTED = {
    "encode": (kenc, "encode"), "encode_cond": (kenc, "encode_cond"),
    "instance_norm": (kin, "instance_norm"), "instance_norm_bwd": (kin, "instance_norm_bwd"),
    "mse_to_scalar": (klosses, "mse_to_scalar"), "l1_to_scalar": (klosses, "l1_to_scalar"),
    "loss_group_bwd": (klosses, "loss_group_bwd"),
    "reflect_pad_fwd": (krp, "reflect_pad_fwd"), "reflect_pad_bwd": (krp, "reflect_pad_bwd"),
    "conv3x3_in_act": (kconv, "conv3x3_in_act"),
}
# the wrappers the model's paths call (the loss kernel through reduce_group,
# which counts on mse_to_scalar / l1_to_scalar; its backward through
# loss_group_bwd, from the group's autograd node)
CALLED = ((kin, "instance_norm"), (kin, "instance_norm_bwd"), (krp, "reflect_pad_fwd"),
          (krp, "reflect_pad_bwd"), (klosses, "reduce_group"), (klosses, "loss_group_bwd"),
          (kenc, "encode"), (kenc, "encode_cond"))


def counters():
    """Every kernel wrapper's launch counter holder, by kernel name."""
    return {k: getattr(mod, name) for k, (mod, name) in COUNTED.items()}


def read_launches():
    return {k: f.launches for k, f in counters().items()}


def read_variants():
    """Launches per variant of the kernels that have several."""
    return {k: dict(f.variants) for k, f in counters().items() if hasattr(f, "variants")}


def zero_launches():
    for f in counters().values():
        f.launches = 0
        for v in getattr(f, "variants", {}):
            f.variants[v] = 0


class _StandIn:
    """One wrapper's stand-in: calls go to ``on_call``, attributes to the
    wrapper."""

    def __init__(self, name, orig, on_call):
        object.__setattr__(self, "_of", (name, orig, on_call))

    def __getattr__(self, attr):
        return getattr(self._of[1], attr)

    def __setattr__(self, attr, value):
        setattr(self._of[1], attr, value)

    def __call__(self, *a, **k):
        name, orig, on_call = self._of
        return on_call(name, orig, *a, **k)


@contextlib.contextmanager
def intercept(on_call):
    """Inside: each wrapper of ``CALLED`` replaced by a stand-in that
    returns ``on_call(name, wrapper, *args, **kwargs)``."""
    with contextlib.ExitStack() as stack:
        for mod, name in CALLED:
            stack.enter_context(mock.patch.object(
                mod, name, _StandIn(name, getattr(mod, name), on_call)))
        yield

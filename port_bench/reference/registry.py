"""The models of the benchmark, found by name.

A configuration's ``model`` names the module that declares it at its top
level, as ``MODEL = "pix2pixHD"`` in ``reference/pix2pixhd.py``. Every module
of ``reference/`` is searched (its source is read, not imported), so a new
model enters as a new module here: no other file names a model. Such a
module answers what the harness asks of a model:

* ``Reference(cfg, train)``: the plain reference, its ``nets`` ({name:
  module}, G's first: the weights are drawn in that order), ``G_NETS``,
  ``generate``, ``full`` and ``block_losses`` (``reference/train.py``);
* ``g_layers(cfg, h, w)``: G's layers [(forward FLOPs a sample, needs a
  data gradient)] and IN sites [(elements a sample, channels, residual)] on
  h x w (``port_bench/flops.py`` has the shared arithmetic);
* ``d_input(cfg)``: D's input channels, the conditioning's share of them
  and its number of scales;
* ``vgg_taps(cfg, h, w)``: the frozen VGG's forward FLOPs a sample, 0
  without one;
* ``linear(cfg, n)``: the train step's linear-layer FLOPs on n samples.
"""

from __future__ import annotations

import ast
import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ANSWERS = ("Reference", "g_layers", "d_input", "vgg_taps", "linear")


class UnknownModel(LookupError):
    """No module declares the model, or more than one does."""


def _declared(path):
    """The string a file assigns to ``MODEL`` at its top level, or None."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "MODEL"
                                                 for t in node.targets)
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            return node.value.value
    return None


def declarations(dirs=()):
    """{model: [declaring file]} over ``reference/`` and ``dirs``."""
    out = {}
    for d in (HERE, *dirs):
        for f in sorted(os.listdir(d)):
            if f.endswith(".py"):
                name = _declared(os.path.join(d, f))
                if name is not None:
                    out.setdefault(name, []).append(os.path.join(d, f))
    return out


def find(model: str, dirs=()):
    """The module that declares ``model``, searched for in ``reference/``
    and then in ``dirs`` (package directories inside the checkout)."""
    paths = declarations(dirs).get(model, [])
    if len(paths) != 1:
        where = ", ".join(os.path.relpath(d, ROOT) for d in (HERE, *dirs))
        raise UnknownModel(f"model {model!r}: declared by {len(paths)} modules in {where}"
                           + (f" ({', '.join(paths)})" if paths else ""))
    rel = os.path.relpath(paths[0], ROOT)
    if rel.startswith(".."):
        raise UnknownModel(f"model {model!r}: {paths[0]} lies outside the checkout {ROOT}")
    mod = importlib.import_module(rel[: -len(".py")].replace(os.sep, "."))
    missing = [a for a in ANSWERS if not hasattr(mod, a)]
    if missing:
        raise UnknownModel(f"model {model!r}: {paths[0]} lacks {', '.join(missing)}")
    return mod

"""Weights carried across from the JAX package.

The JAX package writes a flat npz sidecar next to each checkpoint,
``{checkpoints_dir}/{name}/ckpt/{label}_params.npz``, keyed by the flax
param path joined with '/': ``G/params/conv_in/kernel``,
``G/params/res3/conv2/bias``, ``G/params/norm_in/scale`` (batch norm).
``params_from_jax`` maps those keys onto the port generator's
``state_dict`` and ``params_to_jax`` maps back, bit-exactly:

  * conv kernel HWIO -> weight (Cout, Cin, kh, kw)  by transpose(3, 2, 0, 1)
  * transposed-conv kernel HWIO (I = the op's input channels)
    -> weight (Cin, Cout, kh, kw)  by transpose(2, 3, 0, 1), no spatial flip
    (the JAX op flips at call time exactly as torch's does);
  * dense kernel (in, out) (flax ``nn.Dense``: the structure generator's
    ``cls_embed``) -> ``nn.Linear`` weight (out, in) by transpose;
  * batch-norm scale -> weight; every bias -> bias.

The transposed convs are the modules named ``up{i}``, ``{tag}_up{i}`` or
``local{n}_up`` (the GlobalGenerator's, the LocalEnhancer trunk's and the
Encoder's ``up{i}``, the structure generator's decoders' ``ctx_up{i}`` /
``obj_up{i}``, the LocalEnhancer branches' ``local{n}_up``). The same map
serves the discriminator (``D/params/scale{i}/layer{n}/{kernel,bias}``,
``norm{n}/{scale,bias}`` under batch norm) and VGG19
(``VGG/params/conv{b}_{c}/{kernel,bias}``) and box2mask's layout
discriminator (``D/params/d/layer{n}/...``) and the instance-feature
Encoder (``E/params/...``): ``state_dicts_from_jax`` turns one JAX ``{G,
D, VGG, E}`` tree into the port's ``state_dict``s. ``save_params`` writes
``{label}_params.npz`` in the JAX sidecar layout (G, D and E, as the JAX
package saves its train state's params). ``load_pretrain_into`` is
``--load_pretrain``: the coarse-to-fine hand-off of a GlobalGenerator
run's weights into a LocalEnhancer's trunk.

``CheckpointManager`` is the counterpart of the JAX package's
(``utils/checkpoint.py:21-135``), in its on-disk layout under
``{checkpoints_dir}/{name}/``: ``ckpt/{label}/`` holds the resumable state
(``state.pt``: G's, D's (and E's) parameters, both Adams' and both
schedules' state and the step, with ``torch.save``; the JAX package's is an orbax
directory), ``ckpt/{label}_params.npz`` the params sidecar, and
``iter.txt`` "epoch,iter" — the epoch to resume and the batches of it
already done.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

PREFIX = "G/params/"
NETS = ("G", "D", "VGG", "E")
# a transposed conv's module name: up{i}, {tag}_up{i}, local{n}_up
_UP = re.compile(r"(^|_)up\d*$")


def params_from_jax(flat: Dict[str, np.ndarray], prefix: str = PREFIX) -> Dict[str, torch.Tensor]:
    """Flat JAX npz dict -> generator state_dict (keys outside ``prefix``
    are ignored)."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        arr = np.asarray(arr)
        if leaf == "kernel" and arr.ndim == 2:
            arr, leaf = arr.T, "weight"
        elif leaf == "kernel":
            perm = (2, 3, 0, 1) if _UP.search(path[-1]) else (3, 2, 0, 1)
            arr, leaf = arr.transpose(perm), "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(path + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor], prefix: str = PREFIX) -> Dict[str, np.ndarray]:
    """Generator state_dict -> flat JAX npz dict (inverse of
    ``params_from_jax``)."""
    out = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim == 2:
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight" and arr.ndim == 4:
            perm = (2, 3, 0, 1) if _UP.search(path[-1]) else (2, 3, 1, 0)
            arr, leaf = arr.transpose(perm), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        out[prefix + "/".join(path + [leaf])] = np.ascontiguousarray(arr)
    return out


def state_dicts_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat JAX npz dict of a ``{G, D, VGG}`` param tree -> ``{net:
    state_dict}`` for each net present."""
    out = {}
    for net in NETS:
        sd = params_from_jax(flat, f"{net}/params/")
        if sd:
            out[net] = sd
    return out


def state_dicts_to_jax(state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Inverse of ``state_dicts_from_jax``."""
    out = {}
    for net, sd in state_dicts.items():
        out.update(params_to_jax(sd, f"{net}/params/"))
    return out


def trained_nets(model) -> Dict[str, torch.nn.Module]:
    """The model's trained networks by their JAX param-tree names: G, and
    D and E where it has them (never the fixed VGG)."""
    return {net: m for net, m in (("G", model.netG), ("D", getattr(model, "netD", None)),
                                  ("E", getattr(model, "netE", None))) if m is not None}


def save_params(opt, label, model) -> str:
    """Write ``{checkpoints_dir}/{name}/ckpt/{label}_params.npz``: the
    model's G (D when training, E under instance features) in the JAX
    sidecar layout, which the JAX package's ``load_params_npz`` and this
    package's ``restore_params`` read. Returns the path."""
    ckpt = os.path.join(opt.checkpoints_dir, opt.name, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    nets = {net: m.state_dict() for net, m in trained_nets(model).items()}
    path = os.path.join(ckpt, f"{label}_params.npz")
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **state_dicts_to_jax(nets))
    os.replace(tmp, path)
    return path


def _load_npz(path) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore_params(opt, model) -> bool:
    """Load ``{which_epoch}_params.npz`` into ``model.netG`` (and
    ``model.netE``) where present; every parameter missing from the file
    (or of another shape) keeps its init — the reference's partial-load
    fallback. Returns whether a file was found."""
    path = os.path.join(
        opt.checkpoints_dir, opt.name, "ckpt", f"{opt.which_epoch}_params.npz"
    )
    if not os.path.exists(path):
        print("WARNING: no checkpoint found — using random init")
        return False
    flat = _load_npz(path)
    missing = 0
    with torch.no_grad():
        for net, module in trained_nets(model).items():
            if net == "D":
                continue
            loaded = params_from_jax(flat, f"{net}/params/")
            for key, t in module.state_dict().items():
                src = loaded.get(key)
                if src is not None and tuple(src.shape) == tuple(t.shape):
                    t.copy_(src.to(t.dtype))
                else:
                    missing += 1
    if missing:
        print(f"checkpoint partial load: {missing} leaves kept at init")
    print(f"restored checkpoint '{opt.which_epoch}'")
    return True


def load_pretrain_into(model, pretrain_dir: str, which: str = "latest"):
    """``--load_pretrain`` (JAX ``CheckpointManager.load_pretrain_into``,
    ``utils/checkpoint.py:95-122``): initialize the model's G, D (and E)
    from ``{pretrain_dir}/ckpt/{which}_params.npz``. Each leaf, by its JAX
    key, loads from the key itself, else from the key with ``/global/``
    removed once (a GlobalGenerator's trunk into the LocalEnhancer's
    ``global`` scope), where the shape is equal; every other leaf keeps its
    init (the LocalEnhancer's 32-channel ``conv_out`` against the
    GlobalGenerator's 64, a third D scale). Prints and returns the counts
    (loaded, kept at init)."""
    data = _load_npz(os.path.join(pretrain_dir, "ckpt", f"{which}_params.npz"))
    n_loaded = n_missing = 0
    with torch.no_grad():
        for net, module in trained_nets(model).items():
            prefix = f"{net}/params/"
            out = {}
            for key, arr in params_to_jax(module.state_dict(), prefix).items():
                hit = next((c for c in (key, key.replace("/global/", "/", 1))
                            if c in data and data[c].shape == arr.shape), None)
                if hit is None:
                    n_missing += 1
                else:
                    out[key] = data[hit].astype(arr.dtype)
                    n_loaded += 1
            sd = module.state_dict()
            for key, t in params_from_jax(out, prefix).items():
                sd[key].copy_(t)
    print(f"load_pretrain: {n_loaded} leaves loaded, {n_missing} kept at init")
    return n_loaded, n_missing


class CheckpointManager:
    def __init__(self, opt):
        self.opt = opt
        self.dir = os.path.abspath(os.path.join(opt.checkpoints_dir, opt.name, "ckpt"))
        os.makedirs(self.dir, exist_ok=True)
        self.iter_file = os.path.join(opt.checkpoints_dir, opt.name, "iter.txt")

    def _state_path(self, label) -> str:
        return os.path.join(self.dir, str(label), "state.pt")

    def save(self, label, model, state, epoch: int, epoch_iter: int) -> None:
        """label: 'latest' or an epoch number. (epoch, epoch_iter) go to
        iter.txt: where a resumed run starts."""
        path = self._state_path(label)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"params": {net: m.state_dict() for net, m in trained_nets(model).items()},
                   **state.state_dict()}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        save_params(self.opt, label, model)
        with open(self.iter_file, "w") as f:
            f.write(f"{epoch},{epoch_iter}")

    def restore(self, label, model, state) -> None:
        """Load G, D (and E), the optimizers, the schedules and the step in
        place."""
        payload = torch.load(self._state_path(label), map_location=model.device)
        for net, m in trained_nets(model).items():
            m.load_state_dict(payload["params"][net])
        state.load_state_dict(payload)

    def exists(self, label) -> bool:
        return os.path.exists(self._state_path(label))

    def read_iter(self):
        """-> (start_epoch, epoch_iter) like the reference's iter.txt."""
        try:
            with open(self.iter_file) as f:
                epoch, it = f.read().strip().split(",")
                return int(epoch), int(it)
        except (FileNotFoundError, ValueError):
            return 1, 0

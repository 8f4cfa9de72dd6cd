"""Convert pix2pixHD checkpoints (``{epoch}_net_{G,D}.pth``) to the params
npz of the JAX package's sidecar layout, or load them straight into the
port's modules.

Counterpart of ``tools/convert_torch_checkpoint.py`` in the JAX package:
the same key maps and the same npz, array for array.

pix2pixHD's modules are ``nn.Sequential`` stacks, so its keys are
positional: ``model.{i}.weight`` for the generator,
``model.{i}.conv_block.{j}.weight`` inside resblocks (``block`` in the
JAX package's test oracle; either is read), and for the multiscale
discriminator ``scale{i}_layer{n}.0``, ``layer{i}.model{n}.0`` or
``discriminator_{i}.model{n}.0``, its attribute 0 the coarsest scale.
The npz keys are the JAX param tree's: ``G/params/{conv_in, down{i},
res{i}/conv{1,2}, up{i}, conv_out}/{kernel,bias}`` and
``D/params/scale{i}/layer{n}/{kernel,bias}`` with scale 0 the finest.

Convolutions: OIHW -> HWIO. Transposed convolutions: IOHW -> HWIO with no
spatial flip, as the JAX tool writes them (its transposed convolution
flips at call time); the port's weight bridge
(``utils/checkpoint.params_from_jax``) maps such a kernel back to IOHW,
also with no flip, so ``load_pix2pixhd_into`` gives the port's modules
pix2pixHD's tensors as they are.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.convert_torch_checkpoint \\
        --net G --pth latest_net_G.pth --out g_params.npz --n_down 4 --n_blocks 9

A file conversion on the host: it runs no model and uses no device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.checkpoint import state_dicts_from_jax
from .pix2pixhd_format import D_SPELLINGS, global_generator_index_map


def conv_w(sd, key):
    return np.ascontiguousarray(np.asarray(sd[f"{key}.weight"]).transpose(2, 3, 1, 0))


def convT_w(sd, key):
    return np.ascontiguousarray(np.asarray(sd[f"{key}.weight"]).transpose(2, 3, 0, 1))


def bias(sd, key):
    return np.asarray(sd[f"{key}.bias"])


def convert_global_generator(sd, n_down=4, n_blocks=9, prefix="model"):
    """pix2pixHD G state_dict (numpy values) -> flat ``G/params/...`` dict."""
    flat = {}
    idx = global_generator_index_map(n_down, n_blocks)

    def put(name, kernel, b):
        flat[f"G/params/{name}/kernel"] = kernel
        flat[f"G/params/{name}/bias"] = b

    k = f"{prefix}.{idx['conv_in']}"
    put("conv_in", conv_w(sd, k), bias(sd, k))
    for d in range(n_down):
        k = f"{prefix}.{idx[f'down{d}']}"
        put(f"down{d}", conv_w(sd, k), bias(sd, k))
    for r in range(n_blocks):
        base = f"{prefix}.{idx[f'res{r}']}"
        inner = "conv_block" if f"{base}.conv_block.1.weight" in sd else "block"
        put(f"res{r}/conv1", conv_w(sd, f"{base}.{inner}.1"), bias(sd, f"{base}.{inner}.1"))
        put(f"res{r}/conv2", conv_w(sd, f"{base}.{inner}.5"), bias(sd, f"{base}.{inner}.5"))
    for u in range(n_down):
        k = f"{prefix}.{idx[f'up{u}']}"
        put(f"up{u}", convT_w(sd, k), bias(sd, k))
    k = f"{prefix}.{idx['conv_out']}"
    put("conv_out", conv_w(sd, k), bias(sd, k))
    return flat


def convert_multiscale_discriminator(sd, num_D=2, n_layers=3):
    """pix2pixHD multiscale D state_dict (numpy values) -> flat
    ``D/params/scale{i}/layer{n}/...``; scale i of the forward order (0 the
    finest) is pix2pixHD's attribute num_D - 1 - i."""
    flat = {}
    for i in range(num_D):
        ref_i = num_D - 1 - i
        for n in range(n_layers + 2):
            candidates = [f"{s.format(i=ref_i, n=n)}.0" for s in D_SPELLINGS]
            key = next((c for c in candidates if f"{c}.weight" in sd), None)
            if key is None:
                raise KeyError(f"no discriminator key for scale {ref_i} layer {n}; "
                               f"tried {candidates}")
            flat[f"D/params/scale{i}/layer{n}/kernel"] = conv_w(sd, key)
            flat[f"D/params/scale{i}/layer{n}/bias"] = bias(sd, key)
    return flat


def numpy_state_dict(sd):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in sd.items()}


def read_pth(path):
    """A ``.pth`` state dict as numpy arrays."""
    return numpy_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_pix2pixhd_into(model, sd, net: str = "G") -> int:
    """Load a pix2pixHD state dict (``{epoch}_net_{net}.pth`` read with
    ``torch.load``, tensors or arrays) into the port model's ``netG`` or
    ``netD``, every parameter present and of its shape, through the npz
    layout and ``utils/checkpoint.state_dicts_from_jax``. Returns the
    tensors loaded."""
    sd = numpy_state_dict(sd)
    if net == "G":
        g = model.netG
        flat = convert_global_generator(sd, g.n_downsampling, g.n_blocks)
        module = g
    elif net == "D":
        flat = convert_multiscale_discriminator(sd, model.opt.num_D, model.opt.n_layers_D)
        module = model.netD
    else:
        raise ValueError(f"net must be G or D, got {net!r}")
    loaded = state_dicts_from_jax(flat)[net]
    module.load_state_dict({k: t.to(module.state_dict()[k].dtype) for k, t in loaded.items()},
                           strict=True)
    return len(loaded)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--net", choices=["G", "D"], required=True)
    p.add_argument("--n_down", type=int, default=4)
    p.add_argument("--n_blocks", type=int, default=9)
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    args = p.parse_args(argv)

    sd = read_pth(args.pth)
    if args.net == "G":
        flat = convert_global_generator(sd, args.n_down, args.n_blocks)
    else:
        flat = convert_multiscale_discriminator(sd, args.num_D, args.n_layers_D)
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays to {args.out}")
    return flat


if __name__ == "__main__":
    main()

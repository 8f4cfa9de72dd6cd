"""Convert torchvision's VGG19 weights (``vgg19-dcbb9e9d.pth``, keys
``features.{i}.{weight,bias}``) to the npz the port's evaluators read as
``--feature_params``: ``params/conv{b}_{c}/{kernel,bias}``, HWIO kernels
(``cli/evaluate.load_vgg``, ``models/networks.Vgg19Features``).

Counterpart of ``tools/load_vgg_weights.py`` in the JAX package, with the
same torchvision indices and the same arrays. Its keys differ on purpose:
the JAX tool writes ``VGG/params/conv{b}_{c}/...``, a layout the JAX
evaluator itself does not read (it loads ``params/conv{b}_{c}/...`` and
raises a KeyError on the converter's file; ROADMAP §C.6). This tool writes
the evaluators' layout, which the JAX evaluator reads as well.

torchvision ``features`` indices of the convs:
  block1: 0, 2 | block2: 5, 7 | block3: 10, 12, 14, 16
  block4: 19, 21, 23, 25 | block5: 28, 30, 32, 34

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.load_vgg_weights \\
        --pth vgg19.pth --out vgg_params.npz

A file conversion on the host: it runs no model and uses no device.
"""

from __future__ import annotations

import argparse

import numpy as np

from .convert_torch_checkpoint import read_pth

PREFIX = "params/"
TORCHVISION_CONV_INDICES = {
    (1, 1): 0, (1, 2): 2,
    (2, 1): 5, (2, 2): 7,
    (3, 1): 10, (3, 2): 12, (3, 3): 14, (3, 4): 16,
    (4, 1): 19, (4, 2): 21, (4, 3): 23, (4, 4): 25,
    (5, 1): 28, (5, 2): 30, (5, 3): 32, (5, 4): 34,
}


def convert_vgg19_state_dict(sd, prefix="features"):
    """torchvision VGG19 state_dict (numpy values) -> flat
    ``params/conv{b}_{c}/{kernel,bias}``."""
    flat = {}
    for (b, c), idx in TORCHVISION_CONV_INDICES.items():
        w = np.asarray(sd[f"{prefix}.{idx}.weight"]).transpose(2, 3, 1, 0)
        flat[f"{PREFIX}conv{b}_{c}/kernel"] = np.ascontiguousarray(w)
        flat[f"{PREFIX}conv{b}_{c}/bias"] = np.asarray(sd[f"{prefix}.{idx}.bias"])
    return flat


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    flat = convert_vgg19_state_dict(read_pth(args.pth))
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays to {args.out}")
    return flat


if __name__ == "__main__":
    main()

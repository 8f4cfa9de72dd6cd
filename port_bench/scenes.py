"""Cityscapes-like scenes made from the seed, and a dataroot of them.

The arithmetic of a scene is that of the port's ``tools/bench_loop.write_scene``:
a label map of road, sky, a building or vegetation band and a stray band of
any id; three objects (person, car or bicycle) with instance ids
``class * 1000 + k``; random RGB. The object sizes follow the configuration
(``object_h``, ``object_w``), so that the CPU tests can make small scenes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _rng(seed: int, i: int) -> np.random.RandomState:
    """The stream of scene i: a function of (seed, i) alone, for any seed
    below 2**64."""
    seed = int(seed)
    return np.random.RandomState([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, i])


def make_scene(cfg, seed: int, i: int):
    """Scene i -> (label uint8 (H,W), inst int32 (H,W), image uint8 (H,W,3))."""
    h, w = cfg["scene_hw"]
    (h_lo, h_hi), (w_lo, w_hi) = cfg["object_h"], cfg["object_w"]
    rng = _rng(seed, i)
    label = np.full((h, w), 7, np.uint8)
    label[: h // 3] = 23
    label[h // 3 : h // 2] = rng.choice([11, 21])
    label[h // 2 : h // 2 + 8] = rng.randint(0, 35)
    inst = label.astype(np.int32)
    for k in range(cfg["objects_per_scene"]):
        cls = rng.choice([24, 26, 33])
        bh, bw = rng.randint(h_lo, h_hi), rng.randint(w_lo, w_hi)
        y0, x0 = rng.randint(h // 3, h - bh), rng.randint(0, w - bw)
        label[y0 : y0 + bh, x0 : x0 + bw] = cls
        inst[y0 : y0 + bh, x0 : x0 + bw] = cls * 1000 + k
    img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
    return label, inst, img


def make_scenes(cfg, seed: int, n: int, threads: int = 4):
    """n scenes stacked -> {"label": (n,H,W) uint8, "inst": (n,H,W) int32,
    "image": (n,H,W,3) uint8}."""
    with ThreadPoolExecutor(max_workers=threads) as pool:
        scenes = list(pool.map(lambda i: make_scene(cfg, seed, i), range(n)))
    return {"label": np.stack([s[0] for s in scenes]),
            "inst": np.stack([s[1] for s in scenes]),
            "image": np.stack([s[2] for s in scenes])}


def write_dataroot(root: str, scenes, phase: str = "train", threads: int = 4) -> None:
    """The scenes as a Cityscapes-format dataroot: ``{phase}_label`` (L),
    ``{phase}_inst`` (I), ``{phase}_img`` (RGB) PNGs named ``%05d.png``."""
    from PIL import Image

    dirs = {k: os.path.join(root, f"{phase}_{k}") for k in ("label", "inst", "img")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    def write(i):
        name = f"{i:05d}.png"
        # compress_level 1: the random RGB does not compress, and set-up
        # pays for every level above it
        Image.fromarray(scenes["label"][i]).save(os.path.join(dirs["label"], name),
                                                 compress_level=1)
        Image.fromarray(scenes["inst"][i], mode="I").save(os.path.join(dirs["inst"], name),
                                                          compress_level=1)
        Image.fromarray(scenes["image"][i]).save(os.path.join(dirs["img"], name),
                                                 compress_level=1)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(write, range(len(scenes["label"]))))

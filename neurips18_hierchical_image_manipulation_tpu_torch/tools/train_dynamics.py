"""Training-dynamics evidence on a procedural world: does the port learn?

Builds a procedural but learnable label -> RGB world (per-class base
colors, smooth illumination, instance-correlated texture; no real data is
needed), trains the flagship mask2image GAN on it at 512x256 through the
port's train CLI (``cli/mask2image_train``: checkpoints, HTML gallery, loss
log), then draws the loss curves and a gallery contact sheet and writes a
summary.

    python -m neurips18_hierchical_image_manipulation_tpu_torch.tools.train_dynamics \\
        --steps 2000 --out reports/torch_r12/dynamics [--gpu_ids -1 for the CPU]

Counterpart of ``tools/train_dynamics.py`` in the JAX package: the same
world bit for bit (``synth_scene``, ``make_world``; the committed JAX
artifacts replay its draws), the same train CLI flags and epoch
arithmetic, and the same summary keys, plus ``device`` (the card's name and
power limit as ``nvidia-smi`` gives them, or ``cpu``) and ``wall_s``. The
plots are drawn with PIL (the JAX tool used matplotlib). The defaults of
``--out`` are this port's own report directories (``reports/torch_r12/``),
never the JAX package's committed ones, and the scratch directories sit
under the temporary directory (``$TMPDIR``, else ``/tmp``).
The other procedural-world tools (``train_dynamics_b2m``,
``two_step_gallery``, ``two_step_metrics``, ``train_dynamics_1024p``) take
the world and the plots from here.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
from PIL import Image, ImageDraw

from ..cli import mask2image_train
from ..models.factory import resolve_device

REPORTS = os.path.join("reports", "torch_r12")


def scratch(name):
    """A default scratch directory: ``name`` under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


_BASE_COLORS = {
    7: (96, 96, 96),     # road: gray
    23: (120, 170, 230),  # sky: blue
    21: (60, 130, 60),   # vegetation: green
    26: (170, 40, 40),   # car: red-ish, varied per instance
    11: (150, 120, 90),  # building: tan
}


def _render_rgb(label, inst, illum, tex):
    """RGB as a deterministic function of (layout, illum, texture)."""
    h, w = label.shape
    img = np.zeros((h, w, 3), np.float32)
    for cls, c in _BASE_COLORS.items():
        img[label == cls] = c
    # instance-correlated hue shift for cars
    for k in np.unique(inst[label == 26]):
        m = inst == k
        img[m] += ((int(k) % 7) - 3) * np.asarray([12.0, -6.0, 9.0])
    return np.clip(img + illum + tex, 0, 255).astype(np.uint8)


def synth_scene(rng, h, w, i, n_images, xx=None, paired_car=False):
    """One procedural scene; the order of the rng calls is the make_world
    contract (committed artifacts replay it).

    paired_car=True also returns the same scene rendered without its
    last-drawn car (which nothing occludes) and that car's box: the ground
    truth of the two-step edit metrics (``remove`` at car_box on the full
    scene must restore label_pre / img_pre; ``add`` of class 26 at car_box
    on the pre scene must reproduce label / img)."""
    if xx is None:
        xx = np.mgrid[0:h, 0:w][1].astype(np.float32)
    sy, sx = h / 256.0, w / 512.0  # object sizes scale with resolution

    def r(lo, hi, s):
        return int(rng.randint(max(int(lo * s), 2), max(int(hi * s), 3)))

    label = np.full((h, w), 23, np.uint8)  # sky
    horizon = h // 2 + int(rng.randint(-int(20 * sy) - 1, int(20 * sy) + 1))
    label[horizon:] = 7  # road
    # buildings: 2-3 blocks on the horizon
    for _ in range(rng.randint(2, 4)):
        bw_, bh_ = r(60, 140, sx), r(50, 110, sy)
        x0 = int(rng.randint(0, w - bw_))
        label[max(horizon - bh_, 0) : horizon, x0 : x0 + bw_] = 11
    # vegetation strip
    if rng.rand() < 0.7:
        vw = r(30, 80, sx)
        x0 = int(rng.randint(0, w - vw))
        label[max(horizon - 40, 0) : horizon, x0 : x0 + vw] = 21
    inst = label.astype(np.int32) * 1000
    # cars on the road
    label_pre = inst_pre = car_box = None
    n_cars = rng.randint(1, 4)
    for k in range(n_cars):
        ch_, cw_ = r(28, 48, sy), r(48, 90, sx)
        y0 = int(rng.randint(horizon, max(h - ch_, horizon + 1)))
        x0 = int(rng.randint(0, w - cw_))
        if paired_car and k == n_cars - 1:
            label_pre = label.copy()
            inst_pre = inst.copy()
            car_box = (y0, x0, min(ch_, h - y0), min(cw_, w - x0))
        label[y0 : y0 + ch_, x0 : x0 + cw_] = 26
        inst[y0 : y0 + ch_, x0 : x0 + cw_] = 26000 + k
    # smooth illumination + gentle texture (one tex draw; a pair's renders
    # share it, so pre and post differ only under the car)
    illum = 24.0 * np.sin(2 * np.pi * (xx / w + i / n_images))[..., None]
    tex = rng.randn(h, w, 1).astype(np.float32) * 4.0
    scene = {
        "label": label,
        "inst": inst,
        "img": _render_rgb(label, inst, illum, tex),
    }
    if paired_car:
        scene.update(
            label_pre=label_pre,
            inst_pre=inst_pre,
            img_pre=_render_rgb(label_pre, inst_pre, illum, tex),
            car_box=car_box,
        )
    return scene


def make_world(root, n_images, hw=(256, 512), seed=0):
    """Scenes where RGB is a (noisy) deterministic function of layout: a
    GAN with enough capacity drives its losses down. Writes
    ``{root}/train_{label,inst,img}/{i:04d}.png``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for sub in ("train_label", "train_inst", "train_img"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    xx = np.mgrid[0:h, 0:w][1].astype(np.float32)
    for i in range(n_images):
        s = synth_scene(rng, h, w, i, n_images, xx=xx)
        Image.fromarray(s["label"]).save(f"{root}/train_label/{i:04d}.png")
        Image.fromarray(s["inst"], mode="I").save(f"{root}/train_inst/{i:04d}.png")
        Image.fromarray(s["img"]).save(f"{root}/train_img/{i:04d}.png")


def parse_loss_log(path):
    pat = re.compile(r"\(epoch: (\d+), iters: (\d+), time: [\d.]+\)(.*)")
    kv = re.compile(r"(\w+): ([\d.eE+-]+)")
    rows = []
    for line in open(path):
        m = pat.match(line.strip())
        if not m:
            continue
        row = {"epoch": int(m.group(1)), "iters": int(m.group(2))}
        for k, v in kv.findall(m.group(3)):
            row[k] = float(v)
        rows.append(row)
    return rows


def loss_keys(rows):
    """The loss terms of a run's last row (not its position or its rate)."""
    return [k for k in rows[-1] if k not in ("epoch", "iters", "img_per_s_per_chip")]


def all_finite(rows, keys):
    return all(np.isfinite([r.get(k, 0.0) for k in keys]).all() for r in rows)


def resolve(gpu_ids):
    """The device ``--gpu_ids`` names (``models/factory.resolve_device``:
    raises when it asks for a card and there is none)."""
    return resolve_device(SimpleNamespace(gpu_ids=gpu_ids))


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


# ---------------------------------------------------------------- plots (PIL)

_COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
           (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))


def _panel(draw, box, title, series):
    """Line plot of ``series`` ({name: [y]}, x the print step) inside box =
    (x0, y0, x1, y1): a frame, the y range, one polyline a series, a
    legend."""
    x0, y0, x1, y1 = box
    draw.rectangle(box, outline=(0, 0, 0))
    draw.text((x0 + 4, y0 - 14), title, fill=(0, 0, 0))
    ys = [v for vals in series.values() for v in vals if np.isfinite(v)]
    if not ys:
        return
    lo, hi = min(ys), max(ys)
    span = hi - lo or 1.0
    draw.text((x0 - 46, y0), f"{hi:.3g}", fill=(0, 0, 0))
    draw.text((x0 - 46, y1 - 10), f"{lo:.3g}", fill=(0, 0, 0))
    for j, (name, vals) in enumerate(sorted(series.items())):
        color = _COLORS[j % len(_COLORS)]
        n = max(len(vals) - 1, 1)
        pts = [(x0 + 2 + (x1 - x0 - 4) * t / n, y1 - 2 - (y1 - y0 - 4) * (v - lo) / span)
               for t, v in enumerate(vals) if np.isfinite(v)]
        if len(pts) > 1:
            draw.line(pts, fill=color, width=2)
        elif pts:
            draw.point(pts, fill=color)
        draw.text((x1 - 110, y0 + 4 + 12 * j), name, fill=color)


def draw_loss_curves(path, panels, title):
    """``panels``: rows of (title, {name: [y]}) panels -> one PNG."""
    rows, cols = len(panels), max(len(r) for r in panels)
    pw, ph, ml, mt = 520, 300, 60, 40
    im = Image.new("RGB", (cols * (pw + ml) + 20, rows * (ph + mt) + 40), (255, 255, 255))
    draw = ImageDraw.Draw(im)
    draw.text((10, 8), title, fill=(0, 0, 0))
    for r, row in enumerate(panels):
        for c, (ptitle, series) in enumerate(row):
            x0, y0 = ml + c * (pw + ml), 40 + mt // 2 + r * (ph + mt)
            _panel(draw, (x0, y0, x0 + pw, y0 + ph), ptitle, series)
    im.save(path)


def g_d_panels(rows, keys, title):
    """One row of two panels, G's terms and D's."""
    series = {k: [r.get(k, float("nan")) for r in rows] for k in sorted(keys)}
    return [(f"{title}generator losses", {k: v for k, v in series.items() if k.startswith("G_")}),
            (f"{title}discriminator losses",
             {k: v for k, v in series.items() if not k.startswith("G_")})]


def contact_sheet(imgdir, out, thumb):
    """Six of a run's synthesized web images, evenly picked, in a 2x3 sheet."""
    files = sorted(os.listdir(imgdir)) if os.path.isdir(imgdir) else []
    synth = [f for f in files if "synthesized" in f]
    picks = synth[:: max(len(synth) // 6, 1)][:6]
    if not picks:
        return
    tiles = []
    for f in picks:
        im = Image.open(os.path.join(imgdir, f)).convert("RGB")
        im.thumbnail(thumb)
        tiles.append(np.asarray(im))
    h = max(t.shape[0] for t in tiles)
    w = max(t.shape[1] for t in tiles)
    sheet = np.zeros((2 * h, 3 * w, 3), np.uint8)
    for j, t in enumerate(tiles):
        r, c = divmod(j, 3)
        sheet[r * h : r * h + t.shape[0], c * w : c * w + t.shape[1]] = t
    Image.fromarray(sheet).save(out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--n_images", type=int, default=256)
    p.add_argument("--out", default=os.path.join(REPORTS, "dynamics"))
    p.add_argument("--dataroot", default=scratch("himan_dyn_world"))
    p.add_argument("--ckpt", default=scratch("himan_dyn_ckpt"))
    p.add_argument("--skip_train", action="store_true",
                   help="only render reports from an existing run")
    p.add_argument("--smoke", action="store_true",
                   help="tiny arch/res for CI (CPU-feasible)")
    p.add_argument("--extra", action="append", default=[],
                   help="extra flag(s) passed through to the train "
                   "CLI (repeatable), e.g. --extra=--instance_feat "
                   "for the Encoder-conditioned dynamics leg")
    p.add_argument("--name", default="dynamics512")
    p.add_argument("--gpu_ids", default="0", help="-1 for the CPU")
    args = p.parse_args(argv)
    device = resolve(args.gpu_ids)
    t0 = time.time()

    name = args.name
    if not args.skip_train:
        hw = (64, 128) if args.smoke else (256, 512)
        if not os.path.exists(os.path.join(args.dataroot, "train_label")):
            print("building procedural world ...")
            make_world(args.dataroot, args.n_images, hw=hw)
        steps_per_epoch = args.n_images // args.bs
        epochs = max(args.steps // steps_per_epoch, 1)
        shutil.rmtree(os.path.join(args.ckpt, name), ignore_errors=True)
        arch = (
            ["--ngf", "16", "--ndf", "16", "--n_downsample_global", "2",
             "--n_blocks_global", "2", "--num_D", "1", "--n_layers_D", "2",
             "--no_vgg_loss"]
            if args.smoke
            else ["--ngf", "64", "--ndf", "64", "--n_downsample_global", "4",
                  "--n_blocks_global", "9", "--num_D", "2", "--n_layers_D", "3"]
        )
        mask2image_train.main([
            "--name", name, "--dataroot", args.dataroot,
            "--checkpoints_dir", args.ckpt,
            "--label_nc", "35", *arch,
            "--batchSize", str(args.bs),
            "--resize_or_crop", "none", "--no_flip",
            "--no-use_bbox_dataset", "--no-use_masked_image",
            "--uint8_transfer", "--device_resident_data",
            "--dtype", "bfloat16",
            "--niter", str(max(epochs // 2, 1)),
            "--niter_decay", str(epochs - max(epochs // 2, 1)),
            "--print_freq", str(steps_per_epoch),
            "--display_freq", str(10 * steps_per_epoch),
            "--save_epoch_freq", "1000000",
            "--save_latest_freq", "1000000",
            *args.extra,
            "--gpu_ids", args.gpu_ids,
        ])

    # the report
    run_dir = os.path.join(args.ckpt, name)
    os.makedirs(args.out, exist_ok=True)
    rows = parse_loss_log(os.path.join(run_dir, "loss_log.txt"))
    assert rows, "no loss rows parsed"
    keys = loss_keys(rows)
    draw_loss_curves(os.path.join(args.out, "loss_curves.png"), [g_d_panels(rows, keys, "")],
                     "mask2image 512x256 bf16 training dynamics (procedural world), "
                     "x: print step")
    contact_sheet(os.path.join(run_dir, "web", "images"),
                  os.path.join(args.out, "gallery.png"), (256, 128))

    first, last = rows[0], rows[-1]
    summary = {
        "steps_logged": len(rows),
        "first": {k: first.get(k) for k in keys},
        "last": {k: last.get(k) for k in keys},
        "img_per_s_per_chip_last": last.get("img_per_s_per_chip"),
        "finite": all_finite(rows, keys),
        "device": device_line(device),
        "wall_s": time.time() - t0,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""The bbox context-window batches of the scenes, in plain numpy and torch.

What the paper's data path computes for one object record, written from its
definition and not from the port:

* records: every instance id >= 1000 of a scene, in ascending id order,
  with the box of its pixels (y0, x0, h, w); boxes whose short side is
  under ``min_box_size`` are dropped;
* the context window: a square of ``contextMargin`` x the box's long side
  (at least max(out/8, 8)), centred on the box, clipped to the scene,
  floored to whole pixels;
* the crop: ids by nearest sampling of the window resized to out x out
  (sample centres start + (i + 0.5) * size / out), RGB by PIL's bicubic
  resize of the window (Keys cubic, a = -0.5, widened by the downscale
  factor, each row's taps normalized, the result clipped to [0, 255] as
  PIL clips the cubic's overshoot), kept in floating point;
* the box in window coordinates, scaled to the crop, and its mask.
"""

from __future__ import annotations

import numpy as np
import torch


def records(inst_scenes, min_size: int = 16, max_size: int = 10_000):
    """(n,H,W) instance ids -> [(scene, inst_id, cls, (y0, x0, h, w))]."""
    out = []
    for s, inst in enumerate(inst_scenes):
        for iid in np.unique(inst):
            if iid < 1000:
                continue
            ys, xs = np.nonzero(inst == iid)
            h, w = int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1)
            if min(h, w) < min_size or max(h, w) > max_size:
                continue
            out.append((s, int(iid), int(iid // 1000), (int(ys.min()), int(xs.min()), h, w)))
    return out


def context_window(box, hw, margin: float, out: int):
    """(y0, x0, h, w) -> the integer window (wy0, wx0, side_h, side_w)."""
    y0, x0, bh, bw = (float(v) for v in box)
    side = max(max(bh, bw) * margin, max(out / 8.0, 8.0))
    side_h, side_w = min(side, float(hw[0])), min(side, float(hw[1]))
    wy0 = np.floor(min(max(y0 + bh / 2.0 - side_h / 2.0, 0.0), hw[0] - side_h))
    wx0 = np.floor(min(max(x0 + bw / 2.0 - side_w / 2.0, 0.0), hw[1] - side_w))
    return int(wy0), int(wx0), int(np.floor(side_h)), int(np.floor(side_w))


def scaled_box(box, window, out: int):
    """The box in the window's coordinates, scaled to the out x out crop:
    the corner clipped into the crop, the extent not (at least 1)."""
    y0, x0, h, w = box
    wy0, wx0, wh, ww = window
    sy, sx = out / wh, out / ww
    by0 = int(np.clip((y0 - wy0) * sy, 0, out - 1))
    bx0 = int(np.clip((x0 - wx0) * sx, 0, out - 1))
    return by0, bx0, max(int(h * sy), 1), max(int(w * sx), 1)


def _nearest_index(start: int, size: int, out: int, full: int):
    i = np.arange(out, dtype=np.float64)
    return np.clip(np.floor(start + (i + 0.5) * (size / out)), 0, full - 1).astype(np.int64)


def _cubic(t):
    at = np.abs(t)
    near = ((1.5 * at - 2.5) * at) * at + 1.0
    far = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
    return np.where(at < 1.0, near, np.where(at < 2.0, far, 0.0))


def _bicubic_matrix(size: int, out: int):
    """(out, size) weights of PIL's bicubic resize of a window of ``size``
    pixels to ``out`` (taps outside the window dropped)."""
    scale = size / out
    support = max(scale, 1.0)
    centres = (np.arange(out) + 0.5) * scale
    j = np.arange(size) + 0.5
    w = _cubic((j[None, :] - centres[:, None]) / support)
    return w / w.sum(1, keepdims=True)


def crop(scenes, rec, out: int, margin: float):
    """One record's crop -> dict of numpy arrays: label, inst (out,out)
    int32, image (out,out,3) float32 in [-1, 1], boxes (4,) float32,
    boxmask and objmask (out,out,1) float32, cls int."""
    s, iid, cls, box = rec
    hw = scenes["label"].shape[1:3]
    win = context_window(box, hw, margin, out)
    wy0, wx0, wh, ww = win
    yi = _nearest_index(wy0, wh, out, hw[0])
    xi = _nearest_index(wx0, ww, out, hw[1])
    label = scenes["label"][s][yi[:, None], xi[None, :]].astype(np.int32)
    inst = scenes["inst"][s][yi[:, None], xi[None, :]].astype(np.int32)
    window = scenes["image"][s][wy0:wy0 + wh, wx0:wx0 + ww].astype(np.float64)
    rows = np.tensordot(_bicubic_matrix(wh, out), window, axes=(1, 0))          # (out, ww, 3)
    rgb = np.tensordot(_bicubic_matrix(ww, out), rows, axes=(1, 1)).transpose(1, 0, 2)
    rgb = np.clip(rgb, 0.0, 255.0)
    box_s = scaled_box(box, win, out)
    yy, xx = np.arange(out)[:, None], np.arange(out)[None, :]
    by0, bx0, bh, bw = box_s
    boxmask = ((yy >= by0) & (yy < by0 + bh) & (xx >= bx0) & (xx < bx0 + bw)).astype(np.float32)
    return {"label": label, "inst": inst,
            "image": (rgb / 127.5 - 1.0).astype(np.float32),
            "boxes": np.asarray(box_s, np.float32),
            "boxmask": boxmask[..., None],
            "objmask": ((inst == iid) * boxmask).astype(np.float32)[..., None],
            "cls": cls}


def batch(scenes, recs, idx, out: int, margin: float, device):
    """Rows ``idx`` of the records as one batch of torch tensors on device."""
    rows = [crop(scenes, recs[int(i)], out, margin) for i in idx]
    t = {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0] if k != "cls"}
    t["cls"] = torch.tensor([r["cls"] for r in rows], dtype=torch.int64)
    return {k: v.to(device) for k, v in t.items()}

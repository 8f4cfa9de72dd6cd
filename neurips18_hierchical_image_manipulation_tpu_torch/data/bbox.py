"""Bbox preprocessing + bbox-conditioned crop dataset.

``extract_bbox_records`` (offline): scans ``{phase}_inst`` instance-id
maps and emits per-object records {image_index, class, bbox} — the
equivalent of the reference's preprocessed-json step over Cityscapes
instance polygons. Thing-objects are instance ids >= 1000 (Cityscapes
``class*1000+k`` convention).

``BboxCropDataset``: samples an object record, expands its box to a
context window (``contextMargin`` x the box, clipped), crops label/inst/
RGB, resizes to the fixed ``fineSize`` square, and returns the
structure-generator batch: GT layout ids, box mask (in window coords),
class id, GT object mask, plus the RGB window + in-window box for the
conditioned mask2image stage. ``--bg_box_prob`` turns every ~1/p-th sample
into a background box (null class -1, empty object mask), as in the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..ops.boxcomposite import context_window_math
from . import native
from .cityscapes import AlignedDataset


def bboxes_from_instance_map(inst: np.ndarray, min_size=16, max_size=10_000):
    """(H,W) instance ids -> list of {cls, bbox=(y0,x0,h,w)} for thing ids.
    """
    records = []
    for rec in native.extract_bboxes(inst, min_id=1000):
        h, w = rec["bbox"][2], rec["bbox"][3]
        if min(h, w) < min_size or max(h, w) > max_size:
            continue
        records.append(rec)
    return records


def extract_bbox_records(dataset: AlignedDataset, min_size=16, max_size=10_000):
    """Offline pass over a dataset's instance maps -> per-image records."""
    all_records = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        for rec in bboxes_from_instance_map(sample["inst"], min_size, max_size):
            rec["image_index"] = idx
            all_records.append(rec)
    return all_records


def save_bbox_records(records: List[Dict], path: str):
    with open(path, "w") as f:
        json.dump(records, f)


def load_bbox_records(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def _scaled_box(bbox, wy0, wx0, wh, ww, s):
    """Object box in window coordinates scaled to the fixed ``s`` crop —
    the ONE rule shared by the streaming BboxCropDataset and the
    device-resident loader so their ``boxes`` tensors are bit-identical.
    bh/bw are deliberately UNclamped at the window edge: every
    rasterizer (numpy boxmask here, the encode kernel's box test on the
    device) clamps geometrically, and downstream consumers see the true scaled
    extent."""
    y0, x0, h, w = bbox
    sy, sx = s / wh, s / ww
    by0 = int(np.clip((y0 - wy0) * sy, 0, s - 1))
    bx0 = int(np.clip((x0 - wx0) * sx, 0, s - 1))
    return by0, bx0, max(int(h * sy), 1), max(int(w * sx), 1)


def _context_window(bbox, hw, margin, out_size):
    """Square context window in integer pixels."""
    y0, x0, h, w = bbox
    wy0, wx0, side_h, side_w = context_window_math(
        float(y0), float(x0), float(h), float(w), hw, margin, out_size, np
    )
    return int(wy0), int(wx0), int(side_h), int(side_w)


class BboxCropDataset:
    """Per-object context-window crops for box2mask (and box-conditioned
    mask2image). One epoch = one pass over object records."""

    def __init__(self, opt, records: Optional[List[Dict]] = None):
        self.opt = opt
        # the crop dataset always needs instance maps to find objects, even
        # when the model consumes no instance-edge channel (no_instance).
        # Geometry must be DETERMINISTIC: bbox records are extracted in the
        # transformed coordinate frame, so random flip/crop in the base
        # dataset would desynchronize boxes from pixels — flips would
        # mirror the image but not the stored box. (Flip augmentation, if
        # wanted, belongs here where crop and box can flip together.)
        import copy as _copy
        import dataclasses as _dc

        # always a COPY: mutating a shared (non-dataclass) opt here would
        # corrupt the caller's flags (e.g. flip no_instance before
        # create_model(opt) runs)
        base_opt = _dc.replace(opt) if _dc.is_dataclass(opt) else _copy.copy(opt)
        base_opt.no_instance = False
        base_opt.no_flip = True
        if "crop" in getattr(base_opt, "resize_or_crop", ""):
            base_opt.resize_or_crop = (
                "scale_width"
                if "scale_width" in base_opt.resize_or_crop
                else "none"
            )
        self.base = AlignedDataset(base_opt)
        self.size = opt.fineSize
        self.margin = getattr(opt, "contextMargin", 2.0)
        # --bg_box_prob: every ~1/p-th sample trains as a BACKGROUND box
        # (null class, empty GT object mask, box placed on object-free
        # ground) — the supervision that makes remove-mode edits work.
        # Deterministic in (epoch, index), as in the JAX package.
        p = float(getattr(opt, "bg_box_prob", 0.0) or 0.0)
        self.bg_every = max(int(round(1.0 / p)), 1) if p > 0 else 0
        self._epoch = 0
        if records is None:
            cache = os.path.join(
                opt.dataroot, f"{getattr(opt, 'phase', 'train')}_bboxes.json"
            )
            if os.path.exists(cache):
                records = load_bbox_records(cache)
            else:
                records = extract_bbox_records(
                    self.base,
                    getattr(opt, "min_box_size", 16),
                    getattr(opt, "max_box_size", 10_000),
                )
                try:
                    save_bbox_records(records, cache)
                except OSError:
                    pass
        self.records = records

    def set_epoch(self, epoch: int) -> None:
        self.base.set_epoch(epoch)
        self._epoch = int(epoch)

    @staticmethod
    def _background_box(bbox, inst):
        """Deterministic object-free placement of a box the same size as
        ``bbox``: first golden-ratio grid candidate whose region holds
        <= 2% THING pixels. None if the scene is too crowded — the caller
        falls back to the object sample.

        Thing test: ``inst >= 24000``. Cityscapes encodes instances as
        class*1000+k with thing classes being ids 24..33 (person..bicycle);
        stuff pixels carry inst == class id (< 1000). The procedural world
        additionally stamps STUFF regions as class*1000 (road=7000,
        sky=23000, ...) so the scanner yields stuff boxes too — a plain
        ``>= 1000`` test would mark every pixel occupied and this
        augmentation would silently never fire."""
        y0, x0, h, w = (int(v) for v in bbox)
        H, W = inst.shape
        h, w = min(h, H), min(w, W)
        thing = (inst >= 24000).astype(np.int64)
        ii = np.pad(np.cumsum(np.cumsum(thing, 0), 1), ((1, 0), (1, 0)))
        u0 = ((y0 * 131 + x0 * 31) % 997) / 997.0
        phi = 0.6180339887

        def free(cy, cx):
            s = ii[cy + h, cx + w] - ii[cy, cx + w] - ii[cy + h, cx] + ii[cy, cx]
            return s <= 0.02 * h * w

        # Prefer SAME-ROW placements (x-shift only): remove-mode queries
        # are boxes at object height (cars sit on the road), so the
        # augmentation must supervise "null class at an object-height box
        # over object-free ground", not boxes drifting into the sky.
        cy0 = min(y0, H - h)
        for k in range(48):
            cx = int(((u0 + k * phi) % 1.0) * max(W - w, 1))
            if free(cy0, cx):
                return (cy0, cx, h, w)
        for k in range(64):
            cy = int(((u0 + k * phi) % 1.0) * max(H - h, 1))
            cx = int(((u0 * 7.0 + k * phi * 3.0) % 1.0) * max(W - w, 1))
            if free(cy, cx):
                return (cy, cx, h, w)
        return None

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rec = self.records[index]
        sample = self.base[rec["image_index"]]
        label, inst = sample["label"], sample["inst"]
        hw = label.shape
        s = self.size

        bbox = rec["bbox"]
        bg = bool(self.bg_every) and (index + self._epoch) % self.bg_every == 0
        if bg:
            bg_box = self._background_box(bbox, inst)
            if bg_box is None:
                bg = False
            else:
                bbox = bg_box

        wy0, wx0, wh, ww = _context_window(bbox, hw, self.margin, s)

        def crop_resize_nearest(arr):
            win = arr[wy0 : wy0 + wh, wx0 : wx0 + ww]
            return native.nearest_resize_i32(win, s, s)

        gt_layout = crop_resize_nearest(label)
        inst_win = crop_resize_nearest(inst)

        # object box in window coords, scaled to the fixed crop
        by0, bx0, bh, bw = _scaled_box(bbox, wy0, wx0, wh, ww, s)
        boxmask = native.box_mask_f32(s, s, by0, bx0, bh, bw)

        if bg:
            # background sample: null class (-1 -> all-zeros one-hot),
            # nothing to segment, full-weight context supervision in-box
            gt_objmask = np.zeros((s, s, 1), np.float32)
            cls_id = np.int32(-1)
        else:
            gt_objmask = (
                (inst_win == rec["inst_id"]).astype(np.float32)[..., None] * boxmask
            )
            cls_id = np.int32(rec["cls"])

        u8 = getattr(self.opt, "uint8_transfer", False)
        if u8:
            # --uint8_transfer on the crop path: ids ship as uint8/uint16
            # (all device consumers cast to int32), image as raw uint8 —
            # 3-4x smaller host-to-device copies; the device normalizes.
            gt_layout = gt_layout.astype(np.uint8)
            inst_win = inst_win.astype(np.uint16)
        out = {
            "gt_layout": gt_layout,
            "masked_layout": gt_layout.copy(),  # one-hot zeroed in-box on device
            "boxmask": boxmask,
            "gt_objmask": gt_objmask,
            "cls": cls_id,
            "boxes": np.asarray([by0, bx0, bh, bw], np.float32),
            "path": sample["path"],
        }
        if "image" in sample:
            win = sample["image"][wy0 : wy0 + wh, wx0 : wx0 + ww]
            if win.dtype == np.uint8:
                win8 = win  # base emitted raw uint8 (--uint8_transfer)
            else:
                # exact inverse of normalize_rgb: round-to-nearest recovers
                # the original uint8 decode bit-exactly (no quantize drift)
                win8 = np.clip((win + 1.0) * 127.5 + 0.5, 0, 255).astype(
                    np.uint8
                )
            rgb = np.asarray(Image.fromarray(win8).resize((s, s), Image.BICUBIC))
            out["image"] = rgb if u8 else rgb.astype(np.float32) / 127.5 - 1.0
            out["label"] = gt_layout
            out["inst"] = inst_win
        return out

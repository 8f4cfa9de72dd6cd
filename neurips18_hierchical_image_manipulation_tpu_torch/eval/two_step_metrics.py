"""Per-edit metrics of the two-step pipeline — the port's own copy of
``eval/two_step_metrics.py`` in the JAX package (pure numpy).

Over pipeline outputs and a ground truth that renders the same scene with
and without the target object: whether an add places the class inside the
box (in-box accuracy, class IoU, mIoU), whether a remove restores the
occluded context, and that every mode is an exact passthrough outside the
edited box.
"""

from __future__ import annotations

import numpy as np


def _box_mask(box, hw):
    """Inclusive-exclusive integer box mask. box = (y0, x0, bh, bw)."""
    y0, x0, bh, bw = [int(round(float(v))) for v in box]
    m = np.zeros(hw, bool)
    m[max(y0, 0) : max(y0 + bh, 0), max(x0, 0) : max(x0 + bw, 0)] = True
    return m


def outside_box_max_abs(pred, ref, box):
    """Max |pred - ref| outside the box — the passthrough gate. The
    pipeline composes its edit with where(box_mask, ...), so outside
    pixels must be BIT-exact (0.0 for float images, 0 for label maps)."""
    m = _box_mask(box, pred.shape[:2])
    outside = ~m
    diff = np.abs(
        np.asarray(pred, np.float64) - np.asarray(ref, np.float64)
    )
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    return float(diff[outside].max()) if outside.any() else 0.0


def inbox_accuracy(pred_label, gt_label, box):
    """Fraction of in-box pixels where the predicted layout equals GT."""
    m = _box_mask(box, pred_label.shape)
    if not m.any():
        return float("nan")
    return float((np.asarray(pred_label)[m] == np.asarray(gt_label)[m]).mean())


def inbox_class_iou(pred_label, gt_label, box, cls):
    """IoU of class `cls` between predicted and GT layout, in-box only."""
    m = _box_mask(box, pred_label.shape)
    p = np.asarray(pred_label)[m] == cls
    g = np.asarray(gt_label)[m] == cls
    union = (p | g).sum()
    if union == 0:
        return float("nan")
    return float((p & g).sum() / union)


def inbox_miou(pred_label, gt_label, box, classes):
    """Mean IoU over `classes` present in GT in-box (layout-mIoU of the
    edit window, the structure-stage quality number)."""
    ious = []
    m = _box_mask(box, pred_label.shape)
    g_in = np.asarray(gt_label)[m]
    p_in = np.asarray(pred_label)[m]
    for c in classes:
        gm = g_in == c
        pm = p_in == c
        union = (gm | pm).sum()
        if union == 0:
            continue
        ious.append((gm & pm).sum() / union)
    return float(np.mean(ious)) if ious else float("nan")


def summarize(values):
    vals = [v for v in values if not np.isnan(v)]
    if not vals:
        return {"mean": None, "min": None, "n": 0}
    return {
        "mean": round(float(np.mean(vals)), 4),
        "min": round(float(np.min(vals)), 4),
        "n": len(vals),
    }

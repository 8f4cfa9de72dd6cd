"""The two-step add / remove / swap pipeline — counterpart of
``eval/two_step.py`` in the JAX package (``TwoStepPipeline``).

A box edit -> the structure generator (box2mask) inpaints the layout
inside the box's context window -> the layout is pasted back into the full
label map -> the image generator (mask2image) renders the window from the
completed layout and the box-masked photo -> the box region is pasted back
into the photo. Every step is a tensor op on the models' device at fixed
window sizes (``ops/boxcomposite``): the boxes stay on the device, and an
edit makes no host sync; the caller's read of the result is the only one.

The box coordinates in window space are computed in fp32 in the JAX
package's order, ``(y0 - wy0) * (s / wh)`` with ``s / wh`` one division
(``boxcomposite.rdiv``): ``box_mask`` and the encode kernel's inside test
take these fractional boxes as they are, and another order of the same
arithmetic can move a box edge by one pixel.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.factory import precision_scope
from ..ops import boxcomposite


def _window_box(boxes, windows, s: int):
    """Object boxes in the coordinates of their windows resized to s x s."""
    wy0, wx0, wh, ww = (windows[:, k] for k in range(4))
    sy, sx = boxcomposite.rdiv(s, wh), boxcomposite.rdiv(s, ww)
    return torch.stack([(boxes[:, 0] - wy0) * sy, (boxes[:, 1] - wx0) * sx,
                        boxes[:, 2] * sy, boxes[:, 3] * sx], dim=1)


def _crop_ids(ids, windows, s: int):
    """Nearest crop of an integer map through fp32, back to int32."""
    return boxcomposite.crop_resize(ids[..., None].to(torch.float32), windows, (s, s),
                                    method="nearest")[..., 0].to(torch.int32)


class TwoStepPipeline:
    """Composes a ``BoxToMaskModel`` and a ``Pix2PixHDModel`` (mask2image,
    with the masked-image conditioning), each under its own precision."""

    def __init__(self, b2m_model, m2i_model, context_margin: float = 2.0):
        if b2m_model.device != m2i_model.device:
            raise ValueError(f"the stages are on {b2m_model.device} and {m2i_model.device}")
        self.b2m = b2m_model
        self.m2i = m2i_model
        self.margin = context_margin
        self.crop_size = b2m_model.opt.fineSize
        self.m2i_size = m2i_model.opt.fineSize

    @torch.inference_mode()
    def manipulate(self, image, label, inst, boxes, cls, mode: str = "add") -> Dict[str, torch.Tensor]:
        """image (B,H,W,3) in [-1,1]; label, inst (B,H,W) int; boxes (B,4)
        fp32 (y0,x0,h,w) object boxes; cls (B,) int target classes; all on
        the models' device.

        Returns the completed full-resolution label map, the edited photo,
        the edited instance map (which a chained edit consumes) and the
        window tensors: the completed window layout, the window instance
        conditioning, the rendered window, the object mask and the
        windows."""
        if mode not in ("add", "remove"):
            raise ValueError(f"mode must be 'add' or 'remove', got {mode!r}")
        label = label.to(torch.int32)
        inst = inst.to(torch.int32)
        cls = cls.to(torch.int32)
        boxes = boxes.to(torch.float32)
        hw = tuple(label.shape[1:3])
        s = self.crop_size
        windows = boxcomposite.expand_to_context_window(boxes, hw, self.margin, out_size=s)

        # 1-3. the window's layout, the box in window coordinates, the
        # structure generator
        label_win = _crop_ids(label, windows, s)
        boxmask = boxcomposite.box_mask(_window_box(boxes, windows, s), (s, s))
        # remove: the null class -1, whose one-hot is all zeros
        cls_for_g = torch.full_like(cls, -1) if mode == "remove" else cls
        with precision_scope(self.b2m):
            merged_probs, obj_mask, ctx_probs = self.b2m.inference(
                {"masked_layout": label_win, "boxmask": boxmask, "cls": cls_for_g},
                return_ctx=True)
        # remove fills from the context stream: under the null class the
        # merged map is all zeros wherever the mask saturates to 1, and its
        # argmax would tie to class 0. argmax takes the first of ties, as
        # jnp.argmax does.
        fill_probs = ctx_probs if mode == "remove" else merged_probs
        pred_win_ids = torch.where(boxmask[..., 0] > 0, torch.argmax(fill_probs, dim=-1),
                                   label_win).to(torch.int32)

        # 4. the window layout pasted back into the box of the full map
        full_pred = boxcomposite.paste_resize(
            label[..., None].to(torch.float32), pred_win_ids[..., None].to(torch.float32),
            windows, method="nearest")[..., 0].to(torch.int32)
        box_full = boxcomposite.box_mask(boxes, hw)[..., 0] > 0
        completed_label = torch.where(box_full, full_pred, label)

        # 5. the image generator on the window: the completed layout, the
        # masked photo, and the instance conditioning of training: real ids
        # outside the box, label ids inside it, and a fresh thing id
        # (cls*1000+999) on the added object
        ms = self.m2i_size
        layout_m2i = _crop_ids(completed_label, windows, ms)
        rgb_win = boxcomposite.crop_resize(image, windows, (ms, ms), method="bilinear")
        box_m2i = _window_box(boxes, windows, ms)
        inst_win = _crop_ids(inst, windows, ms)
        in_box = boxcomposite.box_mask(box_m2i, (ms, ms))[..., 0] > 0
        new_id = cls[:, None, None] * 1000 + 999
        inside_ids = layout_m2i
        if mode != "remove":
            inside_ids = torch.where(in_box & (layout_m2i == cls[:, None, None]), new_id,
                                     inside_ids)
        inst_m2i = torch.where(in_box, inside_ids, inst_win)
        with precision_scope(self.m2i):
            fake_win = self.m2i.inference(
                {"label": layout_m2i, "inst": inst_m2i, "image": rgb_win, "boxes": box_m2i})

        # 6. the rendered box region pasted back into the photo
        pasted = boxcomposite.paste_resize(image, fake_win, windows, method="bilinear")
        edited = torch.where(box_full[..., None], pasted, image)

        # the full-resolution instance map under the window's convention;
        # a chained edit (swap) must consume this one, since the original
        # still holds the removed object's id and its edge
        inside_full = completed_label
        if mode != "remove":
            inside_full = torch.where(box_full & (completed_label == cls[:, None, None]), new_id,
                                      inside_full)
        edited_inst = torch.where(box_full, inside_full, inst)

        return {
            "completed_label": completed_label,
            "edited_image": edited,
            "edited_inst": edited_inst,
            "window_layout": pred_win_ids,
            "window_inst": inst_m2i,
            "window_rgb": fake_win,
            "object_mask": obj_mask,
            "windows": windows,
        }

    def add_object(self, image, label, inst, boxes, cls):
        return self.manipulate(image, label, inst, boxes, cls, mode="add")

    def remove_object(self, image, label, inst, boxes):
        cls = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
        return self.manipulate(image, label, inst, boxes, cls, mode="remove")

    def swap_object(self, image, label, inst, old_boxes, new_boxes, cls):
        """Remove at the old box, then add at the new one; the add pass
        consumes the remove pass's edited_inst, so the deleted object's id
        (and its edge) is gone from the second window."""
        removed = self.remove_object(image, label, inst, old_boxes)
        return self.manipulate(removed["edited_image"], removed["completed_label"],
                               removed["edited_inst"], new_boxes, cls, mode="add")

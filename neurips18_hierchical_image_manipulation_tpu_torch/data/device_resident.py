"""Device-resident training data: upload the dataset once, then gather,
crop, flip and resample each batch on the card.

Counterpart of ``data/device_resident.py`` in the JAX package. Every sample
is resized on the host as the streaming loader resizes it (bicubic RGB,
nearest ids), stacked and copied to the device once; a batch is then a
gather of rows with the random fineSize crop and the left-right flip
applied in the same gather, so a step copies no pixels from the host.

The random draws are split from their use. ``sample_draws`` makes them
from a ``torch.Generator`` (the crop corner y ~ U[0, H - fine], x ~ U[0, W
- fine] and a fair flip coin, the laws of the host pipeline's
``get_params``), and ``sample_batch_impl`` applies given draws, so the
draws of any stream (``jax.random``'s in the tests) give the same batch.
The card's generator is not ``np.random``'s: resident batches are a
resample of the host pipeline's distribution, not its draws. With no crop
and no flip they are bit for bit the host pipeline's batches.

``bbox_batch_impl`` is the bbox-window form: the context windows are
worked out on the host once, with the streaming dataset's own rule, and a
batch crops them on the card, ids by the nearest rule of
``ops/boxcomposite.crop_resize`` (bit for bit the host loader's) and RGB by
its ``pil_bicubic`` resample (the host loader's PIL bicubic to within PIL's
8-bit fixed-point weights).

Stores keep compact dtypes: label uint8, image uint8, inst int32, or under
``--uint8_transfer`` the uint16 ids as int16 bit patterns (the card's
gather, flip and compare kernels do not all take uint16); a uint8 batch
hands inst out as a uint16 view of them, as the streaming loader does.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from PIL import Image

from ..ops import boxcomposite
from ..ops.nnops import ids_int32
from .bbox import _context_window, _scaled_box
from .transforms import _scale_width

# Share of the card's free memory the resident dataset may claim; the rest
# is the training working set. HIMAN_RESIDENT_HBM_FRACTION sets another.
_RESIDENT_HBM_FRACTION = 0.5


def _resident_hbm_fraction() -> float:
    env = os.environ.get("HIMAN_RESIDENT_HBM_FRACTION")
    if env:
        frac = float(env)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"HIMAN_RESIDENT_HBM_FRACTION must be in (0, 1], got {env!r}")
        return frac
    return _RESIDENT_HBM_FRACTION


def _hbm_budget_bytes(device) -> Optional[int]:
    """Free device memory in bytes: HIMAN_HBM_BUDGET_BYTES when set (the
    override, and the tests' seam), else what the card reports free; None
    on the CPU (no budget)."""
    env = os.environ.get("HIMAN_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return None


def _check_hbm_fit(nbytes: int, what: str, device) -> None:
    """Refuse a resident upload over its share of the device's free memory
    before it becomes an out-of-memory error halfway through the upload."""
    budget = _hbm_budget_bytes(device)
    if budget is None:
        return
    frac = _resident_hbm_fraction()
    allowed = int(budget * frac)
    if nbytes > allowed:
        raise RuntimeError(
            f"--device_resident_data: {what} need {nbytes / 1e9:.2f} GB of device "
            f"memory, over the {allowed / 1e9:.2f} GB resident budget ({frac:.0%} of "
            f"the {budget / 1e9:.2f} GB free; the rest is the training working set, "
            "and a smaller model may raise HIMAN_RESIDENT_HBM_FRACTION). Drop "
            "--device_resident_data to stream from the host, or shrink the "
            "resident set (--loadSize, --max_dataset_size). Override the budget "
            "with HIMAN_HBM_BUDGET_BYTES if the free memory is misread."
        )


def _resize_only(img: Image.Image, opt, method):
    """The streaming transform's resize (``transforms.apply_transform``)
    without its crop and flip, which run on the device."""
    if opt.resize_or_crop == "resize_and_crop":
        return img.resize((opt.loadSize, opt.loadSize), method)
    if opt.resize_or_crop.startswith("scale_width"):
        return _scale_width(img, opt.loadSize, method)
    return img


def _ids_store(inst: np.ndarray, u8: bool) -> np.ndarray:
    """Instance ids as stored: int32, or uint16 bits as int16 under u8."""
    return inst.astype(np.uint16).view(np.int16) if u8 else inst.astype(np.int32)


def _ids_out(t: torch.Tensor) -> torch.Tensor:
    """A stored id plane as a batch hands it out: int16 bits as uint16."""
    return t.view(torch.uint16) if t.dtype == torch.int16 else t


def _upload(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def sample_draws(n: int, hw, fine: int, do_crop: bool, do_flip: bool,
                 generator: torch.Generator, device):
    """(ys, xs, coin) for n samples from ``generator``, in that order: the
    crop corners y ~ U[0, H - fine], x ~ U[0, W - fine] (zeros without a
    crop) and a fair flip coin (all False without a flip)."""
    h, w = hw
    if do_crop:
        ys = torch.randint(0, max(h - fine, 0) + 1, (n,), generator=generator, device=device)
        xs = torch.randint(0, max(w - fine, 0) + 1, (n,), generator=generator, device=device)
    else:
        ys = xs = torch.zeros(n, dtype=torch.int64, device=device)
    if do_flip:
        coin = torch.rand(n, generator=generator, device=device) < 0.5
    else:
        coin = torch.zeros(n, dtype=torch.bool, device=device)
    return ys, xs, coin


def sample_batch_impl(data, idx, ys, xs, coin, fine, do_crop, do_flip, as_float):
    """Gather rows ``idx`` of the stores with the given crop corners and
    flip coins (JAX ``sample_batch_impl``, ``:135-183``): one gather per
    plane, the window's columns reversed where the coin is set. Returns the
    batch in the dtypes the train step takes: the stores' uint8 label and
    image and uint16 (or int32) inst, or under ``as_float`` the image in
    [-1, 1] fp32 and int32 ids."""
    idx = idx.to(torch.int64)
    if do_crop or do_flip:
        h, w = data["label"].shape[1:3]
        oh, ow = (fine, fine) if do_crop else (h, w)
        rows = ys.to(torch.int64)[:, None] + torch.arange(oh, device=idx.device)
        j = torch.arange(ow, device=idx.device)
        cols = torch.where(coin[:, None], ow - 1 - j, j) if do_flip else j[None].expand(
            idx.shape[0], ow)
        cols = xs.to(torch.int64)[:, None] + cols
        sel = (idx[:, None, None], rows[:, :, None], cols[:, None, :])
        batch = {k: v[sel] for k, v in data.items()}
    else:
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
    batch["inst"] = _ids_out(batch["inst"])
    if as_float:
        if "image" in batch:  # label-only dataroots have no image planes
            batch["image"] = batch["image"].to(torch.float32) / 127.5 - 1.0
        batch["label"] = batch["label"].to(torch.int32)
        batch["inst"] = ids_int32(batch["inst"])
    return batch


class DeviceResidentLoader:
    """The streaming ``data.loader.DataLoader`` over an ``AlignedDataset``,
    with the dataset on the device. The train loop takes its
    ``fused_sampler``; iterating it (an epoch: a host shuffle of the
    indices and, a batch, one index copy and one gather on the card) is
    the streamed path's input where the image pool splits the step, and
    its draws continue a stateful generator, so that resume is not exact."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0, drop_last=True,
                 device="cpu"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        opt = dataset.opt
        self.fine = int(getattr(opt, "fineSize", 0))
        self.do_flip = bool(getattr(opt, "isTrain", True)) and not getattr(opt, "no_flip", False)
        self.u8 = bool(getattr(opt, "uint8_transfer", False))
        self._gen = torch.Generator(self.device).manual_seed(seed ^ 0x5EED)
        self.data = self._materialize()
        h, w = self.data["label"].shape[1:3]
        self.do_crop = "crop" in getattr(opt, "resize_or_crop", "none") and (
            h > self.fine or w > self.fine)

    def _load_base(self, i) -> Dict[str, np.ndarray]:
        ds, opt = self.dataset, self.dataset.opt
        label = np.asarray(_resize_only(ds._open(ds.label_paths[i]), opt, Image.NEAREST))
        label = label.astype(np.uint8)
        if label.ndim == 3:
            label = label[..., 0]
        out = {"label": label}
        if ds.inst_paths is not None:
            inst = np.asarray(_resize_only(ds._open(ds.inst_paths[i]), opt, Image.NEAREST))
            if inst.ndim == 3:
                inst = inst[..., 0]
        else:
            inst = np.zeros_like(label)
        out["inst"] = _ids_store(inst, self.u8)
        if ds.image_paths is not None:
            rgb = _resize_only(ds._open(ds.image_paths[i]).convert("RGB"), opt, Image.BICUBIC)
            out["image"] = np.asarray(rgb, np.uint8)
        return out

    def _materialize(self):
        n = len(self.dataset)
        samples = [self._load_base(i) for i in range(n)]
        stacked = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        opt = self.dataset.opt
        if "crop" in getattr(opt, "resize_or_crop", "none") and self.fine > 0:
            h, w = stacked["label"].shape[1:3]
            if (h > self.fine or w > self.fine) and (h < self.fine or w < self.fine):
                # the host crop (transforms._crop) of a fineSize square past
                # the short side reads PIL's zero fill: pad bottom / right
                ph, pw = max(self.fine - h, 0), max(self.fine - w, 0)
                for k, v in stacked.items():
                    pads = ((0, 0), (0, ph), (0, pw)) + (((0, 0),) if v.ndim == 4 else ())
                    stacked[k] = np.pad(v, pads)
        nbytes = sum(v.nbytes for v in stacked.values())
        _check_hbm_fit(nbytes, f"{n} resident samples", self.device)
        print(f"[device-resident] uploading {n} samples, {nbytes / 1e6:.0f} MB to "
              f"{self.device} (one-time)")
        return _upload(stacked, self.device)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    @property
    def n_samples(self) -> int:
        return len(self.dataset)

    def _sample(self, data, idx, generator):
        ys, xs, coin = sample_draws(idx.shape[0], data["label"].shape[1:3], self.fine,
                                    self.do_crop, self.do_flip, generator, idx.device)
        return sample_batch_impl(data, idx, ys, xs, coin, self.fine, self.do_crop,
                                 self.do_flip, as_float=not self.u8)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            sel = torch.as_tensor(idx[b * self.batch_size: (b + 1) * self.batch_size],
                                  device=self.device)
            yield self._sample(self.data, sel, self._gen)

    def fused_sampler(self):
        """(sample_fn, data) for the fused resident step
        (``train/steps.make_resident_train_step``): sample_fn(data, idx,
        generator) -> batch, drawing from ``generator``."""
        return self._sample, self.data


def bbox_batch_impl(base, recs, idx, s, u8):
    """A bbox-window batch on the device (JAX ``bbox_batch_impl``,
    ``:320-379``): the records' scenes gathered, their context windows
    cropped to s x s (ids nearest, RGB pil_bicubic), the box and object
    masks rasterized."""
    idx = idx.to(torch.int64)
    img_idx = recs["image_index"][idx].to(torch.int64)
    windows, boxes = recs["window"][idx], recs["box"][idx]
    cls, inst_id = recs["cls"][idx], recs["inst_id"][idx]
    gt_layout = boxcomposite.crop_resize(base["label"][img_idx][..., None], windows, (s, s),
                                         method="nearest")[..., 0]
    inst_win = boxcomposite.crop_resize(base["inst"][img_idx][..., None], windows, (s, s),
                                        method="nearest")[..., 0]
    inst_win = _ids_out(inst_win)
    boxmask = boxcomposite.box_mask(boxes, (s, s))
    gt_objmask = (ids_int32(inst_win) == inst_id[:, None, None]).to(torch.float32)[
        ..., None] * boxmask
    out = {"gt_layout": gt_layout, "masked_layout": gt_layout, "boxmask": boxmask,
           "gt_objmask": gt_objmask, "cls": cls, "boxes": boxes, "label": gt_layout,
           "inst": inst_win}
    if "image" in base:
        rgb = boxcomposite.crop_resize(base["image"][img_idx], windows, (s, s),
                                       method="pil_bicubic")
        out["image"] = (torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8) if u8
                        else rgb / 127.5 - 1.0)
    if not u8:
        ids = gt_layout.to(torch.int32)
        out.update(gt_layout=ids, masked_layout=ids, label=ids, inst=inst_win.to(torch.int32))
    return out


class DeviceResidentBboxLoader:
    """``BboxCropDataset`` with its scenes on the device: the records'
    context windows and scaled boxes are worked out on the host once (the
    streaming dataset's own rules, so ``boxes`` are bit for bit its
    ``boxes``), and a batch crops them on the card."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0, drop_last=True,
                 device="cpu"):
        if getattr(dataset, "bg_every", 0):
            # the resident records are the object boxes only: a background
            # box is placed by the streaming dataset's host search per sample
            raise ValueError(
                "--device_resident_data does not draw --bg_box_prob's background boxes; "
                "drop one of the two")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        self.s = dataset.size
        self.u8 = bool(getattr(dataset.opt, "uint8_transfer", False))
        self.base_data, self.rec_data = self._materialize()

    def _materialize(self):
        ds = self.dataset
        n = len(ds.base)
        rows = [ds.base[i] for i in range(n)]
        base = {"label": np.stack([r["label"] for r in rows]).astype(np.uint8),
                "inst": _ids_store(np.stack([r["inst"] for r in rows]), self.u8)}
        if "image" in rows[0]:
            imgs = []
            for r in rows:
                im = r["image"]
                if im.dtype != np.uint8:
                    # the exact inverse of normalize_rgb
                    im = np.clip((im + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)
                imgs.append(im)
            base["image"] = np.stack(imgs)
        hw = base["label"].shape[1:3]
        win, box, iidx, cls, inst_id = [], [], [], [], []
        for rec in ds.records:
            wy0, wx0, wh, ww = _context_window(rec["bbox"], hw, ds.margin, ds.size)
            win.append((wy0, wx0, wh, ww))
            box.append(_scaled_box(rec["bbox"], wy0, wx0, wh, ww, ds.size))
            iidx.append(rec["image_index"])
            cls.append(rec["cls"])
            inst_id.append(rec["inst_id"])
        recs = {"window": np.asarray(win, np.float32), "box": np.asarray(box, np.float32),
                "image_index": np.asarray(iidx, np.int32), "cls": np.asarray(cls, np.int32),
                "inst_id": np.asarray(inst_id, np.int32)}
        nbytes = sum(v.nbytes for v in base.values()) + sum(v.nbytes for v in recs.values())
        _check_hbm_fit(nbytes, f"{n} resident base planes", self.device)
        print(f"[device-resident] uploading {n} base samples ({len(ds.records)} records), "
              f"{nbytes / 1e6:.0f} MB to {self.device}")
        return _upload(base, self.device), _upload(recs, self.device)

    def __len__(self):
        n = len(self.dataset.records) // self.batch_size
        if not self.drop_last and len(self.dataset.records) % self.batch_size:
            n += 1
        return n

    @property
    def n_samples(self) -> int:
        return len(self.dataset.records)

    def _draw(self, idx):
        return bbox_batch_impl(self.base_data, self.rec_data,
                               torch.as_tensor(idx, device=self.device), self.s, self.u8)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = np.arange(len(self.dataset.records))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            yield self._draw(idx[b * self.batch_size: (b + 1) * self.batch_size])

    def fused_sampler(self):
        """(sample_fn, data) for the fused resident step; a bbox batch draws
        nothing (its windows are fixed), so the generator goes unused."""
        s, u8 = self.s, self.u8

        def sample(data, idx, generator):
            base, recs = data
            return bbox_batch_impl(base, recs, idx, s, u8)

        return sample, (self.base_data, self.rec_data)

"""Config layer — dataclasses mirroring the reference's argparse flags 1:1
(counterpart of ``configs/options.py`` in the JAX package, test side).

Flag names and defaults are the JAX package's, so a command line works
for either package. ``parse()`` creates ``{checkpoints_dir}/{name}`` and
writes ``opt.txt`` and ``config.json`` like ``BaseOptions.parse``.

Device: ``--gpu_ids -1`` runs on the CPU; any other value asks for that
CUDA device and fails without one (models/factory.resolve_device). Flags
that select a path not ported yet are accepted and refused where the
path would start.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class BaseOptions:
    # experiment
    name: str = "label2city"
    gpu_ids: str = "0"  # "-1" = CPU; else the first id is the CUDA device
    checkpoints_dir: str = "./checkpoints"
    model: str = "pix2pixHD"
    norm: str = "instance"
    use_dropout: bool = False
    data_type: int = 32
    verbose: bool = False

    # input/output sizes
    batchSize: int = 1
    loadSize: int = 1024
    fineSize: int = 512
    label_nc: int = 35
    input_nc: int = 3
    output_nc: int = 3

    # data
    dataroot: str = "./datasets/cityscapes/"
    resize_or_crop: str = "scale_width"
    serial_batches: bool = False
    no_flip: bool = False
    nThreads: int = 2
    max_dataset_size: int = 2**31 - 1
    data_backend: str = "threads"  # only "threads" is ported
    grain_workers: int = 0
    decode_cache: bool = False  # decode-once .npy sidecars (data/cityscapes.py)
    ram_cache_mb: int = 0  # in-RAM decoded-array cache budget (MB)
    uint8_transfer: bool = False  # ship uint8 images, normalize on device
    device_prefetch: int = 0
    device_resident_data: bool = False  # not ported yet
    fused_resident_step: bool = True

    # display
    display_winsize: int = 512
    tf_log: bool = False

    # generator
    netG: str = "global"
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_local_enhancers: int = 1
    n_blocks_local: int = 3
    niter_fix_global: int = 0

    # instance-feature encoder (--instance_feat / --label_feat)
    no_instance: bool = False
    instance_feat: bool = False
    label_feat: bool = False
    feat_num: int = 3
    load_features: bool = False
    n_downsample_E: int = 4
    nef: int = 16
    n_clusters: int = 10

    # numerics and run control
    dtype: str = "float32"
    # auto -> 'default' (TF32 allowed) under --dtype bfloat16, 'highest'
    # (full fp32 convolutions) otherwise; see models/factory.py
    conv_precision: str = "auto"
    no_pallas: bool = False  # accepted; no effect here (models/factory.py)
    mesh_devices: int = 0
    seed: int = 0
    debug_nans: bool = False
    remat: bool = False
    remat_policy: str = "none"

    isTrain: bool = field(default=False, init=False)

    def parse(self, save=True):
        """Create {checkpoints_dir}/{name}, dump opt.txt (+config.json)."""
        # the reference's --data_type 16 asked for half precision
        if self.data_type == 16 and self.dtype == "float32":
            self.dtype = "bfloat16"
        expr_dir = os.path.join(self.checkpoints_dir, self.name)
        os.makedirs(expr_dir, exist_ok=True)
        if save:
            args = dataclasses.asdict(self)
            with open(os.path.join(expr_dir, "opt.txt"), "w") as f:
                f.write("------------ Options -------------\n")
                for k in sorted(args):
                    f.write(f"{k}: {args[k]}\n")
                f.write("-------------- End ----------------\n")
            with open(os.path.join(expr_dir, "config.json"), "w") as f:
                json.dump(args, f, indent=2, default=str)
        return self


@dataclass
class TrainOptions(BaseOptions):
    # frequencies
    display_freq: int = 100
    print_freq: int = 100
    save_latest_freq: int = 1000
    save_epoch_freq: int = 10
    no_html: bool = False
    debug: bool = False

    # resume
    continue_train: bool = False
    load_pretrain: str = ""
    which_epoch: str = "latest"
    phase: str = "train"

    # schedule: constant lr for niter epochs, then linear decay
    niter: int = 100
    niter_decay: int = 100
    beta1: float = 0.5
    lr: float = 0.0002

    profile_dir: str = ""

    # losses
    lambda_feat: float = 10.0
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = False
    no_lsgan: bool = False

    # discriminators
    num_D: int = 2
    n_layers_D: int = 3
    ndf: int = 64
    pool_size: int = 0

    def __post_init__(self):
        self.isTrain = True


# training flags whose path is not ported yet: (flag, is it set?, where it
# is queued in ROADMAP.md)
_TRAIN_NOT_PORTED = (
    ("--mesh_devices > 1", lambda o: o.mesh_devices > 1, "data parallel, ROADMAP.md §A.6"),
    ("--device_resident_data", lambda o: o.device_resident_data,
     "device-resident data, ROADMAP.md §A.7"),
    ("--device_prefetch > 0", lambda o: o.device_prefetch > 0, "prefetch, ROADMAP.md §A.7"),
    ("--use_dropout", lambda o: o.use_dropout,
     "dropout in training (ROADMAP.md §A.1), whose mask has yet to be held against the "
     "JAX package's"),
    ("--remat / --remat_policy", lambda o: o.remat or o.remat_policy != "none",
     "recomputation, ROADMAP.md §A.9 (tooling)"),
    ("--debug_nans", lambda o: o.debug_nans, "tooling, ROADMAP.md §A.9"),
    ("--profile_dir", lambda o: bool(o.profile_dir), "torch.profiler tooling, ROADMAP.md §A.9"),
)


def check_train_options(opt) -> None:
    """Refuse every training flag whose path is not ported yet, naming
    where it waits, rather than ignoring it."""
    for flag, is_set, where in _TRAIN_NOT_PORTED:
        if is_set(opt):
            raise NotImplementedError(f"{flag} is not ported yet: it waits for {where}")


@dataclass
class MaskToImageTrainOptions(TrainOptions):
    """mask2image: pix2pixHD conditioned on the box-masked RGB as well, so
    the generator inpaints the box region; trained on bbox context
    windows."""

    model: str = "pix2pixHD"
    use_masked_image: bool = True
    use_bbox_dataset: bool = True
    contextMargin: float = 2.0
    min_box_size: int = 16
    max_box_size: int = 10_000


@dataclass
class BoxToMaskTrainOptions(TrainOptions):
    """box2mask: the two-stream structure generator on bbox context-window
    crops, with the layout discriminator (JAX ``configs/options.py:243-282``).
    ``objReconLoss`` is accepted; the object stream's loss is the BCE
    whatever it says, as in the JAX package."""

    model: str = "box2mask"
    netG: str = "twostream"
    fineSize: int = 128            # the square context-window crop
    contextMargin: float = 2.0     # context window = margin x the object box
    min_box_size: int = 16
    max_box_size: int = 10_000
    n_downsample_global: int = 3
    n_blocks_global: int = 4
    lambda_recon: float = 10.0     # per-pixel CE and object BCE weight
    no_vgg_loss: bool = True
    no_instance: bool = True
    # every ~1/p-th sample a background box: null class, empty object mask
    # (data/bbox.py); 0 disables
    bg_box_prob: float = 0.0
    # weight of -log(1 - p_own_class) on the context stream at object
    # pixels (models/box2mask.py); 0 disables
    lambda_ctx_neg: float = 0.0
    objReconLoss: str = "bce"
    num_D: int = 1


@dataclass
class TestOptions(BaseOptions):
    ntest: int = 2**31 - 1
    results_dir: str = "./results/"
    aspect_ratio: float = 1.0
    phase: str = "test"
    which_epoch: str = "latest"
    how_many: int = 50
    cluster_path: str = "features_clustered_010.npy"
    use_encoded_image: bool = False

    def __post_init__(self):
        self.isTrain = False
        # the reference test.py hardcodes these: galleries walk the
        # dataset in file order, one image at a time
        self.serial_batches = True
        self.batchSize = 1
        self.nThreads = 1


@dataclass
class MaskToImageTestOptions(TestOptions):
    model: str = "pix2pixHD"
    use_masked_image: bool = True
    use_bbox_dataset: bool = True
    contextMargin: float = 2.0
    min_box_size: int = 16
    max_box_size: int = 10_000
    spatial_shards: int = 0  # W-sharded inference: not ported yet


@dataclass
class BoxToMaskTestOptions(TestOptions):
    model: str = "box2mask"
    netG: str = "twostream"
    fineSize: int = 128
    contextMargin: float = 2.0
    min_box_size: int = 16
    max_box_size: int = 10_000
    no_instance: bool = True


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool) or isinstance(default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(
                f"--{f.name}", dest=f.name, action="store_true", default=default
            )
            # negation so True-default booleans stay reachable
            group.add_argument(f"--no-{f.name}", dest=f.name, action="store_false")
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(f"--{f.name}", type=typ, default=default)


def parse_cli(cls, argv: Optional[List[str]] = None):
    """argparse front-end over a dataclass config (the reference's
    ``python test.py --name x ...`` surface)."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    _add_dataclass_args(parser, cls)
    ns, _unknown = parser.parse_known_args(argv)
    opt = cls(**{k: v for k, v in vars(ns).items() if v is not None})
    return opt.parse()

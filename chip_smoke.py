"""Drive the PyTorch port's mask2image and box2mask serving and training
paths, the two-step edit pipeline, the evaluators, the 1024p coarse-to-fine
generator, the instance features, the device-resident data path, the grain
host pipeline, data parallelism, resblock recomputation, W-sharded
inference and the user-facing tools (checkpoint conversion, the parity
runbook, inference export, the procedural-world training runs) and the
measurement tools on one CUDA card, and hold each train path's gradients
to the same step on the CPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, run in the order 1-4, 9, 13, 19, 5, 6, 10, 11, 14, 16, 17, 18, 20,
22, 24-27, 31-37, 39, 28, 7, 8, 12, 15, 21, 23, 29, 30, 38 (any failure
raises and the script exits non-zero):
  1. device   needs a CUDA card; prints its name and power limit
  2. build    compiles every csrc/*.cu with nvcc for sm_90a (one nvcc per
              source) and csrc/dataio.cpp (the host data tier) with g++, all
              at once, and prints the -Xptxas -v register/smem lines; the
              native data tier must build
  3. kernels  at the serving shapes (512x256, bs 1 and 8; fp32 and bf16)
              each serving kernel against its plain PyTorch version on the
              card: encode bit-exact in both pad modes, IN at the 5
              generator shapes (bs 1 and 8), the 6 discriminator shapes (N
              1 and 2) and three odd ones x 3 acts x residual within the
              stated tolerance, each call on the variant
              kernels/instance_norm._fwd_plan picks (cluster or split) and
              the same bits on a second run; CUDA-event times of kernel,
              plain version and, for IN, the library call F.instance_norm
              (a yardstick only)
  4. kernels (train)  each training kernel against its plain version, fp32
              and bf16: the IN backward at the 5 generator and 6
              discriminator shapes of a 512x256 step (N 1 and 2) and a tiny
              odd one x 3 acts x residual, each call on the variant
              kernels/instance_norm._bwd_plan picks (cluster or split) and
              the same bits on a second run, and the wrapper's host time a
              call (1000 calls); the reflect-pad backward at the resblock and head
              pads, one tile with overlapping mirrors and two odd channel
              counts, each on the variant kernels/reflect_pad._plan picks
              (bulk or gather), the same bits on a second run; the reflect-pad
              forward at every pad site of the benchmark's cells, bit for bit
              the plain pad twice on the variant kernels/reflect_pad._fwd_plan
              picks (wide or narrow), timed beside its byte bound; MSE/L1 at
              the D-logit, FM-feature and VGG-tap sizes (each a group of one), encode_cond
              at 512x256; times beside the library call; the loss groups'
              backward over the flagship's 4 groups (bs 32, 512x512 windows:
              6 MSE + 13 L1 terms), the same bits as its plain version, one
              launch a group, kernel and plain version timed
  5. serving  (main path 1) the port's mask2image_test CLI end to end at
              full width (label_nc 35, ngf 64, 4 downs, 9 resblocks at 1024
              channels, bbox-crop windows at fineSize 512) on a seeded
              synthetic PNG dataroot of 4 images at 1024x512; launch
              counters are zeroed just before and read just after, the IN
              forward's per variant held to _fwd_plan
  6. train CLI  (main path 2) the port's mask2image_train CLI at full width
              (G as above, 2-scale 3-layer PatchGAN, VGG19, LSGAN + FM +
              VGG, Adam) on the same kind of dataroot, bs 1, one epoch;
              counters zeroed before and read after, and held to the
              per-step launch counts of the architecture (the loss kernel:
              terms reduced, and group launches, one a loss), the IN
              forward's, the IN backward's and the reflect-pad backward's
              per variant to their plans' split of the recorded calls; every loss
              finite; latest_params.npz loaded back into the serving model
              for one inference
  7. model    Pix2PixHDModel.inference at 512x256 fp32 (bs 1 and 8): kernel
              path vs plain path (max |diff| of the tanh output), ms/image,
              images/s, peak memory; one --norm batch forward at 256x128
              (the pad-0 encode mode)
  8. step     make_train_step at 512x256 fp32, bs 1 and 4: ms/step,
              images/s, peak memory, the plain path's ms/step, per-variant
              launches of one step against the plans (the loss groups
              against the architecture's count); from the same
              parameters one step's loss terms and every G/D gradient
              leaf on the kernel path against the plain path
  9. conv_in  the fused conv3x3 + IN kernel against its plain version, fp32
              and bf16, at the generator bottleneck (1, 16, 32, 1024) with
              and without residual and ReLU, an odd shape, the JAX test
              shape and the wgmma kernel's cases (CONV_IN_SHAPES), each call
              on the variant kernels/conv_in._plan picks; the same bits on a
              second run; its autograd gradient
              against the plain one; times beside the bound, the plain
              version and the library composition (reflect pad, cuDNN conv,
              F.instance_norm: no single PyTorch call computes it)
 10. train CLI bf16  (main path 3) the train CLI at full width under --dtype
              bfloat16 --pool_size 50 --display_freq 4 for one epoch, then
              --continue_train from its latest for a second; counters zeroed
              before and read after each run and held to the per-step counts
              of the pooled step, the loss groups among them; web/index.html,
              iter.txt
 11. roofline (main path 4) the port's resblock roofline tool at bs 32
              (tools/roofline_resblock.py, few iterations): counters zeroed
              before and read after; the fused kernel must have launched,
              every call as the wgmma variant, every pad's backward as the
              bulk variant
 12. step bf16  make_train_step in the bf16 tier at 512x256, bs 1 and 4:
              ms/step, images/s, peak memory, per-step launches of every
              kernel (per variant where a kernel has several); the IN
              forward, the reflect-pad backward and the loss groups timed
              over the calls of one bs-1 bf16 step
 13. box2mask kernels  rows 4-7 at box2mask's shapes: the calls one
              full-width box2mask train step (fineSize 128) makes of the IN
              forward and backward, the reflect-pad backward and the loss
              kernel, recorded at bs 1 and 2, fp32 and bf16; each distinct
              call against its plain version on the variant its plan picks,
              the same bits twice (the loss groups also as each term alone,
              D's fake logits off the 16-byte grid); the bs-1 fp32 step's
              calls timed
 14. box2mask CLIs  (main path 5) the box2mask_train CLI at full width with
              --bg_box_prob 0.25 --lambda_ctx_neg 5.0, bs 1, one epoch over
              phase 6's scenes: counters zeroed before and read after, held
              per step to the architecture's counts (IN 25 + 25, reflect-pad
              backward 10 and forward 11, 3 MSE terms in 2 loss launches) and
              per variant to the plans; every loss finite; a background-box sample drawn;
              then box2mask_test from its latest over phase 5's scenes:
              "restored checkpoint 'latest'", no partial load, the gallery,
              19 IN forwards a crop
 15. box2mask step  make_train_step on BoxToMaskModel at 128x128, bs 1 and
              16, fp32 and bf16: ms/step, crops/s, peak memory, per-step
              launches, the plain path's ms/step; the fp32 step's kernel path
              against its plain path (compare_step, the 1-ulp nudge on the
              parameters); inference at bs 1: ms/crop and merged probs
              against the plain path
 16. two-step demo  (main path 6) the two_step_demo CLI at full width:
              box2mask restored from phase 14's run, mask2image from phase
              6's, phase 5's 1024x512 scenes; --edit add, remove and swap,
              4 edits each, then one add with phase 10's bf16 run as the
              image stage. Counters zeroed before and read after each run
              and held per edit pass (a swap is two) to the architecture:
              the structure generator's 19 IN sites and the image
              generator's 27, in order and per variant as _fwd_plan picks,
              one encode at pad 3, every other kernel 0; each stage's
              inference under its own tier's TF32 switches; outside-box
              passthrough exactly 0; each gallery complete
 17. two-step pipeline  TwoStepPipeline on the same restored stages and
              scenes, bs 1 and 4, add / remove / swap: ms per edit (host
              clock, card synchronized), edits/s, peak memory, the plain
              path's ms; launches per pass as in phase 16; outside-box
              passthrough exactly 0; the same bits twice (cuDNN restricted
              to its deterministic algorithms); the kernel path
              against the plain path (integer maps equal except at pixels
              whose plain fill's top two probabilities are within
              TIE_MARGIN, counted; the images within TWO_STEP_ATOL)
 18. evaluate (main path 7) the evaluate CLI, --stage box2mask (phase 14's
              run) and --stage mask2image (phase 6's, VGG19 weights drawn
              from a seed through --feature_params) over phase 5's scenes,
              4 samples each: finite values and a positive FID, launches
              held to 19 IN forwards a crop, and 27 IN forwards and one
              encode a window; the JSON line each prints
 19. 1024p kernels  rows 1, 2 and 4-7 at the 1024p shapes: the calls one
              full-width LocalEnhancer train step at 1024x512 makes (the
              1024p recipe: ngf 32, its trunk at 64 with 4 downs and 9
              resblocks at 1024 channels, one enhancer of 3 resblocks, D of
              3 scales of 3 layers), recorded at bs 1 and 2, fp32 and bf16,
              each held to the architecture's count; each distinct call
              against its plain version on the variant its plan picks, the
              same bits twice (the encodes bit-exact); the bs-1 fp32 step's
              calls timed beside the bound and the library call, row 2 (the
              pad-0 encode) at (1, 512, 1024) among them
 20. 1024p CLIs  (main path 8) the train CLI with the recipe's flags,
              --load_pretrain from phase 6's run, --niter_fix_global 1, two
              epochs at bs 1 over phase 6's scenes: counters zeroed before
              and read after, held per step (IN 54 + 54, one pad-0 encode,
              25 pad backward, 9 MSE and 17 L1 terms in 2 + 2 launches) and
              per variant to the plans; load_pretrain's counts against the
              architecture's (75 loaded, 29 kept); every trunk parameter
              bit-for-bit the pretrained one after each step of epoch 1 and
              moved after the first of epoch 2; every loss finite. Then the
              serving CLI --netG local from its latest over phase 5's
              scenes: "restored checkpoint 'latest'", no partial load, the
              gallery, 36 IN forwards and one pad-0 encode a window
 21. 1024p step  make_train_step on the LocalEnhancer at 1024x512 (the step
              of tools/bench_1024p.py), bs 1 fp32 and bs 4 bf16: ms/step,
              images/s, peak memory, per-step launches per kernel and
              variant, the plain path's ms; the fp32 step's kernel path
              against its plain path (compare_step); inference at 1024x512
              fp32, bs 1 and 4, against the plain path within MODEL_ATOL
 22. instance features  (main path 9) the train CLI with --instance_feat
              (phase 6's GlobalGenerator, the Encoder at nef 16, 4 downs,
              feat_num 3), one epoch at bs 1: held per step to the counts
              with the Encoder's 9 + 9 IN sites and its pads (21 pad
              backward, the 42-channel stem's on the gather variant); the
              port's encode_features over the same scenes to a (35, 10, 3)
              clusters npy; the serving CLI with --cluster_path (4 windows,
              no partial load, 27 IN and one pad-0 encode a window);
              precompute_feature_maps, then one epoch of --load_features
              over the aligned scenes; counters zeroed before and read after
              each run
 24. resident train CLI  (main path 10) the train CLI with
              --device_resident_data over phase 6's scenes, one epoch at bs
              1: under --uint8_transfer (the uint16 ids on the card) with
              cuDNN deterministic, its mid-epoch latest copied aside, then
              --continue_train from it: losses and parameters bit for bit
              the straight run's; then --dtype bfloat16 --display_freq 4
              (the visuals from the fused step's batch); counters zeroed
              before and read after each run, held per step to the
              architecture and per variant to phase 6's launches a step; the
              latest weights served
 25. resident box2mask CLI  (main path 11) the box2mask train CLI with
              --device_resident_data (phase 14's flags but --bg_box_prob,
              which it refuses) and the same resume check; then the streamed
              CLI with --device_prefetch 2 against its synchronous run: every
              loss and parameter bit for bit; launches per variant a step
              those of phase 14
 26. dropout  (main path 12) the train CLI with --use_dropout for two
              epochs, --profile_dir tracing its 21st step (the trace file on
              disk), a dropout mask drawn for each resblock a step; a
              full-width dropout step's kernel path against its plain path
              with the same masks (compare_step) and the masks' keep rate
              (0.5 within 5 sigma) and scale (2)
 27. data measure  at phase 6's 512x512 windows, bs 1 and 4, fp32 and bf16:
              the streaming loader's wait in next() a batch (nThreads 2),
              the resident sampler's ms a batch, the fused resident step's
              ms against the streamed step's, the bytes a step copies host
              to device (the profiler's Memcpy HtoD), the device's idle
              share; extract_bboxes native against numpy (1024x512, 30
              objects)
 28. resident scale  the Cityscapes train split (2975 scenes at 1024x512)
              as a uint8 store made on the card: its bytes, the memory
              guard's verdict, a bs-4 draw at 512x512 timed
 29. remat    --remat_policy none, block and conv_out on the fp32 512x256
              bs-4 step and the bf16 1024x512 bs-4 step: the forward
              convolutions backward launches again (0, 2 a resblock, 0),
              every kernel's launches (the IN forward's recompute apart,
              equal to none's), losses and gradients against none's within
              2x none's 1-ulp sensitivity (bit-equality recorded), ms a
              step, peak memory
 30. debug_nans  a step fed a NaN pixel raises FloatingPointError before
              the optimizers step; a clean step trains
 31. parallel  the DP step at world size 1 over NCCL against the single
              step; then two gloo ranks sharing the card (rank_phase): the
              DP step at global bs 2, each rank's launches per kernel and
              variant those of a single-card bs-1 step, its mean gradients
              against the single-process step on the concatenated batch
              (2x the 1-ulp sensitivity); the resident DP step over phase
              6's scenes; the W-sharded GlobalGenerator and LocalEnhancer
              at SPATIAL_HW against their unsharded forwards (MODEL_ATOL),
              0 launches of the port's kernels; ms and per-rank peak
              memory, each time labelled with its transport
 32. DP CLI   (main path 13) the mask2image train CLI with --gpu_ids 0,0
              --mesh_devices 2 --device_resident_data: the CLI starts two
              gloo ranks on the card; one epoch; rank 0 alone writes the
              loss log, iter.txt and the checkpoint; losses finite
 33. spatial CLI  the serving CLI with --spatial_shards 2 over two gloo
              ranks on the card against phase 5's unsharded gallery (each
              synthesized PNG within one level)
 34. tools_convert  full-width pix2pixHD stand-ins (tools/parity_report
              --make_standins: label_nc 35, ngf 64, 4 downs, 9 resblocks,
              input_nc 36, VGG19), converted and rendered over phase 5's
              scenes by the parity runbook (4 windows, FID over the converted
              VGG19 finite; the render held to the serving counts); the
              converted G on the card against pix2pixHD's module run by
              cuDNN at 512x256 fp32 (MODEL_ATOL); preprocess_city_bboxes
              against extract_bbox_records; the converted VGG19 through
              evaluate.load_vgg bit for bit
 35. tools_export  both stages exported by tools/export_inference
              (mask2image at fineSize 512, box2mask at crop 128, bs 1):
              the himan:: ops in the graph; the .pt2 saved, reloaded and
              rerun under cudnn_deterministic(): rows 3 and 4 launched as
              one eager forward launches them, the output against eager's
              (bits, else max |diff|), ms at bs 1, bytes
 36. tools_dynamics  the procedural-world chain at full width, short:
              train_dynamics (bs 16, 16 steps), train_dynamics_b2m (40
              steps), two_step_gallery (40 m2i steps), two_step_metrics (8
              scenes), train_dynamics_1024p (4 + 4 steps over 16 scenes):
              every train CLI run held per step to its architecture's
              launches, every loss finite, the four passthroughs exactly 0
              in every scene, every summary written
 37. tools_measure  the measurement tools at cut sizes: bench_all (bs 2,
              the three inference configs and --with_1024p), bench_ablate
              (the six variants at the test widths, bs 2), bench_convt (the
              four up shapes, bs 2), roofline_step --collect --bench,
              trace_attrib and byte_ledger --saved --trace (the test
              widths, bs 2), profile_decode on trace_attrib's trace, and
              bench_torch_oracle at full width (bs 1): each run's launches
              against the calls it recorded and per variant against the
              plans; the tools whose port-kernel calls all come from train
              steps (roofline_step, trace_attrib, bench_ablate's full and
              no_vgg) against steps x the architecture's launches a step;
              the oracle and bench_convt launch none; every report written
 38. grads vs CPU  each train path's make_train_step step on the card (fp32,
              TF32 off, the kernels) against the same step on the CPU (the
              plain versions) from the same parameters and batch: the
              flagship, the 1024p LocalEnhancer (num_D 3), --instance_feat
              and box2mask; every G, D and E gradient per tensor (max
              |diff| / max |g|, flipped signs) within 2x the card's own
              spread (a repeat and a 1-ulp nudge) and under a cap, its
              ||diff|| / ||g|| under a fixed bar, the losses too; the bf16
              tier against the same CPU step by cosine, flipped signs and
              norm (the Encoder's tensors at 512x256 as the known miss of
              ROADMAP C.14, which must show); the serving forwards' outputs; on the flagship and
              1024p the pool as it was before the C.12 repair as a control
              that must miss (the DP, resident and remat steps are
              bit-equal to the single step, phases 29, 31)
 39. grain    (main paths 14 and 15) the grain pipeline (--data_backend
              grain, data/grain_pipeline.py): in serial mode its batches at
              --grain_workers 0 and 2 bit for bit the thread loader's over
              phase 6's scenes; the flagship train CLI at full width with
              --grain_workers 2 for one epoch (bs 1, shuffled), its
              mid-epoch latest resumed with --continue_train (losses and
              parameters bit for bit the straight run's), both held per
              step and per variant to the thread path's launches, the
              latest served; the box2mask train CLI with --grain_workers 2
              and --bg_box_prob 0.25 for one epoch; tools/bench_loop at
              phase 27's size, bf16 bs 4: threads, grain at 0, 2 and 4
              workers, prefetched, fused; every decode worker started
              without a CUDA context (a probe at worker_init_fn), and none
              in the parent's process
With --profile: torch.profiler tables of one serving forward, of train
steps at 512x256 bs 1, of a box2mask step at bs 1, of the 1024p step at bs
1 and of a two-step add at bs 1.
The last two lines of standard output are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._python_dispatch

from neurips18_hierchical_image_manipulation_tpu_torch.cli import (
    box2mask_test,
    box2mask_train,
    evaluate,
    mask2image_test,
    mask2image_train,
    two_step_demo,
)
from neurips18_hierchical_image_manipulation_tpu_torch.configs.options import (
    BoxToMaskTestOptions,
    BoxToMaskTrainOptions,
    MaskToImageTestOptions,
    MaskToImageTrainOptions,
    parse_cli,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data.bbox import (
    bboxes_from_instance_map,
    extract_bbox_records,
)
from neurips18_hierchical_image_manipulation_tpu_torch.data import grain_pipeline
from neurips18_hierchical_image_manipulation_tpu_torch.data.cityscapes import AlignedDataset
from neurips18_hierchical_image_manipulation_tpu_torch.data.loader import CreateDataLoader
from neurips18_hierchical_image_manipulation_tpu_torch.data.synthetic import (
    synthetic_batch,
    synthetic_box2mask_batch,
)
from neurips18_hierchical_image_manipulation_tpu_torch.eval.two_step import TwoStepPipeline
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import _build
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import calls as kcalls
from neurips18_hierchical_image_manipulation_tpu_torch.kernels.bounds import (
    bound,
    cond_bytes,
    conv_in_bound,
    encode_bytes,
    in_bwd_bytes,
    in_bytes,
    loss_bwd_bytes,
    loss_bytes,
    pad_bwd_bytes,
    pad_fwd_bytes,
)
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import conv_in as kconv
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import encode as kenc
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import instance_norm as kin
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import losses as klosses
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import ops as kops
from neurips18_hierchical_image_manipulation_tpu_torch.kernels import reflect_pad as krp
from neurips18_hierchical_image_manipulation_tpu_torch.models import networks
from neurips18_hierchical_image_manipulation_tpu_torch.models.box2mask import BoxToMaskModel
from neurips18_hierchical_image_manipulation_tpu_torch.models.factory import (
    create_model,
    precision_scope,
)
from neurips18_hierchical_image_manipulation_tpu_torch.models.pix2pixhd import Pix2PixHDModel
from neurips18_hierchical_image_manipulation_tpu_torch.ops import nnops
from neurips18_hierchical_image_manipulation_tpu_torch.ops.boxcomposite import (
    box_mask,
    crop_resize,
    expand_to_context_window,
    paste_resize,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools import grad_audit
from neurips18_hierchical_image_manipulation_tpu_torch.tools import (
    bench_ablate,
    bench_all,
    bench_convt,
    bench_torch_oracle,
    byte_ledger,
    convert_torch_checkpoint,
    encode_features,
    export_inference,
    load_vgg_weights,
    parity_report,
    pix2pixhd_format,
    precompute_feature_maps,
    preprocess_city_bboxes,
    profile_decode,
    roofline_resblock,
    roofline_step,
    trace_attrib,
    train_dynamics,
    train_dynamics_1024p,
    train_dynamics_b2m,
    two_step_gallery,
    two_step_metrics,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools.profile_decode import (  # noqa: F401
    KERNEL_CLASSES as KERNEL_KINDS,
    kernel_kind,
    profile_by_kind,
)
from neurips18_hierchical_image_manipulation_tpu_torch.tools.roofline_resblock import (
    cuda_ms,
    graph_ms,
)
from neurips18_hierchical_image_manipulation_tpu_torch.train import loop as train_loop
from neurips18_hierchical_image_manipulation_tpu_torch.train import steps as train_steps
from neurips18_hierchical_image_manipulation_tpu_torch.train.state import make_optimizers
from neurips18_hierchical_image_manipulation_tpu_torch.train.steps import (
    _loss_inputs,
    make_train_step,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    params_from_jax,
    restore_params,
)
from neurips18_hierchical_image_manipulation_tpu_torch.utils.visualizer import Visualizer

PKG = "neurips18_hierchical_image_manipulation_tpu_torch"
JAX_PKG = "neurips18_hierchical_image_manipulation_tpu"
# kernel vs plain version on the card
IN_FP32_ATOL = 1e-4         # Welford/Chan vs two-pass fp32 statistics
IN_BF16_RTOL = 2.0**-7      # one bf16 rounding of the same fp32 value may
IN_BF16_ATOL = 2.0**-7      # land one ulp apart when the stats differ
MODEL_ATOL = 1e-3           # tanh output after 27 IN sites, full-fp32 convs
# training kernels vs their plain versions: the same fp32 arithmetic summed
# in another order (bf16: one rounding of nearly equal fp32 values)
IN_BWD_FP32_ATOL = 1e-5     # dx is O(1) here
PAD_FP32_ATOL = 1e-5        # sums of at most 9 O(1) values
LOSS_RTOL = 1e-5            # one fp32 sum of up to 8.4M terms, other order
BF16_RTOL = BF16_ATOL = 2.0**-7
# the whole step, kernel path vs plain path, from the same parameters, with
# full-fp32 deterministic convolutions (see compare_step):
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-4        # one backward kernel swapped for its plain version,
                            # of each gradient leaf's max |g| (measured <= 1e-5)
STEP_SENS_FACTOR = 2.0      # the whole path, against the 1-ulp sensitivity
# conv3x3_in_act vs its plain version: fp32, the same conv and two-pass
# statistics summed in another order (the JAX Pallas test's tolerance);
# bf16, two ulps of max(|y|, 1) against the plain version on the fp32 values
# of the same bf16 inputs (the plain version in bf16 rounds the pre-norm
# conv to bf16 before the statistics, which the kernel never does)
CONV_IN_ATOL, CONV_IN_RTOL = 3e-5, 1e-4
CONV_IN_BF16_ULPS = 2
# (N, H, W, Cin, Cout): the bottleneck at bs 1 (bf16: the mma.sync kernel;
# fp32: K split 8 ways, three launches), an odd shape (fp32: 2 tiles, the
# two-launch epilogue), the JAX test shape, channel counts that are
# not multiples of 8 (the mma kernel's scalar loads); for the wgmma kernel
# (kernels/conv_in._plan): the bottleneck at bs 4 (a 4-block cluster), H*W
# not a multiple of 128 with Cin not one of 64 (9x17, 96 -> 40: 2-block
# clusters), and H*W > 1024 (16 tiles: the two-launch epilogue, in fp32 too);
# channel counts that are not multiples of 4 (the fp32 kernel's 4-byte
# copies, a plane of one tile). The roofline path checks bs 32.
CONV_IN_SHAPES = [(1, 16, 32, 1024, 1024), (2, 9, 17, 96, 40), (2, 8, 16, 128, 128),
                  (1, 5, 7, 12, 20), (4, 16, 32, 1024, 1024), (64, 9, 17, 96, 40),
                  (16, 32, 48, 64, 64), (1, 6, 9, 7, 10)]
ROOFLINE_ARGV = ["--batch", "32", "--iters", "5", "--warmup", "2"]
SHAPES_512x256 = [(256, 512, 64), (128, 256, 128), (64, 128, 256), (32, 64, 512),
                  (16, 32, 1024)]
# the IN sites of one D apply at 512x256 (scale 0, then scale 1)
D_SHAPES_512x256 = [(65, 129, 128), (33, 65, 256), (34, 66, 512),
                    (33, 65, 128), (17, 33, 256), (18, 34, 512)]
STEP_HW = (256, 512)
DATAROOT_HW = (512, 1024)
GPU_IDS = "0"
ARCH = {}        # model overrides (empty: the full-width defaults)
ARCH_ARGV = []   # the same as CLI flags
# box2mask (BoxToMaskTrainOptions' full width: label_nc 35, ngf 64, 3 downs, 4
# resblocks at 512 channels, 3-layer layout D at ndf 64, fineSize 128)
B2M_ARCH = {}        # generator overrides (empty: the full-width defaults)
# the train options' depth, which the test options (base depth 4 / 9, as in
# the JAX package) are given
B2M_DEPTH = {"n_downsample_global": 3, "n_blocks_global": 4}
B2M_STEP_BS = ((1, 10), (16, 4))     # (batch, timed steps) of phase 15
B2M_PROBS_ATOL = 1e-3                # merged probs after 19 IN sites, full-fp32 convs
# the two-step pipeline (phase 17): (batch, timed edits); the kernel path
# against the plain path: the images after both generators, full-fp32
# convolutions (MODEL_ATOL's bound, through the structure generator's
# probabilities too); the fill margin below which the two paths may pick
# either of the top two classes
TWO_STEP_BS = ((1, 5), (4, 3))
TWO_STEP_ATOL = MODEL_ATOL
TIE_MARGIN = 1e-5
# the 1024p recipe (scripts/train_mask2image_city_1024p.sh): the LocalEnhancer
# at ngf 32 (its trunk at 64: 4 downs, 9 resblocks at 1024 channels), one
# enhancer of 3 resblocks; D of 3 scales of 3 layers; steps at 1024x512, the
# shape of tools/bench_1024p.py: (batch, dtype, timed steps), inference
# (batch, timed forwards)
LOCAL_G = {"netG": "local", "ngf": 32, "n_local_enhancers": 1, "n_blocks_local": 3}
LOCAL_D = {"num_D": 3, "n_layers_D": 3}
LOCAL_ARGV = ["--loadSize", "1024", "--fineSize", "512"]   # the train CLI's windows
HW_1024 = (512, 1024)
LOCAL_STEP_BS = ((1, "float32", 6), (4, "bfloat16", 3))
LOCAL_INFER_BS = ((1, 5), (4, 2))
# pix2pixHD's --instance_feat on the GlobalGenerator flagship
FEAT = {"instance_feat": True, "feat_num": 3, "nef": 16, "n_downsample_E": 4}
FEAT_ARGV = ["--instance_feat", *(a for k, v in FEAT.items() if k != "instance_feat"
                                  for a in (f"--{k}", str(v)))]
FEAT_STEP_HW = (512, 512)   # the train CLI's windows (fineSize)
SEG_FP32_ATOL = 1e-5        # an fp32 segment mean against the fp64 one, values in [-1, 1]
ACTS = ("none", "relu", "lrelu")
TRAIN_KERNELS = ("encode_cond", "instance_norm_bwd", "mse_to_scalar", "l1_to_scalar",
                 "reflect_pad_bwd", "reflect_pad_fwd")


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def same_bits(a, b):
    v = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(v), b.view(v))


counters, read_launches = kcalls.counters, kcalls.read_launches
read_variants, zero_launches = kcalls.read_variants, kcalls.zero_launches


def plan_variant(kind, call):
    """The variant the kernel's plan picks for one recorded call (encode:
    its pad; None for a no-image call, which counts on encode_cond)."""
    if kind == "encode":
        return f"pad{call[1]}" if len(call) == 2 else None
    if kind == "reflect_pad_bwd":
        (n, hp, wp, c), dt, pad = call
        return krp._plan(n, hp - 2 * pad, wp - 2 * pad, c, pad, dt)["variant"]
    if kind == "reflect_pad_fwd":
        shape, dt, pad, aligned = call
        return krp._fwd_plan(*shape, pad, dt, aligned)["variant"]
    shape, dt = call[:2]
    plan = kin._fwd_plan if kind == "instance_norm" else kin._bwd_plan
    return plan(*shape, dt)["variant"]


def plan_variants(kind, calls, groups=()):
    """The launches per variant that the kernel's plan (kernels/instance_norm
    ._fwd_plan, ._bwd_plan, kernels/reflect_pad._plan, ._fwd_plan) reckons
    for recorded calls of one kernel; for the loss kernel, the recorded
    groups that hold a term of its mode."""
    if kind in ("mse_to_scalar", "l1_to_scalar"):
        mode = "mse" if kind == "mse_to_scalar" else "l1"
        return {"group": sum(any(t[0] == mode for t in g) for g in groups)}
    if kind == "loss_group_bwd":   # calls: (terms with a gradient, those off the grid)
        return {"terms": sum(c[0] for c in calls), "unaligned": sum(c[1] for c in calls)}
    want = {v: 0 for v in counters()[kind].variants}
    for call in calls:
        v = plan_variant(kind, call)
        if v is not None:
            want[v] += 1
    return want


PLANNED = ("instance_norm", "instance_norm_bwd", "reflect_pad_bwd", "reflect_pad_fwd")


def expect_variants(calls, what, since=None):
    """Every kernel with a plan launched as its plan reckons for its
    recorded calls (per-variant counts since `since`, else since zero); the
    loss kernel's group launches, one for each recorded group."""
    got = read_variants()
    for kind, counts in got.items():
        if kind not in calls:
            continue
        if since is not None:
            counts = {k: v - since[kind][k] for k, v in counts.items()}
        expect_launches(counts, plan_variants(kind, calls[kind], calls.get("loss_group", ())),
                        f"{what}, {kind} variants")
    return got


def twice_on(kind, variant, fn, what):
    """fn() twice -> both results, after checking that the two launches of
    `kind` both went to `variant` (its plan's pick)."""
    before = read_variants()[kind]
    results = fn(), fn()
    after = read_variants()[kind]
    if {k: after[k] - before[k] for k in after} != dict({k: 0 for k in after}, **{variant: 2}):
        raise AssertionError(f"{what}: variants {before} -> {after}, plan {variant}")
    return results


def expect_launches(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


@contextlib.contextmanager
def recording():
    """Record the arguments' shapes of every call of a training kernel's
    wrapper, of the IN forward's and of encode's (a call on a CPU tensor
    too), by kernel name (``kernels/calls.intercept``)."""
    calls = {k: [] for k in ("instance_norm", "loss_group", "loss_group_bwd", "encode")
             + TRAIN_KERNELS}

    def group(terms):
        """One loss launch: its terms (mode, shape, dtype, scalar target or
        None), and each term as a call of mse_to_scalar / l1_to_scalar."""
        table = [(m, tuple(a.shape), a.dtype, None if torch.is_tensor(t) else float(t))
                 for m, a, t in terms]
        for m, shape, dt, t in table:
            if m == "mse":
                calls["mse_to_scalar"].append((shape, dt, t))
            else:
                calls["l1_to_scalar"].append((shape, dt))
        return "loss_group", table

    def group_bwd(spec, tensors, needs, g):
        """One backward launch: its terms that take a gradient, and those
        of them whose operands are off the 16-byte grid."""
        rows = klosses._operands(spec, tensors, needs)
        off = sum(any(x is not None and x.is_contiguous() and x.data_ptr() % 16
                      for x in (a, b)) for _, _, _, a, b, _, _ in rows)
        return "loss_group_bwd", (len(rows), off)

    describe = {
        "instance_norm": lambda x, act="none", residual=None, eps=kin.EPS:
            ("instance_norm", (tuple(x.shape), x.dtype, act, residual is not None)),
        "instance_norm_bwd": lambda x, y, g, mean, rstd, act="none", want_dres=False:
            ("instance_norm_bwd", (tuple(x.shape), x.dtype, act, bool(want_dres))),
        "reflect_pad_bwd": lambda dy, pad: ("reflect_pad_bwd", (tuple(dy.shape), dy.dtype, pad)),
        "reflect_pad_fwd": lambda x, pad: ("reflect_pad_fwd", (tuple(x.shape), x.dtype, pad,
                                                               x.data_ptr() % 16 == 0)),
        "reduce_group": group,
        "loss_group_bwd": group_bwd,
        "encode_cond": lambda label, inst, nc, dtype=torch.float32:
            ("encode_cond", (tuple(label.shape), inst is not None, nc, dtype)),
        "encode": lambda label, inst, image, boxes, nc, pad=0, dtype=None:
            ("encode", (tuple(label.shape), pad) + (() if image is not None else ("cond",))),
    }

    def on_call(name, orig, *a, **k):
        kind, call = describe[name](*a, **k)
        calls[kind].append(call)
        return orig(*a, **k)

    with kcalls.intercept(on_call):
        yield calls


# ---------------------------------------------------------------- phases

def phase_build():
    """Every csrc/*.cu with nvcc and csrc/dataio.cpp (the host data tier)
    with g++, all at once."""
    import threading

    from neurips18_hierchical_image_manipulation_tpu_torch.data import native

    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    t = time.time()
    cxx = threading.Thread(target=native.build)
    cxx.start()
    _build.build_all(sources)
    cxx.join()
    if not native.available():
        raise AssertionError(f"csrc/dataio.cpp did not build: {native.build_error}")
    log(f"[build] nvcc sm_90a, {len(sources)} sources in parallel ({', '.join(sources)}), "
        f"g++ csrc/dataio.cpp ({native.tier()} data tier): {time.time() - t:.1f} s")
    for name in sources:
        info = _build.ptxas_info.get(name, "(already built)")
        for line in info.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
                log(f"[build:{name}] {line.strip()}")


def encode_inputs(bs, h, w, dev, seed=0):
    batch = synthetic_batch(np.random.RandomState(seed), bs, hw=(h, w), label_nc=35)
    batch["label"][0, 0, :3] = [-1, 35, 200]  # out-of-range ids: zero rows
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def check_in_fwd(x, act, res, what):
    """The IN forward kernel twice on the variant its plan picks, the same
    bits both times, against the plain version (fp32 within IN_FP32_ATOL,
    bf16 one rounding apart) -> max |kernel - plain|."""
    variant = kin._fwd_plan(*x.shape, x.dtype)["variant"]
    (y, mean, rstd), again = twice_on(
        "instance_norm", variant, lambda: kin.instance_norm(x, act, res), what)
    yp, mp, rp = kin.instance_norm_plain(x, act, res)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip((y, mean, rstd), again)):
        raise AssertionError(f"{what}: two runs differ")
    torch.testing.assert_close(mean, mp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rp, atol=1e-5, rtol=1e-5)
    err = (y.float() - yp.float()).abs().max().item()
    if x.dtype == torch.float32:
        ok = err <= IN_FP32_ATOL
    else:
        ok = bool(((y.float() - yp.float()).abs()
                   <= IN_BF16_ATOL + IN_BF16_RTOL * yp.float().abs()).all())
    if not ok:
        raise AssertionError(f"{what}: max|diff| {err}")
    return err


def phase_kernels(dev, results):
    """Kernel vs plain on the card at the serving shapes, and times."""
    enc_rows, in_rows = [], []
    for bs in (1, 8):
        inp = encode_inputs(bs, 256, 512, dev)
        for dt in (torch.float32, torch.bfloat16):
            img = inp["image"].to(dt)
            for pad in (0, 3):
                args = (inp["label"], inp["inst"], img, inp["boxes"], 35)
                got = kenc.encode(*args, pad=pad)
                want = kenc.encode_plain(*args, pad=pad)
                torch.cuda.synchronize()
                if not same_bits(got, want):
                    raise AssertionError(f"encode mismatch bs{bs} {dt} pad{pad}")
                ms = graph_ms(lambda: kenc.encode(*args, pad=pad))
                pms = graph_ms(lambda: kenc.encode_plain(*args, pad=pad))
                nbytes, ops = encode_bytes(bs, 256, 512, 35, pad, img.element_size())
                bms, by = bound(nbytes, ops)
                row = dict(bs=bs, dtype=str(dt).split(".")[-1], pad=pad, ms=ms,
                           plain_ms=pms, bound_ms=bms, bound_by=by, bit_exact=True)
                enc_rows.append(row)
                log(f"[kernels] encode 512x256 {row}")
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    # the generator's sites at bs 1 and 8 (timed), the discriminator's at N
    # 1 and 2, a tiny one and channel counts off the 16-byte vectors
    shapes = [(bs, *sh) for bs in (1, 8) for sh in SHAPES_512x256] + [
        (n, *sh) for n in (1, 2) for sh in D_SHAPES_512x256] + [(1, 5, 7, 48), (2, 5, 7, 3),
                                                                 (1, 9, 11, 100)]
    for shape in shapes:
        bs, h, w, c = shape
        x32 = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        r32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, r = x32.to(dt), r32.to(dt)
            name = str(dt).split(".")[-1]
            for act in ("none", "relu", "lrelu"):
                for res in (None, r):
                    err = check_in_fwd(x, act, res, f"IN {shape} {name} {act} "
                                                    f"res={res is not None}")
                    max_err[name] = max(max_err[name], err)
            if shape[1:] not in SHAPES_512x256 or bs not in (1, 8):
                continue
            ms = graph_ms(lambda: kin.instance_norm(x, "relu"))
            pms = graph_ms(lambda: kin.instance_norm_plain(x, "relu"))
            lms = graph_ms(lambda: F.instance_norm(x.permute(0, 3, 1, 2), eps=1e-5))
            nbytes, ops = in_bytes(bs, h * w, c, x.element_size(), False)
            bms, by = bound(nbytes, ops)
            row = dict(shape=[bs, h, w, c], dtype=name, act="relu", ms=ms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by,
                       plan=kin._fwd_plan(*shape, dt))
            in_rows.append(row)
            log(f"[kernels] instance_norm {row}")
    log(f"[kernels] IN max|kernel - plain|: {max_err} (fp32 limit {IN_FP32_ATOL})")
    results["kernel_rows"] = {"encode": enc_rows, "instance_norm": in_rows}
    results["in_max_err"] = max_err


def check_close(got, want, dt, fp32_atol, what, rtol=0.0):
    """max |got - want| within fp32_atol (+ rtol*|want|) in fp32, one bf16
    rounding apart in bf16; returns the max |diff|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dt == torch.float32:
        ok = bool((diff <= fp32_atol + rtol * want.abs()).all())
    else:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    err = diff.max().item()
    if not ok:
        raise AssertionError(f"{what}: kernel vs plain max|diff| {err}")
    return err


def check_in_bwd(x, gy, act, res, what):
    """The IN backward kernel (of act(IN(x) + res)) twice on the variant its
    plan picks, the same bits both times, against the plain version: dx, and
    dres where there is a residual -> max |kernel - plain|."""
    y, mean, rstd = kin.instance_norm(x, act, res)
    want_dres = res is not None
    got, again = twice_on(
        "instance_norm_bwd", kin._bwd_plan(*x.shape, x.dtype)["variant"],
        lambda: kin.instance_norm_bwd(x, y, gy, mean, rstd, act, want_dres), what)
    want = kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, act, want_dres)
    if not same_bits(got[0], again[0]):
        raise AssertionError(f"{what}: two runs differ")
    err = check_close(got[0], want[0], x.dtype, IN_BWD_FP32_ATOL, what)
    if want_dres:
        err = max(err, check_close(got[1], want[1], x.dtype, IN_BWD_FP32_ATOL, what))
    return err


def check_pad_bwd(dy, pad, what):
    """The reflect-pad backward twice on the variant its plan picks, the
    same bits both times, against the plain version -> max |diff|."""
    n, hp, wp, c = dy.shape
    got, again = twice_on("reflect_pad_bwd",
                          krp._plan(n, hp - 2 * pad, wp - 2 * pad, c, pad, dy.dtype)["variant"],
                          lambda: krp.reflect_pad_bwd(dy, pad), what)
    if not same_bits(got, again):
        raise AssertionError(f"{what}: two runs differ")
    return check_close(got, krp.reflect_pad_bwd_plain(dy, pad), dy.dtype, PAD_FP32_ATOL, what)


def check_pad_fwd(x, pad, what):
    """The reflect-pad forward twice on the variant its plan picks: both
    the plain pad's bits -> 0.0 (the max |diff|)."""
    variant = krp._fwd_plan(*x.shape, pad, x.dtype, x.data_ptr() % 16 == 0)["variant"]
    got, again = twice_on("reflect_pad_fwd", variant, lambda: krp.reflect_pad_fwd(x, pad), what)
    want = krp.reflect_pad_plain(x, pad)
    if not (same_bits(got, want) and same_bits(again, want)):
        raise AssertionError(f"{what}: not the plain pad's bits")
    return 0.0


def pad_fwd_input(shape, dt, aligned, gen, dev):
    """x of a recorded forward call: a fresh tensor, or a contiguous view
    one element past a 16-byte boundary where the call's x was off it."""
    n = math.prod(shape)
    flat = torch.randn(n + (not aligned), generator=gen, device=dev).to(dt)
    return flat[int(not aligned):].view(shape)


def library_pad_fwd(x, pad):
    """The library yardstick: aten's reflection pad on the channels_last
    view (the same values, NCHW-contiguous; the plain version copies them
    back to NHWC)."""
    return lambda: F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")


# every pad site of the benchmark's cells in its dtype: (N, H, W, C), pad,
# dtype -- the flagship bf16 bs 32 (resblocks, head; its stem's pad is in
# the encode), the 1024p step (trunk stem and resblocks, branch stem and
# resblocks, head), box2mask (stem, resblocks, the two heads), the fp32
# flagship at bs 16 and the fp32 serving forward at bs 1
PAD_FWD_SITES = (
    ((32, 32, 32, 1024), 1, torch.bfloat16), ((32, 512, 512, 64), 3, torch.bfloat16),
    ((8, 512, 512, 39), 3, torch.bfloat16), ((8, 32, 32, 1024), 1, torch.bfloat16),
    ((8, 1024, 1024, 39), 3, torch.bfloat16), ((8, 512, 512, 64), 1, torch.bfloat16),
    ((8, 1024, 1024, 32), 3, torch.bfloat16),
    ((128, 128, 128, 36), 3, torch.bfloat16), ((128, 16, 16, 512), 1, torch.bfloat16),
    ((128, 128, 128, 64), 3, torch.bfloat16),
    ((16, 32, 32, 1024), 1, torch.float32), ((16, 512, 512, 64), 3, torch.float32),
    ((1, 32, 32, 1024), 1, torch.float32), ((1, 512, 512, 64), 3, torch.float32))


def pad_fwd_rows(dev, gen):
    """The reflect-pad forward at each site: bit for bit the plain pad
    twice, on its plan's variant; CUDA-graph device ms of the kernel, the
    plain version and the library call beside the byte bound -> rows."""
    rows = []
    for shape, pad, dt in PAD_FWD_SITES:
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        check_pad_fwd(x, pad, f"reflect-pad fwd {shape} p{pad} {dt}")
        bms, by = bound(*pad_fwd_bytes(shape, pad, x.element_size()))
        row = dict(kernel="reflect_pad_fwd", shape=list(shape), pad=pad, dtype=str(dt)[6:],
                   plan=krp._fwd_plan(*shape, pad, dt),
                   ms=graph_ms(lambda: krp.reflect_pad_fwd(x, pad)),
                   plain_ms=graph_ms(lambda: krp.reflect_pad_plain(x, pad)),
                   library_ms=graph_ms(library_pad_fwd(x, pad)), bound_ms=bms, bound_by=by)
        row["of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"[kernels train] {row}")
        del x
        torch.cuda.empty_cache()
    return rows


def library_in_bwd(x, gy):
    """The library yardstick: the backward of F.instance_norm (IN alone, no
    activation or residual) on the same x and cotangent, as the one aten
    call its autograd makes, on the NCHW (1, N*C, H, W) view instance_norm
    takes (called directly: an autograd backward would run on the
    forward's stream, outside a graph captured on another)."""
    n, h, w, c = x.shape
    xr = x.permute(0, 3, 1, 2).contiguous().view(1, n * c, h, w)
    gr = gy.permute(0, 3, 1, 2).contiguous().view(1, n * c, h, w)
    _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(
        xr, None, None, None, None, True, 0.0, 1e-5)
    return lambda: torch.ops.aten.native_batch_norm_backward(
        gr, xr, None, None, None, save_mean, save_invstd, True, 1e-5, [True, False, False])


def library_pad_bwd(dy, pad):
    n, hp, wp, c = dy.shape
    x = torch.empty((n, hp - 2 * pad, wp - 2 * pad, c), dtype=dy.dtype, device=dy.device)
    return lambda: torch.ops.aten.reflection_pad2d_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), [pad] * 4)


def in_bwd_host_us(dev, calls=1000):
    """Host time of one IN backward call at the generator bottleneck (relu),
    fp32 and bf16: the host clock over `calls` calls after a sync (the
    enqueue rate; the kernel itself takes less)."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 16, 32, 1024), device=dev).to(dt)
        gy = torch.randn_like(x)
        y, mean, rstd = kin.instance_norm(x, "relu")
        kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")
        out[str(dt)[6:]] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    return out


def phase_train_kernels(dev, results):
    """Each training kernel against its plain version on the card, fp32 and
    bf16, and its times beside the library call (one site at a time)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    errs, rows = {}, []

    def keep(name, dt, err):
        key = f"{name}/{str(dt).split('.')[-1]}"
        errs[key] = max(errs.get(key, 0.0), err)

    # the 5 generator sites (among them the cluster of 16 at 64x128x256 fp32
    # and the split sites 256x512x64, 128x256x128), the 12 discriminator
    # sites and a tiny odd one
    in_shapes = [(1, *sh) for sh in SHAPES_512x256] + [
        (n, *sh) for n in (1, 2) for sh in D_SHAPES_512x256] + [(1, 5, 7, 48)]
    for shape in in_shapes:
        x32 = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        r32 = torch.randn(shape, generator=gen, device=dev)
        g32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x, r, gy = x32.to(dt), r32.to(dt), g32.to(dt)
            for act in ACTS:
                for res in (None, r):
                    keep("instance_norm_bwd", dt, check_in_bwd(
                        x, gy, act, res, f"IN bwd {shape} {dt} {act} res={res is not None}"))
            y, mean, rstd = kin.instance_norm(x, "relu")
            bms, by = bound(*in_bwd_bytes(shape, x.element_size(), "relu", False))
            row = dict(kernel="instance_norm_bwd", shape=list(shape), dtype=str(dt)[6:],
                       act="relu",
                       ms=graph_ms(lambda: kin.instance_norm_bwd(x, y, gy, mean, rstd, "relu")),
                       plain_ms=graph_ms(
                           lambda: kin.instance_norm_bwd_plain(x, y, gy, mean, rstd, "relu")),
                       library_ms=graph_ms(library_in_bwd(x, gy)), bound_ms=bms, bound_by=by)
            row["variant"] = kin._bwd_plan(*shape, dt)
            rows.append(row)
            log(f"[kernels train] {row}")
    results["in_bwd_host_us"] = in_bwd_host_us(dev)
    log(f"[kernels train] IN backward wrapper, host time a call: {results['in_bwd_host_us']}")
    # the resblock and head pads (bulk), one tile with overlapping mirrors
    # (h <= 2p), and channel counts whose pixels are not 16-byte multiples
    # (gather), h <= 2p too
    for shape, pad in (((1, 16, 32, 1024), 1), ((1, 256, 512, 64), 3), ((2, 2, 3, 8), 1),
                       ((1, 4, 5, 16), 3), ((1, 5, 7, 3), 1), ((1, 4, 5, 3), 3)):
        n, h, w, c = shape
        dy32 = torch.randn((n, h + 2 * pad, w + 2 * pad, c), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            dy = dy32.to(dt)
            keep("reflect_pad_bwd", dt,
                 check_pad_bwd(dy, pad, f"reflect-pad bwd {shape} p{pad} {dt}"))
            bms, by = bound(*pad_bwd_bytes(tuple(dy.shape), pad, dy.element_size()))
            row = dict(kernel="reflect_pad_bwd", shape=list(shape), pad=pad,
                       dtype=str(dt)[6:], plan=krp._plan(*shape, pad, dt),
                       ms=graph_ms(lambda: krp.reflect_pad_bwd(dy, pad)),
                       plain_ms=graph_ms(lambda: krp.reflect_pad_bwd_plain(dy, pad)),
                       library_ms=graph_ms(library_pad_bwd(dy, pad)), bound_ms=bms, bound_by=by)
            rows.append(row)
            log(f"[kernels train] {row}")
    # the forward at every pad site of the benchmark's cells
    for row in pad_fwd_rows(dev, gen):
        keep("reflect_pad_fwd", getattr(torch, row["dtype"]), 0.0)
        rows.append(row)
    # the D logits of both scales, the FM features, the VGG taps at 512x256
    loss_shapes = [(1, 35, 67, 1), (1, 19, 35, 1), (1, 129, 257, 64), (1, 65, 129, 128),
                   (1, 34, 66, 512), (1, 256, 512, 64), (1, 128, 256, 128), (1, 64, 128, 256),
                   (1, 32, 64, 512), (1, 16, 32, 512)]
    for shape in loss_shapes:
        a32 = torch.randn(shape, generator=gen, device=dev)
        b32 = torch.randn(shape, generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            a, b = a32.to(dt), b32.to(dt)
            t = torch.ones((), dtype=dt, device=dev).expand_as(a)
            for name, fn, plain, lib, two in (
                ("mse_to_scalar", lambda: klosses.mse_to_scalar(a, 1.0),
                 lambda: klosses.mse_to_scalar_plain(a, 1.0), lambda: F.mse_loss(a, t), False),
                ("l1_to_scalar", lambda: klosses.l1_to_scalar(a, b),
                 lambda: klosses.l1_to_scalar_plain(a, b), lambda: F.l1_loss(a, b), True),
            ):
                keep(name, dt, check_close(fn(), plain(), torch.float32, 0.0,
                                           f"{name} {shape} {dt}", rtol=LOSS_RTOL))
                bms, by = bound(*loss_bytes(a.numel(), a.element_size(), two))
                row = dict(kernel=name, shape=list(shape), dtype=str(dt)[6:], ms=graph_ms(fn),
                           plain_ms=graph_ms(plain), library_ms=graph_ms(lib),
                           bound_ms=bms, bound_by=by)
                rows.append(row)
                log(f"[kernels train] {row}")
    for bs in (1, 2):
        inp = encode_inputs(bs, *STEP_HW, dev)
        for dt in (torch.float32, torch.bfloat16):
            args = (inp["label"], inp["inst"], 35, dt)
            got, want = kenc.encode_cond(*args), kenc.encode_cond_plain(*args)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"encode_cond mismatch bs{bs} {dt}")
            bms, by = bound(*cond_bytes(bs, *STEP_HW, got.shape[-1], got.element_size()))
            row = dict(kernel="encode_cond", shape=[bs, *STEP_HW], dtype=str(dt)[6:],
                       ms=graph_ms(lambda: kenc.encode_cond(*args)),
                       plain_ms=graph_ms(lambda: kenc.encode_cond_plain(*args)),
                       library_ms=None, bound_ms=bms, bound_by=by, bit_exact=True)
            rows.append(row)
            log(f"[kernels train] {row}")
    for dt in (torch.float32, torch.bfloat16):
        row = time_loss_group_bwd(dt, dev, gen, FLAGSHIP_BS)
        rows.append(row)
        log(f"[kernels train] {row}")
    log(f"[kernels train] max|kernel - plain|: {errs}")
    results["train_kernel_rows"] = rows
    results["train_kernel_max_err"] = errs


# the flagship step's loss terms at its 512x512 windows (a sample's shape):
# the D logits of both scales, D's 4 feature-matching layers at each, VGG's
# relu1_1..relu5_1 taps
FLAGSHIP_LOGITS = ((67, 67, 1), (35, 35, 1))
FLAGSHIP_FM = ((257, 257, 64), (129, 129, 128), (65, 65, 256), (66, 66, 512),
               (129, 129, 64), (65, 65, 128), (33, 33, 256), (34, 34, 512))
FLAGSHIP_VGG = ((512, 512, 64), (256, 256, 128), (128, 128, 256), (64, 64, 512), (32, 32, 512))


def flagship_loss_groups(bs, dt, dev, gen):
    """The backward calls of the flagship step's 4 loss groups at batch bs:
    G's GAN terms, D's real and fake terms (the halves of D's [real; fake]
    logits), feature matching and VGG (the real side detached) -> [(spec,
    tensors, needs, g)], g weights that are no powers of two."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    g_logits = [rand(bs, *s) for s in FLAGSHIP_LOGITS]
    d_logits = [rand(2 * bs, *s) for s in FLAGSHIP_LOGITS]
    groups = [
        ((("mse", 1.0),) * 2, g_logits, [True] * 2),
        ((("mse", 1.0),) * 2 + (("mse", 0.0),) * 2,
         [x[:bs] for x in d_logits] + [x[bs:] for x in d_logits], [True] * 4),
    ]
    for shapes in (FLAGSHIP_FM, FLAGSHIP_VGG):
        groups.append(((("l1", None),) * len(shapes),
                       [x for s in shapes for x in (rand(bs, *s), rand(bs, *s))],
                       [True, False] * len(shapes)))
    return [(spec, tensors, needs, torch.linspace(0.3, 2.9, len(spec), device=dev))
            for spec, tensors, needs in groups]


def time_loss_group_bwd(dt, dev, gen, bs):
    """The loss groups' backward over the flagship step's 4 groups at bs 32:
    one launch a group, each group's gradients the plain version's bits;
    device time of kernel and plain version by CUDA-graph replay, and the
    bound (a and b read, da written)."""
    calls = flagship_loss_groups(bs, dt, dev, gen)
    before = klosses.loss_group_bwd.launches
    got = [klosses.loss_group_bwd(*c) for c in calls]
    launches = klosses.loss_group_bwd.launches - before
    if launches != len(calls):
        raise AssertionError(f"loss_group_bwd {dt}: {launches} launches for {len(calls)} groups")
    for c, grads in zip(calls, got):
        want = klosses.loss_group_bwd_plain(*c)
        torch.cuda.synchronize()
        if not all((x is None and y is None) or torch.equal(x, y) for x, y in zip(grads, want)):
            raise AssertionError(f"loss_group_bwd {dt}: not the plain version's bits, {c[0]}")
        del want
    del got
    nbytes = ops = 0
    for spec, tensors, needs, _ in calls:
        for _, _, _, a, b, ga, gb in klosses._operands(spec, tensors, needs):
            nb, o = loss_bwd_bytes(a.numel(), a.element_size(), b is not None,
                                   (ga is not None) + (gb is not None))
            nbytes, ops = nbytes + nb, ops + o
    bms, by = bound(nbytes, ops)
    row = dict(kernel="loss_group_bwd", shape=f"flagship bs {bs}, 512x512: 6 MSE + 13 L1 terms",
               dtype=str(dt)[6:], launches=len(calls),
               ms=graph_ms(lambda: [klosses.loss_group_bwd(*c) for c in calls]),
               plain_ms=graph_ms(lambda: [klosses.loss_group_bwd_plain(*c) for c in calls]),
               library_ms=None, bound_ms=bms, bound_by=by, bytes=nbytes, bit_exact=True)
    del calls
    torch.cuda.empty_cache()
    return row


def two_bf16_ulps(got, want):
    """|got - want| within CONV_IN_BF16_ULPS bf16 ulps of max(|want|, 1)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1.0))) - 7)
    return bool(((got.float() - want.float()).abs() <= CONV_IN_BF16_ULPS * ulp).all())


def library_conv_in(x, w3x3, b, relu=False, residual=None):
    """The library composition (a yardstick only): reflect pad, cuDNN conv
    and F.instance_norm on the channels-last NCHW view."""
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                 w3x3.permute(3, 2, 0, 1), b.to(x.dtype))
    y = F.instance_norm(y, eps=1e-5)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    return F.relu(y) if relu else y


def conv_in_inputs(shape, dt, dev, gen, residual):
    n, h, w, cin, cout = shape
    x = (torch.randn((n, h, w, cin), generator=gen, device=dev) * 0.5).to(dt)
    w3 = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (9 * cin) ** -0.5).to(dt)
    b = torch.randn((cout,), generator=gen, device=dev).to(dt)
    r = torch.randn((n, h, w, cout), generator=gen, device=dev).to(dt) if residual else None
    return x, w3, b, r


def check_conv_in(x, w3, b, relu, r, what):
    """Kernel vs plain (fp32) or vs the plain version on the fp32 values
    (bf16), the same bits on a second run -> (max |kernel - gate|, max
    |kernel - plain version in x's dtype|)."""
    y, again = twice_on("conv3x3_in_act", kconv._plan(*x.shape, w3.shape[3], x.dtype)["variant"],
                        lambda: kconv.conv3x3_in_act(x, w3, b, relu=relu, residual=r),
                        f"conv3x3_in_act {what}")
    plain = kconv.conv3x3_in_act_plain(x, w3, b, relu=relu, residual=r)
    torch.cuda.synchronize()
    if not same_bits(y, again):
        raise AssertionError(f"conv3x3_in_act {what}: two runs differ")
    diff_plain = (y.float() - plain.float()).abs().max().item()
    if x.dtype == torch.float32:
        ok = bool(((y - plain).abs() <= CONV_IN_ATOL + CONV_IN_RTOL * plain.abs()).all())
        return ok, diff_plain, diff_plain
    f = [t.float() if t is not None else None for t in (x, w3, b, r)]
    want = kconv.conv3x3_in_act_plain(f[0], f[1], f[2], relu=relu, residual=f[3])
    return two_bf16_ulps(y, want.to(x.dtype)), (y.float() - want).abs().max().item(), diff_plain


def phase_conv_in(dev, results):
    """conv3x3_in_act against its plain version on the card, fp32 and bf16,
    its gradient against the plain gradient, and its times."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, errs = [], {}
    for shape in CONV_IN_SHAPES:
        flags = ([(relu, res) for relu in (False, True) for res in (False, True)]
                 if shape == CONV_IN_SHAPES[0] else [(True, False), (False, True)])
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            for relu, res in flags:
                x, w3, b, r = conv_in_inputs(shape, dt, dev, gen, res)
                with torch.no_grad():
                    ok, err, diff_plain = check_conv_in(x, w3, b, relu, r, f"{shape} {name}")
                if not ok:
                    raise AssertionError(f"conv3x3_in_act {shape} {name} relu={relu} "
                                         f"res={res}: max|diff| {err}")
                errs[name] = max(errs.get(name, 0.0), err)
                errs[f"{name} vs plain in {name}"] = max(
                    errs.get(f"{name} vs plain in {name}", 0.0), diff_plain)
            x, w3, b, r = conv_in_inputs(shape, dt, dev, gen, False)
            bms, by = conv_in_bound(shape, dt, False)
            with torch.no_grad():
                row = dict(kernel="conv3x3_in_act", shape=list(shape), dtype=name, relu=True,
                           ms=graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True)),
                           plain_ms=graph_ms(
                               lambda: kconv.conv3x3_in_act_plain(x, w3, b, relu=True)),
                           composition_ms=graph_ms(lambda: library_conv_in(x, w3, b, True)),
                           library_ms=None, bound_ms=bms, bound_by=by)
            row["tflops"] = 2 * math.prod(shape[:3]) * 9 * shape[3] * shape[4] / row["ms"] / 1e9
            row["plan"] = kconv._plan(*shape, dt)
            rows.append(row)
            log(f"[conv_in] {row}")
    # the autograd.Function's gradient (the recomputed plain composition)
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        x, w3, b, r = conv_in_inputs(CONV_IN_SHAPES[1], dt, dev, gen, True)
        leaves = [t.detach().requires_grad_() for t in (x, w3, b, r)]
        gy = torch.randn(r.shape, generator=gen, device=dev).to(dt)
        got, want = (torch.autograd.grad(fn(*leaves[:3], relu=True, residual=leaves[3]),
                                         leaves, gy)
                     for fn in (kconv.conv3x3_in_act, kconv.conv3x3_in_act_plain))
        grads[str(dt)[6:]] = max(check_close(a, p, dt, 1e-4, "conv3x3_in_act gradient",
                                             rtol=1e-4) for a, p in zip(got, want))
    log(f"[conv_in] max|kernel - gate| {errs} (fp32 {CONV_IN_ATOL} + {CONV_IN_RTOL}|y|, "
        f"bf16 {CONV_IN_BF16_ULPS} ulps); gradient vs plain max|diff| {grads}")
    results["conv_in"] = dict(rows=rows, max_err=errs, grad_max_diff=grads)


def site_inputs(kind, calls, dev, gen):
    """Fresh random inputs for each recorded call of one kernel, and the
    kernel / plain / library closures over the whole sequence with their
    bound and max |kernel - plain|."""
    kern, plain, lib, nbytes, ops, err = [], [], [], 0, 0, 0.0
    for call in calls:
        if kind == "instance_norm":
            shape, dt, act, has_res = call
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            r = torch.randn(shape, generator=gen, device=dev).to(dt) if has_res else None
            a = (x, act, r)
            kern.append(lambda a=a: kin.instance_norm(*a))
            plain.append(lambda a=a: kin.instance_norm_plain(*a))
            lib.append(lambda x=x: F.instance_norm(x.permute(0, 3, 1, 2), eps=kin.EPS))
            b, o = in_bytes(shape[0], shape[1] * shape[2], shape[3], x.element_size(), has_res)
            e = (kern[-1]()[0].float() - plain[-1]()[0].float()).abs().max().item()
        elif kind == "instance_norm_bwd":
            shape, dt, act, want_dres = call
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
            gy = torch.randn(shape, generator=gen, device=dev).to(dt)
            y, mean, rstd = kin.instance_norm(x, act)
            a = (x, y, gy, mean, rstd, act, want_dres)
            kern.append(lambda a=a: kin.instance_norm_bwd(*a))
            plain.append(lambda a=a: kin.instance_norm_bwd_plain(*a))
            lib.append(library_in_bwd(x, gy))
            b, o = in_bwd_bytes(shape, x.element_size(), act, want_dres)
            e = (kern[-1]()[0].float() - plain[-1]()[0].float()).abs().max().item()
        elif kind == "reflect_pad_bwd":
            shape, dt, pad = call
            dy = torch.randn(shape, generator=gen, device=dev).to(dt)
            kern.append(lambda dy=dy, p=pad: krp.reflect_pad_bwd(dy, p))
            plain.append(lambda dy=dy, p=pad: krp.reflect_pad_bwd_plain(dy, p))
            lib.append(library_pad_bwd(dy, pad))
            b, o = pad_bwd_bytes(shape, pad, dy.element_size())
            e = (kern[-1]().float() - plain[-1]().float()).abs().max().item()
        elif kind == "reflect_pad_fwd":
            shape, dt, pad, aligned = call
            x = pad_fwd_input(shape, dt, aligned, gen, dev)
            kern.append(lambda x=x, p=pad: krp.reflect_pad_fwd(x, p))
            plain.append(lambda x=x, p=pad: krp.reflect_pad_plain(x, p))
            lib.append(library_pad_fwd(x, pad))
            b, o = pad_fwd_bytes(shape, pad, x.element_size())
            e = check_pad_fwd(x, pad, f"reflect-pad fwd {shape} p{pad}")
        elif kind == "encode":
            shape, pad = call
            inp = encode_inputs(shape[0], shape[1], shape[2], dev, seed=len(kern))
            a = (inp["label"], inp["inst"], inp["image"], inp["boxes"], 35)
            kern.append(lambda a=a, p=pad: kenc.encode(*a, pad=p))
            plain.append(lambda a=a, p=pad: kenc.encode_plain(*a, pad=p))
            lib = None
            if not same_bits(kern[-1](), plain[-1]()):
                raise AssertionError(f"encode mismatch at {shape} pad {pad}")
            b, o = encode_bytes(*shape, 35, pad, 4)
            e = 0.0
        elif kind == "encode_cond":
            shape, has_inst, nc, dt = call
            inp = encode_inputs(shape[0], shape[1], shape[2], dev, seed=len(kern))
            a = (inp["label"], inp["inst"] if has_inst else None, nc, dt)
            kern.append(lambda a=a: kenc.encode_cond(*a))
            plain.append(lambda a=a: kenc.encode_cond_plain(*a))
            lib = None
            out = kern[-1]()
            if not same_bits(out, plain[-1]()):
                raise AssertionError(f"encode_cond mismatch at {shape}")
            b, o = cond_bytes(*shape, out.shape[-1], out.element_size())
            e = 0.0
        else:
            raise ValueError(kind)
        nbytes, ops, err = nbytes + b, ops + o, max(err, e)

    def seq(fns):
        return lambda: [f() for f in fns]

    return seq(kern), seq(plain), (seq(lib) if lib is not None else None), nbytes, ops, err


def time_sites(kind, calls, dev, seed):
    """Device time of a kernel over the calls one step made of it, by
    CUDA-graph replay: kernel, plain version, library call, and the bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kern, plain, lib, nbytes, ops, err = site_inputs(kind, calls, dev, gen)
    torch.cuda.synchronize()
    bms, by = bound(nbytes, ops)
    return dict(launches_per_step=len(calls), max_abs_err=err, ms=graph_ms(kern),
                plain_ms=graph_ms(plain), library_ms=graph_ms(lib) if lib else None,
                bound_ms=bms, bound_by=by, bytes=nbytes)


def time_loss_groups(kind, groups, dev, seed):
    """Device time of the loss kernel over the launches of one mode that one
    step made (each recorded group replayed as one reduce_group, on fresh
    random operands of its terms' shapes), beside the plain version over
    the same groups, the library call (F.mse_loss / F.l1_loss) per term and
    the bound; each group the same bits as its terms alone, and within
    LOSS_RTOL of the plain version."""
    mode = "mse" if kind == "mse_to_scalar" else "l1"
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables, lib, nbytes, ops, err = [], [], 0, 0, 0.0
    for table in groups:
        if not any(m == mode for m, *_ in table):
            continue
        terms = []
        for m, shape, dt, t in table:
            a = torch.randn(shape, generator=gen, device=dev).to(dt)
            b = torch.randn(shape, generator=gen, device=dev).to(dt) if t is None else None
            terms.append((m, a, b if t is None else t))
            tt = b if t is None else torch.full((), t, dtype=dt, device=dev).expand_as(a)
            fn = F.mse_loss if m == "mse" else F.l1_loss
            lib.append(lambda a=a, tt=tt, fn=fn: fn(a, tt))
            nb, o = loss_bytes(a.numel(), a.element_size(), t is None)
            nbytes, ops = nbytes + nb, ops + o
        got, want = klosses.reduce_group(terms), klosses.reduce_group_plain(terms)
        alone = torch.cat([klosses.reduce_group([term]) for term in terms])
        torch.cuda.synchronize()
        if not same_bits(got, alone):
            raise AssertionError(f"{kind}: a term's bits differ alone and in its group {table}")
        check_close(got, want, torch.float32, 0.0, f"{kind} group {table}", rtol=LOSS_RTOL)
        err = max(err, (got - want).abs().max().item())
        tables.append(terms)
    bms, by = bound(nbytes, ops)
    return dict(
        launches_per_step=len(tables), terms_per_step=sum(len(t) for t in tables),
        max_abs_err=err, ms=graph_ms(lambda: [klosses.reduce_group(t) for t in tables]),
        plain_ms=graph_ms(lambda: [klosses.reduce_group_plain(t) for t in tables]),
        library_ms=graph_ms(lambda: [f() for f in lib]), bound_ms=bms, bound_by=by,
        bytes=nbytes)


def train_per_step(g_sites, opt, pads, fwd_pads):
    """Launches of each kernel in one train step of this architecture
    (g_sites: the IN sites of G's forward, the Encoder's included; pads:
    the reflect pads whose backward runs; fwd_pads: the reflect pads the
    forward runs, ``forward_pads``). With the image pool the D step encodes its
    conditioning again, and the G step runs D on the real image for feature
    matching on its own. Without the masked image G's input is a no-image
    encode, which counts on encode_cond."""
    d_sites = opt.n_layers_D * opt.num_D      # IN sites of one D apply
    in_sites = g_sites + 2 * d_sites          # G, D on the fake for G, D on [real; fake]
    pooled = opt.pool_size > 0
    masked = getattr(opt, "use_masked_image", False)
    return {
        "encode": int(masked), "encode_cond": (2 if pooled else 1) + int(not masked),
        "instance_norm": in_sites + (d_sites if pooled and not opt.no_ganFeat_loss else 0),
        "instance_norm_bwd": in_sites, "mse_to_scalar": 3 * opt.num_D,
        "l1_to_scalar": ((0 if opt.no_ganFeat_loss else (opt.n_layers_D + 1) * opt.num_D)
                         + (0 if opt.no_vgg_loss else 5)),
        "loss_group_bwd": sum(loss_groups_per_step(opt).values()),
        "reflect_pad_bwd": pads, "reflect_pad_fwd": fwd_pads, "conv3x3_in_act": 0,
    }


def generator_counts(g):
    """(IN sites of one forward, reflect pads whose backward a step runs,
    stems) of a GlobalGenerator or LocalEnhancer: 2 pads a resblock and the
    head's; a stem's pad takes a gradient only when its input does (encoder
    features). The LocalEnhancer: the trunk's 1 + 2 n_down + 2 n_blocks
    sites, and per branch its stem, down, 2 a resblock and up (36 at the
    1024p recipe's width; pads 25)."""
    if isinstance(g, networks.LocalEnhancer):
        t, n = getattr(g, "global"), g.n_local_enhancers
        return (1 + 2 * t.n_downsampling + 2 * t.n_blocks + n * (3 + 2 * g.n_blocks_local),
                2 * t.n_blocks + 2 * n * g.n_blocks_local + 1, n + 1)
    return 1 + 2 * g.n_downsampling + 2 * g.n_blocks, 2 * g.n_blocks + 1, 1


def b2m_per_step(opt):
    """Launches of each kernel in one box2mask train step: IN at the
    generator's 2 + 3 n_down + 2 n_blocks sites (stem, downs, cls_norm, 2 a
    resblock, both decoders' ups: 19 at full width) and at the n_layers_D
    sites of each of the two D applies, forward and backward; the
    reflect-pad backward at the resblock pads and the two 7x7 heads (the
    stem's input takes no gradient), its forward at those and the stem;
    LSGAN's 3 MSE terms."""
    g_sites = 2 + 3 * opt.n_downsample_global + 2 * opt.n_blocks_global
    in_sites = g_sites + 2 * opt.n_layers_D
    return {"encode": 0, "encode_cond": 0, "instance_norm": in_sites,
            "instance_norm_bwd": in_sites, "mse_to_scalar": 0 if opt.no_lsgan else 3,
            "loss_group_bwd": 0 if opt.no_lsgan else 2,
            "l1_to_scalar": 0, "reflect_pad_bwd": 2 * opt.n_blocks_global + 2,
            "reflect_pad_fwd": 2 * opt.n_blocks_global + 3, "conv3x3_in_act": 0}


def runs_encoder(model):
    """The instance-feature Encoder runs in the model's forward (not under
    --load_features, and not without features)."""
    return getattr(model, "netE", None) is not None and not getattr(model.opt, "load_features",
                                                                    False)


def forward_pads(model, encoder=None):
    """The reflect pads one generator forward runs, a reflect_pad_fwd launch
    each: box2mask's 2 a resblock, two heads and stem; a GlobalGenerator's or
    LocalEnhancer's pads whose backward runs (``generator_counts``) and its
    stems, but a GlobalGenerator stem whose pad the encode kernel makes
    (the windows here are even); with ``encoder`` (default: whether it
    runs), the Encoder's stem and head."""
    if isinstance(model, BoxToMaskModel):
        return 2 * model.opt.n_blocks_global + 3
    _, pads, stems = generator_counts(model.netG)
    pads += 0 if model._padded_stem(2, 2) else stems
    return pads + (2 if (runs_encoder(model) if encoder is None else encoder) else 0)


def per_step_of(model):
    """Launches of each kernel in one train step of the model's architecture.
    The instance-feature Encoder (not run under --load_features) adds its 1 +
    2 n_down IN sites (9), its head's pad and the generator stems' pads,
    whose input now takes its gradient; forward, its stem's pad too."""
    if isinstance(model, BoxToMaskModel):
        return b2m_per_step(model.opt)
    g_sites, pads, stems = generator_counts(model.netG)
    if runs_encoder(model):
        g_sites, pads = g_sites + 1 + 2 * model.netE.n_downsampling, pads + 1 + stems
    return train_per_step(g_sites, model.opt, pads, forward_pads(model))


def loss_groups_per_step(opt):
    """Loss-kernel launches of one train step (kernels/losses.reduce_group,
    one a loss): G's GAN term and D's real + fake terms (LSGAN), feature
    matching and VGG (mask2image; box2mask has neither); the image pool
    splits the step, not a loss."""
    lsgan = not opt.no_lsgan
    if opt.model == "box2mask":
        return {"mse_to_scalar": 2 if lsgan else 0, "l1_to_scalar": 0}
    return {"mse_to_scalar": 2 if lsgan else 0,
            "l1_to_scalar": int(not opt.no_ganFeat_loss) + int(not opt.no_vgg_loss)}


def expect_groups(groups, per_step, steps, what):
    """The loss groups launched (variants["group"] of each mode since
    zero or since `groups`) against the per-step count."""
    got = read_variants()
    for kind, n in per_step.items():
        expect_launches(got[kind]["group"] - groups.get(kind, 0), n * steps,
                        f"{what}, {kind} group launches")


def drive_train_cli(argv, cli=mask2image_train):
    """One run of a train CLI with the launch counters zeroed just before
    and read just after -> (state, model, loss lines, wall s, launches,
    per-step launches of its architecture)."""
    errors, models = [], []
    orig_print = Visualizer.print_current_errors
    orig_create = cli.create_model

    def record_errors(self, epoch, i, errs, t):
        # the loss terms; the line's throughput (img_per_s_per_chip) is a
        # clock reading, not a loss
        errors.append({k: v for k, v in errs.items() if k != "img_per_s_per_chip"})
        return orig_print(self, epoch, i, errs, t)

    def create_and_keep(opt):
        models.append(orig_create(opt))
        return models[-1]

    zero_launches()
    t = time.time()
    with mock.patch.object(Visualizer, "print_current_errors", record_errors), \
            mock.patch.object(cli, "create_model", create_and_keep):
        state = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_launches()
    model = models[0]
    per_step = per_step_of(model)
    bad = [e for e in errors if not all(np.isfinite(v) for v in e.values())]
    if bad:
        raise AssertionError(f"non-finite losses: {bad}")
    return state, model, errors, wall, launches, per_step


def phase_train_cli(tmp, results):
    """Main path 2: the port's train CLI end to end on the card."""
    root = os.path.join(tmp, "city_train")
    write_dataroot(root, phase="train", seed=1)
    ckpt = os.path.join(tmp, "ckpt")
    argv = ["--name", "smoke_train", "--dataroot", root, "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--save_epoch_freq", "100", "--nThreads", "2", *ARCH_ARGV]
    with recording() as calls:
        state, model, errors, wall, launches, per_step = drive_train_cli(argv)
    steps = state.step
    log(f"[train CLI] {steps} steps in {wall:.1f} s (incl. model init, data, checkpoint "
        f"writes); launches {launches}; per step {per_step}")
    if steps < 1 or len(errors) != steps:
        raise AssertionError(f"{steps} steps, {len(errors)} loss lines")
    for k, n in per_step.items():
        expect_launches(launches[k], n * steps, f"train CLI {k}")
    expect_groups({}, loss_groups_per_step(model.opt), steps, "train CLI")
    variants = expect_variants(calls, "train CLI")
    log(f"[train CLI] losses, first step {errors[0]}, last step {errors[-1]}; "
        f"variants {variants}")
    # the checkpoint the CLI wrote, back into the serving model
    opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, name="smoke_train", checkpoints_dir=ckpt,
                                 **ARCH)
    serve = create_model(opt)
    if not restore_params(opt, serve):
        raise AssertionError("latest_params.npz not found")
    for (k, a), b in zip(serve.netG.state_dict().items(), model.netG.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"served G differs from the trained G at {k}")
    b, h, w = calls["encode_cond"][0][0]
    out = serve.inference(encode_inputs(1, h, w, serve.device, seed=9))
    torch.cuda.synchronize()
    if tuple(out.shape) != (1, h, w, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"served output {tuple(out.shape)} not finite")
    log(f"[train CLI] latest_params.npz served: output {tuple(out.shape)} finite")
    step_calls = {k: v[: len(v) // steps] for k, v in calls.items()}
    results["train_cli"] = dict(wall_s=wall, steps=steps, launches=launches,
                                per_step=per_step, losses=errors, window=[h, w],
                                variants=variants)
    del model, serve
    torch.cuda.empty_cache()
    return launches, step_calls, variants


def phase_train_cli_bf16(tmp, results):
    """Main path 3: the train CLI in the bf16 tier with the image pool and
    the HTML visuals for one epoch, then --continue_train from its latest
    for a second."""
    root = os.path.join(tmp, "city_train")
    ckpt = os.path.join(tmp, "ckpt_bf16")
    argv = ["--name", "smoke_bf16", "--dataroot", root, "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter_decay", "0", "--print_freq", "1",
            "--display_freq", "4", "--save_epoch_freq", "100", "--nThreads", "2",
            "--dtype", "bfloat16", "--pool_size", "50", *ARCH_ARGV]
    run_dir = os.path.join(ckpt, "smoke_bf16")
    runs, total = [], {k: 0 for k in counters()}
    total_variants = {k: {v: 0 for v in c} for k, c in read_variants().items()}
    done = 0
    for niter, extra in (("1", []), ("2", ["--continue_train"])):
        with recording() as calls:
            state, model, errors, wall, launches, per_step = drive_train_cli(
                argv + ["--niter", niter, *extra])
        variants = expect_variants(calls, f"bf16 train CLI epoch {niter}")
        steps = state.step - done
        done = state.step
        if steps < 1 or len(errors) != steps:
            raise AssertionError(f"bf16 train CLI: {steps} steps, {len(errors)} loss lines")
        for k, n in per_step.items():
            expect_launches(launches[k], n * steps, f"bf16 train CLI {k}")
        expect_groups({}, loss_groups_per_step(model.opt), steps, f"bf16 train CLI epoch {niter}")
        with open(os.path.join(run_dir, "web", "index.html")) as f:
            html = f.read()
        if f"epoch [{niter}]" not in html:
            raise AssertionError(f"web/index.html lacks epoch {niter}")
        with open(os.path.join(run_dir, "iter.txt")) as f:
            it = f.read()
        if it != f"{int(niter) + 1},0":
            raise AssertionError(f"iter.txt {it!r} after epoch {niter}")
        total = {k: total[k] + launches[k] for k in total}
        total_variants = {k: {v: n + variants[k][v] for v, n in c.items()}
                          for k, c in total_variants.items()}
        run = dict(niter=int(niter), continue_train=bool(extra), steps=steps, wall_s=wall,
                   launches=launches, per_step=per_step, variants=variants,
                   losses_first=errors[0],
                   losses_last=errors[-1])
        runs.append(run)
        log(f"[train CLI bf16] {run}")
        del model
        torch.cuda.empty_cache()
    results["train_cli_bf16"] = dict(runs=runs, launches=total, variants=total_variants)
    return total


def phase_roofline(tmp, results):
    """Main path 4: the port's resblock roofline tool; its JSON report."""
    out = os.path.join(tmp, "roofline.json")
    zero_launches()
    with recording() as rec:
        report = roofline_resblock.main(ROOFLINE_ARGV + ["--out", out])
    torch.cuda.synchronize()
    launches = read_launches()
    # the fused kernel: warm-up, timed calls and one compared with the plain
    # composition; the reflect-pad backward: the plain resblock's two pads
    # in each warm-up and timed forward + backward; its forward: the plain
    # conv_in_relu's pad in its timed calls and one compared, the plain
    # resblock's two in its forward and in its forward + backward
    calls = report["iters"] + int(ROOFLINE_ARGV[ROOFLINE_ARGV.index("--warmup") + 1])
    expect_launches(launches, dict({k: 0 for k in launches}, conv3x3_in_act=calls + 1,
                                   reflect_pad_bwd=2 * calls, reflect_pad_fwd=5 * calls + 1),
                    "roofline tool")
    # every call at bs 32 is the wgmma kernel (kernels/conv_in._plan)
    variants = read_variants()["conv3x3_in_act"]
    expect_launches(variants, dict({k: 0 for k in variants}, wgmma=calls + 1),
                    "roofline tool, conv3x3_in_act variants")
    # every pad of the plain resblock folds through the bulk form
    all_variants = expect_variants(rec, "roofline tool")
    pads = all_variants["reflect_pad_bwd"]
    expect_launches(pads, dict({k: 0 for k in pads}, bulk=2 * calls),
                    "roofline tool, reflect_pad_bwd variants")
    with open(out) as f:
        if json.load(f)["kernel_conv_in_relu_fwd"]["ms"] != report["kernel_conv_in_relu_fwd"]["ms"]:
            raise AssertionError("the roofline tool's --out differs from its report")
    log(f"[roofline] launches {launches}, conv3x3_in_act variants {variants}, "
        f"reflect_pad_bwd variants {pads}; report {json.dumps(report)}")
    results["roofline"] = dict(report=report, launches=launches, variants=variants,
                               pad_variants=pads, all_variants=all_variants)
    return launches


def conv_in_main_path_row(dev, results):
    """The JSON row of conv3x3_in_act, timed on the roofline tool's inputs
    (its shape, bf16, ReLU, no residual)."""
    report = results["roofline"]["report"]
    n, h, w, c = report["shape"]
    shape = (n, h, w, c, c)
    gen = torch.Generator(device=dev).manual_seed(14)
    x, w3, b, _ = conv_in_inputs(shape, torch.bfloat16, dev, gen, False)
    with torch.no_grad():
        ok, err, diff_plain = check_conv_in(x, w3, b, True, None, f"{shape} bf16")
        if not ok:
            raise AssertionError(f"conv3x3_in_act at the roofline shape: max|diff| {err}")
        bms, by = conv_in_bound(shape, torch.bfloat16, False)
        row = dict(
            name="conv3x3_in_act", route="cuda", source=f"{PKG}/csrc/conv_in.cu",
            replaces=f"{JAX_PKG}/ops/pallas/conv_in.py:127",
            launches=results["roofline"]["launches"]["conv3x3_in_act"], max_abs_err=err,
            max_abs_diff_vs_plain_bf16=diff_plain,
            ms=graph_ms(lambda: kconv.conv3x3_in_act(x, w3, b, relu=True)),
            plain_ms=graph_ms(lambda: kconv.conv3x3_in_act_plain(x, w3, b, relu=True)),
            bound_ms=bms, bound_by=by, library_ms=None,
            composition_ms=graph_ms(lambda: library_conv_in(x, w3, b, True)),
            per=f"one roofline-tool call, {list(shape)} bf16, ReLU (library_ms: no single "
                "PyTorch call computes it; composition_ms: reflect pad + cuDNN conv + "
                "F.instance_norm + ReLU)",
        )
    row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
    log(f"[main-path kernel] {row}")
    return row


def conv_in_fp32_row(results, path_variants):
    """The JSON row of conv3x3_in_act's fp32 form (the FMA kernel), timed
    at the bs-1 bottleneck in phase 9; launches: its "fma" launches counted
    on each main path (none: the roofline tool runs bf16, and no network
    calls the op)."""
    row = next(r for r in results["conv_in"]["rows"]
               if r["dtype"] == "float32" and tuple(r["shape"]) == CONV_IN_SHAPES[0])
    by_path = {p: v["conv3x3_in_act"]["fma"] for p, v in path_variants.items()}
    out = dict(
        name="conv3x3_in_act (fp32)", route="cuda", source=f"{PKG}/csrc/conv_in.cu",
        replaces=f"{JAX_PKG}/ops/pallas/conv_in.py:127", launches=sum(by_path.values()),
        launches_by_path=by_path,
        max_abs_err=results["conv_in"]["max_err"]["float32"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        library_ms=None, composition_ms=row["composition_ms"], plan=row["plan"],
        per=f"one call at {row['shape']} fp32, ReLU; launches: the \"fma\" launches of the "
            "main paths; max_abs_err over the phase-9 fp32 checks "
            "(library_ms: no single PyTorch call computes it; composition_ms: reflect pad + "
            "cuDNN conv without TF32 + F.instance_norm + ReLU)")
    out["max_abs_diff"], out["kernel_ms"] = out["max_abs_err"], out["ms"]
    log(f"[kernel row] {out}")
    return out


def grads_of(model):
    return [(f"{net}.{n}", p.grad.clone() if p.grad is not None else None)
            for net, m in grad_audit.trained(model).items() for n, p in m.named_parameters()]


def _leaf_diffs(a, b):
    """|a - b| of each leaf with a gradient, as (max|diff| / max|b|,
    ||diff|| / ||b||), by leaf name."""
    out = {}
    for (name, x), (_, y) in zip(a, b):
        if x is None or y is None:
            if x is not None or y is not None:
                raise AssertionError(f"gradient present on one path only: {name}")
            continue
        d = (x - y).double()
        out[name] = ((d.abs().max() / y.abs().max().clamp_min(1e-30)).item(),
                     (d.norm() / y.double().norm().clamp_min(1e-30)).item())
    return out


def _worst(diffs, keep=lambda name: True):
    """The worst kept leaf of _leaf_diffs -> (max|diff| / max|g|,
    ||diff|| / ||g||, the leaf of the first)."""
    mx = nr = 0.0
    where = None
    for name, (m, n) in diffs.items():
        if keep(name):
            if m > mx:
                mx, where = m, name
            nr = max(nr, n)
    return mx, nr, where


def compare_step(model, batch, nudge="image", kernels=TRAIN_KERNELS):
    """One step's loss terms and G/D (and E) gradients, kernel path vs plain path,
    from the same parameters, with cuDNN deterministic so that repeated
    runs give the same bits. Each backward kernel is also swapped alone for
    its plain version. The gradient of this randomly initialized GAN step
    amplifies last-ulp differences of its forward (the IN forward kernel's
    statistics differ from the plain two-pass ones by about an ulp), so the
    whole-path difference is held to twice the gradient's own sensitivity,
    measured here: the change a 1-ulp nudge makes, of the input image
    (``nudge`` "image", mask2image) or of every trained parameter
    ("params", box2mask, whose inputs are one-hot maps and 0/1 masks).
    The instance-feature Encoder's gradient is the generator stem's data
    gradient, behind an IN backward whose dx sums to zero over each channel,
    so E's leaves are cancelled sums (its head's bias most): each E leaf is
    held, in every comparison but the repeat, to STEP_SENS_FACTOR times its
    own 1-ulp sensitivity; G and D as above. ``kernels``: the training
    kernels the step must launch."""
    nets = grad_audit.trained(model)
    params = [p for m in nets.values() for p in m.parameters()]

    def run(ctx, b=batch):
        for m in nets.values():
            m.zero_grad(set_to_none=True)
        with ctx:
            total, metrics, _ = model.losses(b)
            total.backward()
        return {k: v.item() for k, v in metrics.items()}, grads_of(model)

    def nudged(ctx):
        if nudge == "image":
            bumped = dict(batch)
            bumped["image"] = torch.nextafter(batch["image"],
                                              torch.full_like(batch["image"], 2.0))
            return run(ctx, bumped)
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p in params:
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        try:
            return run(ctx)
        finally:
            with torch.no_grad():
                for p, v in zip(params, saved):
                    p.copy_(v)

    none = contextlib.nullcontext
    swaps = {
        "instance_norm_bwd": lambda: mock.patch.object(
            kin, "instance_norm_bwd", kin.instance_norm_bwd_plain),
        "reflect_pad_bwd": lambda: mock.patch.object(
            krp, "reflect_pad_bwd", krp.reflect_pad_bwd_plain),
        "losses": lambda: mock.patch.object(klosses, "reduce_group", klosses.reduce_group_plain),
    }
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = read_launches()
        mk, gk = run(none())
        mid = read_launches()
        if any(mid[k] == before[k] for k in kernels):
            raise AssertionError(f"a training kernel did not launch: {before} -> {mid}")
        mp, gp = run(plain_path())
        if read_launches() != mid:
            raise AssertionError("the plain path launched a kernel")
        repeat = _worst(_leaf_diffs(run(none())[1], gk))
        alone_all = {k: _leaf_diffs(run(ctx())[1], gk) for k, ctx in swaps.items()}
        sens_k_all = _leaf_diffs(nudged(none())[1], gk)
        sens_p_all = _leaf_diffs(nudged(plain_path())[1], gp)
    finally:
        torch.backends.cudnn.deterministic = prev
    loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mk)
    whole_all = _leaf_diffs(gk, gp)

    def g_or_d(name):
        return not name.startswith("E.")

    alone = {k: _worst(v, g_or_d) for k, v in alone_all.items()}
    whole, sens_k, sens_p = (_worst(d, g_or_d) for d in (whole_all, sens_k_all, sens_p_all))
    sens = (max(sens_k[0], sens_p[0]), max(sens_k[1], sens_p[1]))
    # each E leaf against its own sensitivity: (worst diff / (factor x sensitivity), where)
    e_ratio = {}
    for what, diffs in (("whole", whole_all), *alone_all.items()):
        for name, d in diffs.items():
            if not g_or_d(name):
                s = [max(sens_k_all[name][i], sens_p_all[name][i]) for i in (0, 1)]
                r = max(d[i] / max(STEP_SENS_FACTOR * s[i], 1e-30) for i in (0, 1))
                if r >= e_ratio.get(what, (0.0, None))[0]:
                    e_ratio[what] = (r, name)
    log(f"[step] kernel vs plain: losses {mk} vs {mp}, max rel {loss_rel:.3g}")
    log(f"[step] gradients (max|diff|/max|g|, ||diff||/||g||, worst leaf): kernel path "
        f"repeated {repeat}; one kernel plain at a time {alone}; whole plain path {whole}; "
        f"1-ulp {nudge} nudge, kernel path {sens_k}, plain path {sens_p}")
    if e_ratio:
        log(f"[step] E's leaves, worst diff / ({STEP_SENS_FACTOR}x its own 1-ulp sensitivity): "
            f"{e_ratio}")
    if loss_rel > STEP_LOSS_RTOL or repeat[0] > STEP_GRAD_TOL:
        raise AssertionError(f"step: losses max rel {loss_rel}, repeat {repeat}")
    bad = {k: v for k, v in alone.items() if v[0] > STEP_GRAD_TOL}
    if bad:
        raise AssertionError(f"a backward kernel moves the gradients: {bad}")
    if whole[0] > STEP_SENS_FACTOR * sens[0] or whole[1] > STEP_SENS_FACTOR * sens[1]:
        raise AssertionError(f"kernel vs plain gradients {whole} beyond "
                             f"{STEP_SENS_FACTOR}x the 1-ulp sensitivity {sens}")
    bad = {k: v for k, v in e_ratio.items() if v[0] > 1.0}
    if bad:
        raise AssertionError(f"E's gradients beyond {STEP_SENS_FACTOR}x their 1-ulp "
                             f"sensitivity: {bad}")
    return dict(losses_kernel=mk, losses_plain=mp, max_loss_rel=loss_rel, repeat=repeat,
                one_kernel_plain=alone, whole_plain_path=whole,
                one_ulp_sensitivity={"kernel": sens_k, "plain": sens_p},
                encoder_vs_own_sensitivity=e_ratio,
                leaves=sum(g is not None for _, g in gk),
                leaves_by_net={net: sum(g is not None and n.startswith(f"{net}.")
                                        for n, g in gk) for net in nets})


def time_train_step(step, state, batch, iters, per_step, what, per_variant=None,
                    plain_iters=None):
    """``iters`` train steps after two of warm-up, counters read around
    them and held to ``per_step`` launches (and ``per_variant``) a step;
    every loss finite; then the plain path's ms a step over ``plain_iters``
    (default ``iters``) -> (ms, peak memory bytes, plain ms, losses, the
    step's second output)."""
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, vbefore = read_launches(), read_variants()
    t = time.perf_counter()
    for _ in range(iters):
        metrics, out = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / iters * 1e3
    peak = torch.cuda.max_memory_allocated()
    after, vafter = read_launches(), read_variants()
    for k, n in per_step.items():
        expect_launches(after[k] - before[k], n * iters, f"{what} {k}")
    for kind, want in (per_variant or {}).items():
        expect_launches({k: vafter[kind][k] - vbefore[kind][k] for k in want},
                        {k: n * iters for k, n in want.items()}, f"{what}, {kind} variants")
    losses = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{what}: losses {losses}")
    plain_iters = plain_iters or iters
    with plain_path():
        step(state, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(plain_iters):
            step(state, batch)
        torch.cuda.synchronize()
    return ms, peak, (time.perf_counter() - t) / plain_iters * 1e3, losses, out


def phase_train_step(dev, results):
    """make_train_step at STEP_HW fp32: times (kernel and plain path), peak
    memory, the launches a step, the kernel-vs-plain step, and the calls one
    bs-1 step makes of each training kernel (for the per-step kernel table)."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, **ARCH)
    model = create_model(opt)
    step = make_train_step(model)
    rows = []
    for bs, iters in ((1, 10), (4, 4)):
        batch = encode_inputs(bs, *STEP_HW, dev, seed=8)
        state = make_optimizers(opt, model, 1000)
        ms, peak, plain, losses, _ = time_train_step(
            step, state, batch, iters, per_step_of(model), f"fp32 step bs {bs}",
            plain_iters=max(2, iters // 2))
        row = dict(bs=bs, hw=list(STEP_HW), dtype="float32", precision="highest",
                   ms_per_step=ms, images_per_s=bs * 1e3 / ms, ms_per_image=ms / bs,
                   plain_ms_per_step=plain, peak_mem_bytes=peak, losses=losses)
        rows.append(row)
        log(f"[step] {row}")
    batch = encode_inputs(1, *STEP_HW, dev, seed=10)
    cmp = compare_step(model, batch)
    state = make_optimizers(opt, model, 1000)
    since = read_variants()
    with recording() as calls:
        step(state, batch)
    torch.cuda.synchronize()
    expect_groups({k: since[k]["group"] for k in ("mse_to_scalar", "l1_to_scalar")},
                  loss_groups_per_step(opt), 1, "fp32 step")
    got = expect_variants(calls, "fp32 step", since)
    variants = {k: {v: n - since[k][v] for v, n in c.items()} for k, c in got.items()}
    log(f"[step] variants per step {variants}")
    results["step"] = dict(rows=rows, kernel_vs_plain=cmp, variants_per_step=variants)
    del model
    torch.cuda.empty_cache()
    return calls


def phase_train_step_bf16(dev, results):
    """make_train_step in the bf16 tier at STEP_HW: times (kernel and plain
    path), peak memory and the launches of every kernel per step."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype="bfloat16", **ARCH)
    model = create_model(opt)
    step = make_train_step(model, torch.bfloat16)
    per_step = per_step_of(model)
    rows = []
    for bs, iters in ((1, 10), (4, 4)):
        batch = encode_inputs(bs, *STEP_HW, dev, seed=8)
        state = make_optimizers(opt, model, 1000)
        with recording() as calls:
            step(state, batch)
        if bs == 1:
            step_calls = calls
        per_variant = {k: plan_variants(k, calls[k], calls["loss_group"])
                       for k in PLANNED + ("mse_to_scalar", "l1_to_scalar")}
        expect_launches({k: v["group"] for k, v in per_variant.items() if "group" in v},
                        loss_groups_per_step(opt), f"bf16 step bs {bs}, loss groups recorded")
        ms, peak, plain, losses, fake = time_train_step(
            step, state, batch, iters, per_step, f"bf16 step bs {bs}", per_variant,
            plain_iters=max(2, iters // 2))
        if fake.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 step bs {bs}: fake {fake.dtype}")
        row = dict(bs=bs, hw=list(STEP_HW), dtype="bfloat16",
                   precision=model.conv_precision_resolved, ms_per_step=ms,
                   images_per_s=bs * 1e3 / ms, ms_per_image=ms / bs, plain_ms_per_step=plain,
                   peak_mem_bytes=peak, losses=losses,
                   launches_per_step=per_step, variants_per_step=per_variant)
        rows.append(row)
        log(f"[step bf16] {row}")
    results["step_bf16"] = rows
    del model
    torch.cuda.empty_cache()
    # the IN forward, the reflect-pad backward and forward and the loss
    # groups over the calls of one bs-1 bf16 step
    table = []
    for i, name in enumerate(("instance_norm", "reflect_pad_bwd", "reflect_pad_fwd")):
        trow = dict(name=name, **time_sites(name, step_calls[name], dev, seed=60 + i))
        table.append(trow)
        log(f"[step bf16 {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    for i, name in enumerate(("mse_to_scalar", "l1_to_scalar")):
        trow = dict(name=name, **time_loss_groups(name, step_calls["loss_group"], dev, 63 + i))
        table.append(trow)
        log(f"[step bf16 {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    results["train_step_kernels_bf16"] = table


# ---------------------------------------------------------------- box2mask

def flags(overrides):
    """Option overrides as CLI flags."""
    return [a for k, v in overrides.items() for a in (f"--{k}", str(v))]


def b2m_batch(bs, dev, seed):
    """Synthetic box2mask crops (data/synthetic.synthetic_box2mask_batch) on
    the card; the first sample of a batch of 2 or more takes the null class
    -1 (a background box: a zero one-hot, an empty object mask)."""
    opt = BoxToMaskTrainOptions(**B2M_ARCH)
    batch = synthetic_box2mask_batch(np.random.RandomState(seed), bs, size=opt.fineSize,
                                     label_nc=opt.label_nc)
    if bs > 1:
        batch["cls"][0] = -1
        batch["gt_objmask"][0] = 0.0
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def step_calls_of(model, batch, dtype):
    """The calls one train step on ``batch`` (the objective and its
    backward, fp32 or the bf16 tier) makes of each kernel."""
    params, b = _loss_inputs(model, batch, dtype if dtype == torch.bfloat16 else None)
    with recording() as calls:
        total, _, _ = model.losses(b, params)
        total.backward()
    torch.cuda.synchronize()
    for m in model.nets().values():
        m.zero_grad(set_to_none=True)
    return calls


def check_loss_group(table, dev, gen, what):
    """One recorded loss launch on fresh operands of its terms' shapes: two
    terms of one shape are the halves of one tensor, as D's [real; fake]
    logits are (the second half off the 16-byte grid where its offset is);
    the group twice, the same bits both times and as each term alone, and
    within LOSS_RTOL of the plain version -> max |diff|."""
    shapes = [shape for _, shape, _, _ in table]
    dt = table[0][2]
    if len(table) == 2 and shapes[0] == shapes[1]:
        buf = torch.randn((2 * shapes[0][0], *shapes[0][1:]), generator=gen, device=dev).to(dt)
        ops = [buf[: shapes[0][0]], buf[shapes[0][0]:]]
    else:
        ops = [torch.randn(shape, generator=gen, device=dev).to(dt) for shape in shapes]
    terms = [(m, a, t if t is not None else torch.randn_like(a)) for (m, _, _, t), a
             in zip(table, ops)]
    mode = "mse_to_scalar" if table[0][0] == "mse" else "l1_to_scalar"
    before = read_variants()[mode]["group"]
    got, again = klosses.reduce_group(terms), klosses.reduce_group(terms)
    if read_variants()[mode]["group"] - before != 2:
        raise AssertionError(f"{what}: not one launch a group")
    alone = torch.cat([klosses.reduce_group([term]) for term in terms])
    want = klosses.reduce_group_plain(terms)
    torch.cuda.synchronize()
    if not (same_bits(got, again) and same_bits(got, alone)):
        raise AssertionError(f"{what}: bits differ twice or alone")
    return check_close(got, want, torch.float32, 0.0, what, rtol=LOSS_RTOL)


def check_recorded(recorded, dev, seed, tag):
    """Each distinct recorded call of rows 4-7 and of the reflect pad's
    forward (and of encode and encode_cond, where recorded) on fresh inputs
    of its shape: against its
    plain version on the variant its plan picks, the same bits twice (the
    encodes bit-exact, in fp32 and bf16) -> (max |kernel - plain| by kind
    and dtype, calls checked by kind)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs, counts = {}, {}

    def keep(kind, dt, err):
        key = f"{kind}/{str(dt)[6:]}"
        errs[key] = max(errs.get(key, 0.0), err)
        counts[kind] = counts.get(kind, 0) + 1

    distinct = {k: sorted({tuple(c) for calls in recorded.values() for c in calls[k]}, key=str)
                for k in PLANNED + ("loss_group", "encode", "encode_cond")}
    for shape, dt, act, has_res in distinct["instance_norm"]:
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
        r = torch.randn(shape, generator=gen, device=dev).to(dt) if has_res else None
        keep("instance_norm", dt, check_in_fwd(x, act, r, f"{tag} IN {shape} {dt} {act}"))
    for shape, dt, act, want_dres in distinct["instance_norm_bwd"]:
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
        gy = torch.randn(shape, generator=gen, device=dev).to(dt)
        r = torch.randn(shape, generator=gen, device=dev).to(dt) if want_dres else None
        keep("instance_norm_bwd", dt,
             check_in_bwd(x, gy, act, r, f"{tag} IN bwd {shape} {dt} {act}"))
    for shape, dt, pad in distinct["reflect_pad_bwd"]:
        dy = torch.randn(shape, generator=gen, device=dev).to(dt)
        keep("reflect_pad_bwd", dt, check_pad_bwd(dy, pad, f"{tag} pad bwd {shape} p{pad}"))
    for shape, dt, pad, aligned in distinct["reflect_pad_fwd"]:
        x = pad_fwd_input(shape, dt, aligned, gen, dev)
        keep("reflect_pad_fwd", dt, check_pad_fwd(x, pad, f"{tag} pad fwd {shape} p{pad}"))
    for table in distinct["loss_group"]:
        keep("loss_group", table[0][2],
             check_loss_group(list(table), dev, gen, f"{tag} loss group {table}"))
    for call in distinct["encode"]:
        if len(call) != 2:      # a no-image call: encode_cond's, checked below
            continue
        (b, h, w), pad = call
        inp = encode_inputs(b, h, w, dev, seed=seed)
        for dt in (torch.float32, torch.bfloat16):
            args = (inp["label"], inp["inst"], inp["image"].to(dt), inp["boxes"], 35)
            got, again = twice_on("encode", f"pad{pad}", lambda: kenc.encode(*args, pad=pad),
                                  f"{tag} encode {call}")
            if not (same_bits(got, again) and same_bits(got, kenc.encode_plain(*args, pad=pad))):
                raise AssertionError(f"{tag} encode {call} {dt}: not bit-exact")
            keep("encode", dt, 0.0)
    for (b, h, w), has_inst, nc, dt in distinct["encode_cond"]:
        inp = encode_inputs(b, h, w, dev, seed=seed + 1)
        args = (inp["label"], inp["inst"] if has_inst else None, nc, dt)
        got, again = kenc.encode_cond(*args), kenc.encode_cond(*args)
        if not (same_bits(got, again) and same_bits(got, kenc.encode_cond_plain(*args))):
            raise AssertionError(f"{tag} encode_cond {(b, h, w)} {dt}: not bit-exact")
        keep("encode_cond", dt, 0.0)
    return errs, counts


def phase_b2m_kernels(dev, results):
    """Phase 13: rows 4-7 at box2mask's shapes. The calls one full-width
    train step makes of each kernel, recorded at bs 1 and 2, fp32 and bf16;
    each distinct call checked against its plain version on the variant its
    plan picks, the same bits twice; the bs-1 fp32 step's calls timed."""
    model = create_model(BoxToMaskTrainOptions(gpu_ids=GPU_IDS, **B2M_ARCH))
    per_step = b2m_per_step(model.opt)
    recorded = {(bs, dt): step_calls_of(model, b2m_batch(bs, dev, seed=40 + bs), dt)
                for bs in (1, 2) for dt in (torch.float32, torch.bfloat16)}
    del model
    torch.cuda.empty_cache()
    for (bs, dt), calls in recorded.items():
        got = {k: len(calls[k]) for k in PLANNED + ("mse_to_scalar", "loss_group_bwd")}
        want = {k: per_step[k] for k in got}
        expect_launches(got, want, f"box2mask step bs {bs} {dt}, calls recorded")
        expect_launches(len(calls["loss_group"]), loss_groups_per_step(
            BoxToMaskTrainOptions())["mse_to_scalar"], f"box2mask step bs {bs} {dt}, loss groups")
    errs, counts = check_recorded(recorded, dev, 15, "box2mask")
    log(f"[box2mask kernels] distinct calls checked {counts}; max|kernel - plain| {errs}")
    step_calls = recorded[(1, torch.float32)]
    table = [dict(name=name, **time_sites(name, step_calls[name], dev, seed=70 + i))
             for i, name in enumerate(PLANNED)]
    table.append(dict(name="mse_to_scalar",
                      **time_loss_groups("mse_to_scalar", step_calls["loss_group"], dev, 73)))
    for row in table:
        log(f"[box2mask step 128x128 bs 1 fp32] {row}")
    results["box2mask_kernels"] = dict(max_err=errs, distinct_calls=counts, step_table=table)


def phase_b2m_cli(tmp, results):
    """Phase 14, main path 5: the box2mask train CLI at full width with the
    background boxes and the negative-class term on, one epoch over phase
    6's scenes; then box2mask_test from its latest over phase 5's."""
    ckpt = os.path.join(tmp, "ckpt_b2m")
    argv = ["--name", "smoke_b2m", "--dataroot", os.path.join(tmp, "city_train"),
            "--checkpoints_dir", ckpt, "--gpu_ids", GPU_IDS, "--niter", "1",
            "--niter_decay", "0", "--print_freq", "1", "--save_epoch_freq", "100",
            "--nThreads", "2", "--bg_box_prob", "0.25", "--lambda_ctx_neg", "5.0",
            *flags(B2M_ARCH)]
    classes = []
    orig_to_device = train_loop.to_device

    def seen(host_batch, device):
        classes.extend(int(c) for c in host_batch["cls"])
        return orig_to_device(host_batch, device)

    with recording() as calls, mock.patch.object(train_loop, "to_device", seen):
        state, model, errors, wall, launches, per_step = drive_train_cli(argv, box2mask_train)
    steps = state.step
    log(f"[box2mask train CLI] {steps} steps in {wall:.1f} s (incl. model init, data, "
        f"checkpoint writes); launches {launches}; per step {per_step}; classes {classes}")
    if steps < 1 or len(errors) != steps:
        raise AssertionError(f"box2mask train CLI: {steps} steps, {len(errors)} loss lines")
    want_keys = {"G_GAN", "G_recon", "G_obj", "G_ctxneg", "D_real", "D_fake"}
    if any(set(e) != want_keys for e in errors):
        raise AssertionError(f"box2mask loss lines {errors[0]}")
    if -1 not in classes:
        raise AssertionError("no background-box sample drawn")
    for k, n in per_step.items():
        expect_launches(launches[k], n * steps, f"box2mask train CLI {k}")
    expect_groups({}, loss_groups_per_step(model.opt), steps, "box2mask train CLI")
    variants = expect_variants(calls, "box2mask train CLI")
    log(f"[box2mask train CLI] losses, first step {errors[0]}, last step {errors[-1]}; "
        f"variants {variants}")
    g_sites = per_step["instance_norm"] - 2 * model.opt.n_layers_D
    g_pads = per_step["reflect_pad_fwd"]
    del model
    torch.cuda.empty_cache()

    out, how_many = io.StringIO(), 4
    zero_launches()
    t = time.time()
    with recording() as scalls, contextlib.redirect_stdout(out):
        box2mask_test.main(["--name", "smoke_b2m", "--dataroot", os.path.join(tmp, "city"),
                            "--checkpoints_dir", ckpt, "--gpu_ids", GPU_IDS,
                            "--results_dir", os.path.join(tmp, "results_b2m"),
                            "--how_many", str(how_many), *flags({**B2M_DEPTH, **B2M_ARCH})])
    torch.cuda.synchronize()
    swall = time.time() - t
    text = out.getvalue()
    log(text.rstrip())
    slaunches = read_launches()
    if "restored checkpoint 'latest'" not in text or "partial load" in text:
        raise AssertionError("box2mask_test did not restore latest in full")
    expect_launches(slaunches, dict({k: 0 for k in slaunches}, instance_norm=g_sites * how_many,
                                    reflect_pad_fwd=g_pads * how_many), "box2mask serving CLI")
    svariants = expect_variants(scalls, "box2mask serving CLI")
    with open(os.path.join(tmp, "results_b2m", "smoke_b2m", "test_latest", "index.html")) as f:
        html = f.read()
    if html.count("predicted_layout") < how_many:
        raise AssertionError("box2mask gallery incomplete")
    log(f"[box2mask test CLI] {swall:.1f} s; launches {slaunches}; IN variants "
        f"{svariants['instance_norm']}")
    results["box2mask_cli"] = dict(
        train=dict(wall_s=wall, steps=steps, launches=launches, per_step=per_step,
                   losses=errors, classes=classes, variants=variants),
        serving=dict(wall_s=swall, crops=how_many, launches=slaunches, variants=svariants))
    return launches, variants, slaunches, svariants


def phase_b2m_step(dev, results):
    """Phase 15: make_train_step on BoxToMaskModel at fineSize, bs 1 and 16,
    fp32 and bf16 (times, peak memory, per-step launches, the plain path's
    time); the fp32 step's kernel path against its plain path; inference at
    bs 1 (ms/crop, merged probs against the plain path)."""
    rows, cmp = [], None
    for dtype in ("float32", "bfloat16"):
        opt = BoxToMaskTrainOptions(gpu_ids=GPU_IDS, dtype=dtype, lambda_ctx_neg=5.0, **B2M_ARCH)
        model = create_model(opt)
        step = make_train_step(model, torch.bfloat16 if dtype == "bfloat16" else None)
        per_step = b2m_per_step(opt)
        for bs, iters in B2M_STEP_BS:
            batch = b2m_batch(bs, dev, seed=50 + bs)
            state = make_optimizers(opt, model, 1000)
            ms, peak, plain, losses, merged = time_train_step(
                step, state, batch, iters, per_step, f"box2mask step {dtype} bs {bs}",
                plain_iters=max(2, iters // 2))
            row = dict(bs=bs, hw=[opt.fineSize] * 2, dtype=dtype,
                       precision=model.conv_precision_resolved, ms_per_step=ms,
                       crops_per_s=bs * 1e3 / ms, ms_per_crop=ms / bs, plain_ms_per_step=plain,
                       peak_mem_bytes=peak, merged_dtype=str(merged.dtype), losses=losses)
            rows.append(row)
            log(f"[box2mask step] {row}")
        if dtype == "float32":
            cmp = compare_step(model, b2m_batch(1, dev, seed=60), nudge="params",
                               kernels=("instance_norm_bwd", "mse_to_scalar", "reflect_pad_bwd",
                                        "reflect_pad_fwd"))
        del model
        torch.cuda.empty_cache()
    # inference, fp32 at bs 1, through the test options (the trained depth)
    model = create_model(BoxToMaskTestOptions(gpu_ids=GPU_IDS, **{**B2M_DEPTH, **B2M_ARCH}))
    batch = b2m_batch(1, dev, seed=61)
    merged, obj = model.inference(batch)
    with plain_path():
        ref, ref_obj = model.inference(batch)
    torch.cuda.synchronize()
    diff = max((merged - ref).abs().max().item(), (obj - ref_obj).abs().max().item())
    if not torch.isfinite(merged).all() or diff > B2M_PROBS_ATOL:
        raise AssertionError(f"box2mask inference: kernel vs plain max|diff| {diff}")
    ms = cuda_ms(lambda: model.inference(batch), 20)
    with plain_path():
        plain = cuda_ms(lambda: model.inference(batch), 20)
    infer = dict(bs=1, hw=list(merged.shape[1:3]), dtype="float32", ms_per_crop=ms,
                 plain_ms_per_crop=plain, max_abs_diff_vs_plain=diff)
    log(f"[box2mask inference] {infer}")
    del model
    torch.cuda.empty_cache()
    results["box2mask_step"] = dict(rows=rows, kernel_vs_plain=cmp, inference=infer)


# ---------------------------------------------------------------- two-step, evaluate

def b2m_generator_sites(bs, s, ngf=64, n_down=3, n_blocks=4):
    """(shape, act, residual?) of every IN site of one structure-generator
    forward, in order: stem, downs, cls_norm, 2 per resblock, then each
    decoder's ups (19 at full width)."""
    sites = [((bs, s, s, ngf), "relu", False)]
    sites += [((bs, s >> i, s >> i, ngf << i), "relu", False) for i in range(1, n_down + 1)]
    mid = (bs, s >> n_down, s >> n_down, ngf << n_down)
    sites.append((mid, "none", False))
    for _ in range(n_blocks):
        sites += [(mid, "relu", False), (mid, "none", True)]
    ups = [((bs, s >> i, s >> i, ngf << i), "relu", False) for i in range(n_down - 1, -1, -1)]
    return sites + ups + ups


def stage_sites(model, bs=1):
    """The IN calls of one generator forward of a stage at its fineSize, as
    the recording describes them (fp32)."""
    g, s = model.netG, model.opt.fineSize
    if isinstance(model, BoxToMaskModel):
        sites = b2m_generator_sites(bs, s, g.enc_in.weight.shape[0], g.n_downsampling,
                                    g.n_blocks)
    else:
        sites = generator_sites(bs, s, s, g.conv_in.weight.shape[0], g.n_downsampling,
                                g.n_blocks)
    return [(shape, torch.float32, act, res) for shape, act, res in sites]


def expect_path_launches(calls, launches, in_sites, encodes, pads, what):
    """A path's launches held to what its architecture reckons: the IN
    forward at `in_sites` (in order, and per variant as
    kernels/instance_norm._fwd_plan picks), encode at `encodes` ((label
    shape, pad) each), the reflect pad's forward at `pads` calls (per
    variant as kernels/reflect_pad._fwd_plan picks), every other kernel 0."""
    if calls["instance_norm"] != in_sites:
        raise AssertionError(f"{what}: IN calls off the architecture "
                             f"({len(calls['instance_norm'])} against {len(in_sites)})")
    if calls["encode"] != encodes:
        raise AssertionError(f"{what}: encode calls {calls['encode']}, expected {encodes}")
    if len(calls["reflect_pad_fwd"]) != pads:
        raise AssertionError(f"{what}: {len(calls['reflect_pad_fwd'])} reflect pads, "
                             f"expected {pads}")
    expect_launches(launches, dict({k: 0 for k in launches}, encode=len(encodes),
                                   instance_norm=len(in_sites), reflect_pad_fwd=pads), what)
    variants = read_variants()
    for kind in ("instance_norm", "reflect_pad_fwd"):
        expect_launches(variants[kind], plan_variants(kind, calls[kind]),
                        f"{what}, {kind} variants")
    return variants


def add_paths(total, launches, variants):
    """Sum one CLI run's launches and variants into a path's totals."""
    for k, n in launches.items():
        total["launches"][k] = total["launches"].get(k, 0) + n
    for k, c in variants.items():
        mine = total["variants"].setdefault(k, {v: 0 for v in c})
        for v, n in c.items():
            mine[v] += n


def tf32_now():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def two_step_runs_dir(tmp):
    """One checkpoints directory holding the runs the demo reads: phase
    14's box2mask run, phases 6's and 10's mask2image runs (links)."""
    runs = os.path.join(tmp, "ckpt_two_step")
    os.makedirs(runs, exist_ok=True)
    for src in (os.path.join(tmp, "ckpt_b2m", "smoke_b2m"), os.path.join(tmp, "ckpt", "smoke_train"),
                os.path.join(tmp, "ckpt_bf16", "smoke_bf16")):
        os.symlink(src, os.path.join(runs, os.path.basename(src)))
    return runs


def outside_passthrough(out, image, label, inst, box_list):
    """Max |output - input| outside the union of the edit's boxes, over the
    completed label, the edited instance map and the edited image (on the
    card; 0 is a bit-exact passthrough)."""
    inside = sum(box_mask(b, label.shape[1:3])[..., 0] for b in box_list) > 0
    worst = 0.0
    for key, ref in (("completed_label", label), ("edited_inst", inst),
                     ("edited_image", image)):
        d = (out[key].to(torch.float64) - ref.to(torch.float64)).abs()
        if d.dim() == 4:
            d = d.amax(-1)
        worst = max(worst, d[~inside].max().item() if (~inside).any() else 0.0)
    return worst


def phase_two_step_cli(tmp, results):
    """Phase 16, main path 6: the port's two_step_demo CLI at full width on
    the card, restoring phase 14's box2mask run and phase 6's mask2image run
    (then phase 10's bf16 run), over phase 5's scenes; add, remove and swap
    with 4 edits each, then one add with the bf16 stage."""
    runs = two_step_runs_dir(tmp)
    total = {"launches": {}, "variants": {}}
    rows = []
    orig_create = two_step_demo.create_model
    orig_manip = TwoStepPipeline.manipulate
    for edit, m2i_name in (("add", "smoke_train"), ("remove", "smoke_train"),
                           ("swap", "smoke_train"), ("add", "smoke_bf16")):
        models, seen, bad = [], [], []

        def create_and_keep(opt):
            models.append(orig_create(opt))
            return models[-1]

        def spy_b2m(self, batch, return_ctx=False):
            seen.append(("b2m", tf32_now()))
            return orig_b2m(self, batch, return_ctx)

        def spy_m2i(self, batch):
            seen.append(("m2i", tf32_now()))
            return orig_m2i(self, batch)

        def checked(self, image, label, inst, boxes, cls, mode="add"):
            out = orig_manip(self, image, label, inst, boxes, cls, mode)
            if not torch.isfinite(out["edited_image"]).all():
                bad.append("non-finite edited image")
            if outside_passthrough(out, image, label, inst, [boxes]) != 0.0:
                bad.append("outside-box passthrough")
            return out

        orig_b2m, orig_m2i = BoxToMaskModel.inference, Pix2PixHDModel.inference
        name = f"demo_{edit}_{m2i_name}"
        argv = ["--name", name, "--b2m_name", "smoke_b2m", "--m2i_name", m2i_name,
                "--checkpoints_dir", runs, "--results_dir", os.path.join(tmp, "results_two_step"),
                "--dataroot", os.path.join(tmp, "city"), "--edit", edit, "--how_many", "4",
                "--loadSize", str(DATAROOT_HW[1]), "--gpu_ids", GPU_IDS]
        out = io.StringIO()
        zero_launches()
        t = time.time()
        with recording() as calls, contextlib.redirect_stdout(out), \
                mock.patch.object(two_step_demo, "create_model", create_and_keep), \
                mock.patch.object(BoxToMaskModel, "inference", spy_b2m), \
                mock.patch.object(Pix2PixHDModel, "inference", spy_m2i), \
                mock.patch.object(TwoStepPipeline, "manipulate", checked):
            done = two_step_demo.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t
        text = out.getvalue()
        log(text.rstrip())
        launches = read_launches()
        b2m, m2i = models
        if bad:
            raise AssertionError(f"two-step demo {edit}: {sorted(set(bad))}")
        if done != 4 or text.count("adopted architecture") != 2 or \
                text.count("restored checkpoint 'latest'") != 2 or "partial load" in text:
            raise AssertionError(f"two-step demo {edit} {m2i_name}: {done} edits; {text!r}")
        passes = done * (2 if edit == "swap" else 1)
        ms = m2i.opt.fineSize
        variants = expect_path_launches(
            calls, launches, (stage_sites(b2m) + stage_sites(m2i)) * passes,
            [((1, ms, ms), 3)] * passes, (forward_pads(b2m) + forward_pads(m2i)) * passes,
            f"two-step demo {edit} {m2i_name}")
        # each stage's inference under its own tier's TF32 switches
        tier = {"b2m": b2m.conv_precision_resolved == "default",
                "m2i": m2i.conv_precision_resolved == "default"}
        wrong = [(k, v) for k, v in seen if v != (tier[k], tier[k])]
        if len(seen) != 2 * passes or wrong:
            raise AssertionError(f"two-step demo {edit} {m2i_name}: TF32 seen {wrong}, tiers {tier}")
        with open(os.path.join(tmp, "results_two_step", name, "index.html")) as f:
            html = f.read()
        if html.count("<h3>") != done or html.count("completed_label") < done or \
                len(os.listdir(os.path.join(tmp, "results_two_step", name, "images"))) != 4 * done:
            raise AssertionError(f"two-step demo {edit}: gallery incomplete")
        add_paths(total, launches, variants)
        row = dict(edit=edit, m2i=m2i_name, edits=done, passes=passes, wall_s=wall,
                   launches=launches, in_variants=variants["instance_norm"],
                   precision={"b2m": b2m.conv_precision_resolved,
                              "m2i": m2i.conv_precision_resolved},
                   tf32_seen=sorted(set(seen)), m2i_window=ms, b2m_crop=b2m.opt.fineSize)
        rows.append(row)
        log(f"[two-step demo] {row}")
        del models, b2m, m2i
        torch.cuda.empty_cache()
    results["two_step_cli"] = dict(runs=rows, **total)
    return total["launches"], total["variants"]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms (the transposed
    convolutions' data-gradient algorithms otherwise may sum in another
    order from one call to the next); the port's kernels and ops are
    deterministic either way."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def host_ms(fn, iters):
    """Host-clock ms a call of fn() over iters calls, the card synchronized
    before and after (warmed up by the caller)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def interleaved_ms(fns, iters, rounds):
    """Each of fns (name -> fn) timed by CUDA events (``cuda_ms``) over
    ``rounds`` rounds of ``iters`` calls, the fns taking turns each round:
    name -> {"rounds": ms a call in each round, "median", "spread": (max -
    min) / median}."""
    got = {who: [] for who in fns}
    for _ in range(rounds):
        for who, fn in fns.items():
            got[who].append(cuda_ms(fn, iters, warmup=1))
    out = {}
    for who, ms in got.items():
        med = float(np.median(ms))
        out[who] = dict(rounds=ms, median=med, spread=(max(ms) - min(ms)) / med)
    return out


def edit_fills(pipe):
    """Context manager: the fill probabilities (merged, or the context
    stream's under the null class) and box masks of every structure-
    generator call of the pipeline, in order."""
    fills = []
    orig = pipe.b2m.inference

    def spy(batch, return_ctx=False):
        merged, obj, ctx = orig(batch, return_ctx=True)
        fills.append((torch.where(batch["cls"][:, None, None, None] < 0, ctx, merged),
                      batch["boxmask"]))
        return merged, obj, ctx

    return fills, mock.patch.object(pipe.b2m, "inference", spy)


def near_tie_masks(pipe, fills, box_list, hw):
    """The pixels whose fill the plain path's top two probabilities decide
    by less than TIE_MARGIN, per pass: in its window, in the full map
    (through the window layout's nearest paste) and in the image
    generator's window (its nearest crop); unions over the passes of an
    edit (a swap's remove pass feeds its add pass)."""
    near = {"window": None, "full": None, "m2i": None}
    full = torch.zeros((box_list[0].shape[0], *hw), dtype=torch.bool, device=box_list[0].device)
    ms = pipe.m2i_size
    for (fill, boxmask), boxes in zip(fills, box_list):
        windows = expand_to_context_window(boxes, hw, pipe.margin, out_size=pipe.crop_size)
        top2 = fill.topk(2, dim=-1).values
        win = ((top2[..., 0] - top2[..., 1]) < TIE_MARGIN) & (boxmask[..., 0] > 0)
        pasted = paste_resize(torch.zeros((*full.shape, 1), device=full.device),
                              win[..., None].float(), windows, method="nearest")[..., 0]
        full = full | ((pasted > 0) & (box_mask(boxes, hw)[..., 0] > 0))
        near["window"] = win
        near["m2i"] = crop_resize(full[..., None].float(), windows, (ms, ms),
                                  method="nearest")[..., 0] > 0
    near["full"] = full
    return near


def compare_edit(out, ref, near, what):
    """The kernel path's edit against the plain path's: the integer maps
    equal except at near-tie pixels, the windows equal; the images within
    TWO_STEP_ATOL where no near-tie pixel flipped (a flipped label changes
    the image generator's input). -> (near-tie pixels, flipped pixels,
    max |image diff| or None)."""
    allowed = {"completed_label": near["full"], "edited_inst": near["full"],
               "window_layout": near["window"], "window_inst": near["m2i"]}
    flipped = 0
    for key, ok in allowed.items():
        differ = out[key] != ref[key]
        if (differ & ~ok).any():
            raise AssertionError(f"{what}: {key} differs at {(differ & ~ok).sum().item()} "
                                 "pixels off the near ties")
        flipped += differ.sum().item()
    if not torch.equal(out["windows"], ref["windows"]):
        raise AssertionError(f"{what}: windows differ")
    count = int(near["full"].sum().item())
    if flipped:
        return count, flipped, None
    err = max((out[k] - ref[k]).abs().max().item()
              for k in ("edited_image", "window_rgb", "object_mask"))
    if err > TWO_STEP_ATOL:
        raise AssertionError(f"{what}: kernel vs plain max|diff| {err}")
    return count, flipped, err


def load_scenes(root, n):
    """The first n scenes of a dataroot at full size, with each scene's
    first object box (data/bbox.bboxes_from_instance_map, min size 16), as
    the demo takes them."""
    opt = MaskToImageTestOptions(dataroot=root, resize_or_crop="scale_width",
                                 loadSize=DATAROOT_HW[1])
    ds = AlignedDataset(opt)
    scenes = [ds[i] for i in range(n)]
    boxes = [bboxes_from_instance_map(s["inst"], min_size=16)[0]["bbox"] for s in scenes]
    return ({k: np.stack([s[k] for s in scenes]) for k in ("image", "label", "inst")},
            np.asarray(boxes, np.float32))


def phase_two_step_pipeline(tmp, dev, results):
    """Phase 17: TwoStepPipeline on the full-width stages restored from
    phases 14 and 6, over phase 5's scenes, bs 1 and 4, add / remove /
    swap: ms per edit, edits/s, peak memory; the outside-box passthrough;
    the kernel path against the plain path; the same bits twice (cuDNN
    deterministic)."""
    b2m = create_model(BoxToMaskTestOptions(gpu_ids=GPU_IDS, name="smoke_b2m",
                                            checkpoints_dir=os.path.join(tmp, "ckpt_b2m"),
                                            **{**B2M_DEPTH, **B2M_ARCH}))
    m2i = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, name="smoke_train",
                                              checkpoints_dir=os.path.join(tmp, "ckpt"), **ARCH))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        if not (restore_params(b2m.opt, b2m) and restore_params(m2i.opt, m2i)):
            raise AssertionError("two-step stages: a checkpoint is missing")
    if "partial load" in out.getvalue():
        raise AssertionError(f"two-step stages: {out.getvalue()!r}")
    pipe = TwoStepPipeline(b2m, m2i)
    host, host_boxes = load_scenes(os.path.join(tmp, "city"), 4)
    rows, ties = [], []
    for bs, iters in TWO_STEP_BS:
        image, label, inst = (torch.from_numpy(host[k][:bs]).to(dev)
                              for k in ("image", "label", "inst"))
        old = torch.from_numpy(host_boxes[:bs]).to(dev)
        new = old.clone()
        new[:, 1] += 50.0
        cls = torch.full((bs,), 26, dtype=torch.int32, device=dev)
        edits = {"add": (lambda: pipe.add_object(image, label, inst, old, cls), [old]),
                 "remove": (lambda: pipe.remove_object(image, label, inst, old), [old]),
                 "swap": (lambda: pipe.swap_object(image, label, inst, old, new, cls),
                          [old, new])}
        for mode, (run, box_list) in edits.items():
            passes = len(box_list)
            zero_launches()
            with recording() as calls:
                got = run()
                torch.cuda.synchronize()
            expect_path_launches(calls, read_launches(),
                                 (stage_sites(b2m, bs) + stage_sites(m2i, bs)) * passes,
                                 [((bs, pipe.m2i_size, pipe.m2i_size), 3)] * passes,
                                 (forward_pads(b2m) + forward_pads(m2i)) * passes,
                                 f"two-step {mode} bs {bs}")
            with cudnn_deterministic():
                first, again = run(), run()
            torch.cuda.synchronize()
            if not all(same_bits(v.float(), again[k].float()) for k, v in first.items()):
                raise AssertionError(f"two-step {mode} bs {bs}: two runs differ")
            passthrough = outside_passthrough(got, image, label, inst, box_list)
            if passthrough != 0.0:
                raise AssertionError(f"two-step {mode} bs {bs}: outside the box {passthrough}")
            fills, spy = edit_fills(pipe)
            with plain_path(), spy:
                ref = run()
            near = near_tie_masks(pipe, fills, box_list, tuple(label.shape[1:3]))
            count, flipped, err = compare_edit(got, ref, near, f"two-step {mode} bs {bs}")
            ties.append(dict(mode=mode, bs=bs, near_tie_pixels=count, flipped_pixels=flipped))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = host_ms(run, iters)
            peak = torch.cuda.max_memory_allocated()
            with plain_path():
                plain = host_ms(run, max(1, iters // 2))
            row = dict(mode=mode, bs=bs, passes=passes, ms_per_edit_batch=ms,
                       ms_per_edit=ms / bs, edits_per_s=bs * 1e3 / ms, plain_ms_per_edit_batch=plain,
                       peak_mem_bytes=peak, max_abs_diff_vs_plain=err, near_tie_pixels=count,
                       flipped_pixels=flipped, outside_box_max_abs=passthrough,
                       windows=[[float(v) for v in w] for w in got["windows"].tolist()])
            rows.append(row)
            log(f"[two-step pipeline] {row}")
    del pipe, b2m, m2i
    torch.cuda.empty_cache()
    results["two_step_pipeline"] = dict(rows=rows, near_ties=ties,
                                        precision="highest (fp32, TF32 off)")


def vgg_feature_params(path, seed=0):
    """VGG19 weights in the layout the evaluators read
    (``params/conv{b}_{c}/{kernel,bias}``, HWIO kernels), drawn at He scale
    from a seed, so that relu5_1 stays O(1) through the 13 convolutions it
    runs (the seeded init's N(0, 0.02) leaves it near zero and the FID of
    near-zero features at the eps floor)."""
    rng = np.random.RandomState(seed)
    flat, cin = {}, 3
    for b, widths in enumerate(networks.Vgg19Features.CFG):
        for c, width in enumerate(widths):
            flat[f"params/conv{b + 1}_{c + 1}/kernel"] = (
                rng.randn(3, 3, cin, width) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
            flat[f"params/conv{b + 1}_{c + 1}/bias"] = np.zeros(width, np.float32)
            cin = width
    np.savez(path, **flat)
    return path


def phase_evaluate_cli(tmp, results):
    """Phase 18, main path 7: the port's evaluate CLI on the card, both
    stages, from phases 14's and 6's checkpoints over phase 5's scenes, 4
    samples each (mask2image with seeded VGG weights through
    --feature_params): box2mask 19 IN forwards a crop, mask2image 27 and
    one encode a window; finite values, a positive FID; the JSON line each
    prints."""
    total = {"launches": {}, "variants": {}}
    rows = []
    orig_create = evaluate.create_model
    vgg = vgg_feature_params(os.path.join(tmp, "vgg_features.npz"))
    for stage, name, ckpt, extra in (
            ("box2mask", "smoke_b2m", "ckpt_b2m", flags({**B2M_DEPTH, **B2M_ARCH})),
            ("mask2image", "smoke_train", "ckpt", ["--feature_params", vgg, *ARCH_ARGV])):
        models = []

        def create_and_keep(opt):
            models.append(orig_create(opt))
            return models[-1]

        out = io.StringIO()
        zero_launches()
        t = time.time()
        with recording() as calls, contextlib.redirect_stdout(out), \
                mock.patch.object(evaluate, "create_model", create_and_keep):
            res = evaluate.main(["--stage", stage, "--name", name, "--dataroot",
                                 os.path.join(tmp, "city"), "--checkpoints_dir",
                                 os.path.join(tmp, ckpt), "--gpu_ids", GPU_IDS, "--how_many", "4",
                                 *extra])
        torch.cuda.synchronize()
        wall = time.time() - t
        text = out.getvalue()
        log(text.rstrip())
        (model,) = models
        n = res["samples"]
        if "restored checkpoint 'latest'" not in text or "partial load" in text or n != 4:
            raise AssertionError(f"evaluate {stage}: {text!r}")
        values = [v for k, v in res.items() if k not in ("metric", "samples")]
        if not all(np.isfinite(v) for v in values) or (stage == "mask2image" and res["value"] <= 0):
            raise AssertionError(f"evaluate {stage}: {res}")
        encodes = [] if stage == "box2mask" else [((1, model.opt.fineSize, model.opt.fineSize), 3)] * n
        variants = expect_path_launches(calls, read_launches(), stage_sites(model) * n, encodes,
                                        forward_pads(model) * n, f"evaluate {stage}")
        launches = read_launches()
        add_paths(total, launches, variants)
        row = dict(stage=stage, result=res, wall_s=wall, samples=n, launches=launches,
                   in_variants=variants["instance_norm"],
                   json_line=next(l for l in text.splitlines() if l.startswith("{")))
        rows.append(row)
        log(f"[evaluate] {row}")
        del models, model
        torch.cuda.empty_cache()
    results["evaluate_cli"] = dict(runs=rows, **total)
    return total["launches"], total["variants"]


# ---------------------------------------------------------------- 1024p, instance features

def image_encodes(calls):
    """The recorded encode calls that carry the masked image."""
    return [c for c in calls["encode"] if len(c) == 2]


def expect_recorded(calls, per_step, opt, what):
    """One step's recorded calls against the architecture's per-step count."""
    got = {k: len(calls[k]) for k in PLANNED + ("mse_to_scalar", "l1_to_scalar",
                                               "loss_group_bwd", "encode_cond")}
    got["encode"] = len(image_encodes(calls))
    expect_launches(got, {k: per_step[k] for k in got}, f"{what}, calls recorded")
    expect_launches(len(calls["loss_group"]), sum(loss_groups_per_step(opt).values()),
                    f"{what}, loss groups recorded")


def phase_local_kernels(dev, results):
    """Phase 19: rows 1, 2 and 4-7 at the 1024p shapes. The calls one
    full-width LocalEnhancer train step at 1024x512 makes of each kernel,
    recorded at bs 1 and 2, fp32 and bf16, each held to the architecture's
    count; each distinct call against its plain version on the variant its
    plan picks, the same bits twice; the bs-1 fp32 step's calls timed
    beside the bound and the library call (row 2, the pad-0 encode, at
    (1, 512, 1024) among them)."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, **LOCAL_G, **LOCAL_D)
    model = create_model(opt)
    per_step = per_step_of(model)
    recorded = {(bs, dt): step_calls_of(model, encode_inputs(bs, *HW_1024, dev, seed=80 + bs),
                                        dt)
                for bs in (1, 2) for dt in (torch.float32, torch.bfloat16)}
    del model
    torch.cuda.empty_cache()
    for (bs, dt), calls in recorded.items():
        expect_recorded(calls, per_step, opt, f"1024p step bs {bs} {dt}")
    errs, counts = check_recorded(recorded, dev, 85, "1024p")
    log(f"[1024p kernels] per step {per_step}; distinct calls checked {counts}; "
        f"max|kernel - plain| {errs}")
    calls = dict(recorded[(1, torch.float32)], encode=image_encodes(recorded[(1, torch.float32)]))
    table = []
    for i, name in enumerate(("encode", "encode_cond") + PLANNED):
        table.append(dict(name=name, **time_sites(name, calls[name], dev, seed=86 + i)))
    for i, name in enumerate(("mse_to_scalar", "l1_to_scalar")):
        table.append(dict(name=name, **time_loss_groups(name, calls["loss_group"], dev, 92 + i)))
    for row in table:
        log(f"[1024p step {HW_1024[1]}x{HW_1024[0]} bs 1 fp32] {row}")
    results["local_kernels"] = dict(per_step=per_step, max_err=errs, distinct_calls=counts,
                                    step_table=table)
    return table


def pretrain_counts(g, opt, pre_num_D):
    """load_pretrain's (loaded, kept at init) for a GlobalGenerator run of
    pre_num_D scales into this LocalEnhancer and D: the trunk's kernels and
    biases and the head's bias (its kernel is narrower), D's shared scales;
    the branches, the head's kernel and the new scales kept."""
    t, n = getattr(g, "global"), g.n_local_enhancers
    trunk = 2 * (1 + 2 * t.n_downsampling + 2 * t.n_blocks)
    branches = 2 * n * (3 + 2 * g.n_blocks_local)
    scale = 2 * (opt.n_layers_D + 2)
    shared = min(pre_num_D, opt.num_D)
    return trunk + 1 + shared * scale, branches + 1 + (opt.num_D - shared) * scale


def serve_cli(tmp, name, ckpt, root, extra, results_dir, how_many=4):
    """The serving CLI from a run's latest, counters zeroed before and read
    after -> (stdout, launches, recorded calls, wall s)."""
    out = io.StringIO()
    zero_launches()
    t = time.time()
    with recording() as calls, contextlib.redirect_stdout(out):
        mask2image_test.main(["--name", name, "--dataroot", root, "--checkpoints_dir", ckpt,
                              "--gpu_ids", GPU_IDS, "--results_dir", results_dir,
                              "--how_many", str(how_many), *extra])
    torch.cuda.synchronize()
    wall = time.time() - t
    text = out.getvalue()
    log(text.rstrip())
    if "restored checkpoint 'latest'" not in text or "partial load" in text:
        raise AssertionError(f"{name}: the serving CLI did not restore latest in full")
    if f"wrote {how_many} results" not in text:
        raise AssertionError(f"{name}: the serving CLI wrote no {how_many} results")
    with open(os.path.join(results_dir, name, "test_latest", "index.html")) as f:
        if f.read().count("synthesized_image") < how_many:
            raise AssertionError(f"{name}: gallery incomplete")
    return text, read_launches(), calls, wall


def phase_local_cli(tmp, dev, results):
    """Phase 20, main path 8: the train CLI with the 1024p recipe's flags
    (LocalEnhancer, 3-scale D) and --load_pretrain from phase 6's run,
    --niter_fix_global 1, two epochs at bs 1 over phase 6's scenes: counters
    zeroed before and read after, held per step to the architecture's
    counts and per variant to the plans; load_pretrain's counts; every
    trunk parameter bit-for-bit the pretrained one after each step of epoch
    1, and moved by the first step of epoch 2; every loss finite. Then the
    serving CLI from its latest over phase 5's scenes. Each distinct call
    both runs made of a kernel, against its plain version (check_recorded)."""
    ckpt = os.path.join(tmp, "ckpt")
    pre_dir = os.path.join(ckpt, "smoke_train")
    with np.load(os.path.join(pre_dir, "ckpt", "latest_params.npz")) as data:
        pre = params_from_jax({k: data[k] for k in data.files})
        pre_num_D = len({k.split("/")[2] for k in data.files if k.startswith("D/params/scale")})
    argv = ["--name", "smoke_1024p", "--dataroot", os.path.join(tmp, "city_train"),
            "--checkpoints_dir", ckpt, "--gpu_ids", GPU_IDS, *flags(LOCAL_G), *flags(LOCAL_D),
            *LOCAL_ARGV, "--load_pretrain", pre_dir,
            "--niter_fix_global", "1", "--niter", "2", "--niter_decay", "0",
            "--print_freq", "1", "--save_epoch_freq", "100", "--nThreads", "2"]
    frozen, counts = [], []
    orig_make, orig_load = train_loop.make_step_fn, train_loop.load_pretrain_into

    def make_checked(opt, model, mesh=None):
        step = orig_make(opt, model, mesh)
        trunk = {n: p for n, p in model.netG.named_parameters() if n.startswith("global.")}
        want = {n: pre[n[len("global."):]].to(p.device) for n, p in trunk.items()}

        def checked(state, batch):
            out = step(state, batch)
            frozen.append(all(torch.equal(p, want[n]) for n, p in trunk.items()))
            return out

        return checked

    def load_counted(*a, **k):
        counts.append(orig_load(*a, **k))
        return counts[-1]

    with recording() as calls, mock.patch.object(train_loop, "make_step_fn", make_checked), \
            mock.patch.object(train_loop, "load_pretrain_into", load_counted):
        state, model, errors, wall, launches, per_step = drive_train_cli(argv)
    steps = state.step
    variants = read_variants()
    spe = steps // 2
    log(f"[1024p train CLI] {steps} steps in {wall:.1f} s (incl. model init, pretrain load, "
        f"data, checkpoint write); launches {launches}; per step {per_step}; "
        f"load_pretrain {counts}; trunk frozen after each step {frozen}")
    if steps < 2 or steps % 2 or len(errors) != steps or len(frozen) != steps:
        raise AssertionError(f"1024p train CLI: {steps} steps, {len(errors)} loss lines")
    want_counts = pretrain_counts(model.netG, model.opt, pre_num_D)
    if counts != [want_counts]:
        raise AssertionError(f"load_pretrain counts {counts}, reckoned {want_counts}")
    if not all(frozen[:spe]) or any(frozen[spe:]):
        raise AssertionError(f"--niter_fix_global 1 over {spe} steps an epoch: {frozen}")
    for k, n in per_step.items():
        expect_launches(launches[k], n * steps, f"1024p train CLI {k}")
    expect_groups({}, loss_groups_per_step(model.opt), steps, "1024p train CLI")
    variants = expect_variants(calls, "1024p train CLI")
    log(f"[1024p train CLI] losses, first step {errors[0]}, last step {errors[-1]}; "
        f"variants {variants}")
    g_sites, g_pads = generator_counts(model.netG)[0], forward_pads(model)
    del model, pre
    torch.cuda.empty_cache()

    how_many = 4
    text, slaunches, scalls, swall = serve_cli(
        tmp, "smoke_1024p", ckpt, os.path.join(tmp, "city"), flags(LOCAL_G),
        os.path.join(tmp, "results_1024p"), how_many)
    expect_launches(slaunches, dict({k: 0 for k in slaunches}, encode=how_many,
                                    instance_norm=g_sites * how_many,
                                    reflect_pad_fwd=g_pads * how_many), "1024p serving CLI")
    svariants = expect_variants(scalls, "1024p serving CLI")
    if svariants["encode"] != {"pad0": how_many, "pad3": 0}:
        raise AssertionError(f"1024p serving CLI: encode variants {svariants['encode']}")
    log(f"[1024p test CLI] {swall:.1f} s; launches {slaunches}; variants {svariants}")
    errs, checked = check_recorded({"train": calls, "serving": scalls}, dev, 97, "1024p CLIs")
    log(f"[1024p CLIs] distinct calls checked {checked}; max|kernel - plain| {errs}")
    results["local_cli"] = dict(
        train=dict(wall_s=wall, steps=steps, launches=launches, per_step=per_step,
                   losses=errors, load_pretrain=list(counts[0]), pre_num_D=pre_num_D,
                   trunk_frozen=frozen, variants=variants),
        serving=dict(wall_s=swall, windows=how_many, launches=slaunches, variants=svariants),
        kernel_vs_plain=dict(max_err=errs, distinct_calls=checked))
    return launches, variants, slaunches, svariants


def phase_local_step(dev, results):
    """Phase 21: make_train_step on the LocalEnhancer at 1024x512, bs 1 in
    fp32 and bs 4 in the bf16 tier (the step of tools/bench_1024p.py): ms,
    images/s, peak memory, per-step launches per kernel and variant, the
    plain path's ms; the fp32 step's kernel path against its plain path
    (compare_step); inference at 1024x512 fp32, bs 1 and 4: ms/image and the
    kernel path against the plain path."""
    rows, cmp = [], None
    for bs, dtype, iters in LOCAL_STEP_BS:
        opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype=dtype, **LOCAL_G, **LOCAL_D)
        model = create_model(opt)
        cdt = torch.bfloat16 if dtype == "bfloat16" else None
        step = make_train_step(model, cdt)
        per_step = per_step_of(model)
        batch = encode_inputs(bs, *HW_1024, dev, seed=90 + bs)
        state = make_optimizers(opt, model, 1000)
        with recording() as calls:
            step(state, batch)
        per_variant = {k: plan_variants(k, calls[k], calls["loss_group"])
                       for k in PLANNED + ("encode", "mse_to_scalar", "l1_to_scalar")}
        ms, peak, plain, losses, fake = time_train_step(
            step, state, batch, iters, per_step, f"1024p step {dtype} bs {bs}", per_variant)
        row = dict(bs=bs, hw=list(HW_1024), dtype=dtype,
                   precision=model.conv_precision_resolved, ms_per_step=ms,
                   images_per_s=bs * 1e3 / ms, ms_per_image=ms / bs, plain_ms_per_step=plain,
                   peak_mem_bytes=peak, fake_dtype=str(fake.dtype), losses=losses,
                   launches_per_step=per_step, variants_per_step=per_variant)
        rows.append(row)
        log(f"[1024p step] {row}")
        if dtype == "float32":
            cmp = compare_step(model, encode_inputs(1, *HW_1024, dev, seed=95))
        del model, state
        torch.cuda.empty_cache()
    model = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, **LOCAL_G))
    infer = []
    for bs, iters in LOCAL_INFER_BS:
        batch = encode_inputs(bs, *HW_1024, dev, seed=96)
        out = model.inference(batch)
        with plain_path():
            ref = model.inference(batch)
        torch.cuda.synchronize()
        diff = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or diff > MODEL_ATOL:
            raise AssertionError(f"1024p inference bs {bs}: kernel vs plain max|diff| {diff}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.inference(batch), iters)
        with plain_path():
            plain = cuda_ms(lambda: model.inference(batch), iters)
        row = dict(bs=bs, hw=list(HW_1024), dtype="float32", ms_per_batch=ms,
                   ms_per_image=ms / bs, images_per_s=bs * 1e3 / ms, plain_ms_per_batch=plain,
                   max_abs_diff_vs_plain=diff, peak_mem_bytes=torch.cuda.max_memory_allocated())
        infer.append(row)
        log(f"[1024p inference] {row}")
    del model
    torch.cuda.empty_cache()
    results["local_step"] = dict(rows=rows, kernel_vs_plain=cmp, inference=infer)


def segment_mean_check(dev, seed):
    """nnops.segment_mean_2d on the card over a scene's instance map at
    DATAROOT_HW (the Encoder's remap, its 3 feature channels), fp32 and
    bf16: the forward and its gradient twice, the same bits both times;
    against the fp64 segment mean the fp32 forward and gradient and the
    bf16 forward (one rounding). The bf16 gradient is not: its gather's
    backward sums in bf16, as the JAX package's does -> max |diff| by
    dtype."""
    inp = encode_inputs(1, *DATAROOT_HW, dev, seed=seed)
    slots, nc = 64, 35
    ids = inp["inst"].to(torch.int64)
    seg = torch.clamp((ids // 1000) * slots + (ids % 1000) % slots, 0, nc * slots - 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.rand((1, *DATAROOT_HW, 3), generator=gen, device=dev) * 2 - 1
    gy = torch.randn((1, *DATAROOT_HW, 3), generator=gen, device=dev)
    flat = seg.reshape(-1)
    counts = torch.bincount(flat, minlength=nc * slots).double().clamp_min(1.0)[:, None]

    def mean64(v):
        sums = torch.zeros((nc * slots, 3), dtype=torch.float64, device=dev)
        return (sums.index_add_(0, flat, v.double().reshape(-1, 3)) / counts)[flat]

    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = feat.to(dt)

        def run():
            xg = x.clone().requires_grad_(True)
            out = nnops.segment_mean_2d(xg, seg, nc * slots)
            out.backward(gy.to(dt))
            return out.detach(), xg.grad

        (out, grad), (out2, grad2) = run(), run()
        torch.cuda.synchronize()
        if not (same_bits(out, out2) and same_bits(grad, grad2)):
            raise AssertionError(f"segment_mean_2d {dt}: two runs differ")
        err = 0.0
        checked = ((out, x), (grad, gy)) if dt == torch.float32 else ((out, x),)
        for got, v in checked:
            want = mean64(v).reshape(got.shape)
            diff = (got.double() - want).abs()
            tol = SEG_FP32_ATOL + (2.0**-8 * want.abs() if dt == torch.bfloat16 else 0.0)
            if not bool((diff <= tol).all()):
                raise AssertionError(f"segment_mean_2d {dt}: max|diff| {diff.max().item()}")
            err = max(err, diff.max().item())
        errs[str(dt)[6:]] = err
    return errs


def phase_feat_step(dev, results):
    """Phase 23: the instance-feature model at full width (the GlobalGenerator
    flagship, the Encoder at nef 16, 4 downs, feat_num 3): one bs-1 step at
    the train CLI's windows, kernel path against plain path (compare_step,
    E's gradients among the leaves: they reach it through the stem's
    42-channel pad); segment_mean_2d's forward and gradient on the card,
    the same bits twice and against the fp64 mean."""
    model = create_model(MaskToImageTrainOptions(gpu_ids=GPU_IDS, **FEAT, **ARCH))
    cmp = compare_step(model, encode_inputs(1, *FEAT_STEP_HW, dev, seed=99))
    if not cmp["leaves_by_net"].get("E"):
        raise AssertionError(f"features step: no gradient reached E {cmp['leaves_by_net']}")
    del model
    torch.cuda.empty_cache()
    seg = segment_mean_check(dev, 100)
    log(f"[features step] leaves with a gradient {cmp['leaves_by_net']}; segment_mean_2d "
        f"max|diff| vs fp64 {seg}, same bits twice")
    results["feat_step"] = dict(kernel_vs_plain=cmp, segment_mean_max_diff=seg)


def drive_tool(fn, argv, what):
    """One run of a feature tool with the counters zeroed just before and
    read just after -> (its return value, launches, recorded calls)."""
    zero_launches()
    with recording() as calls:
        out = fn(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[{what}] launches {launches}")
    return out, launches, calls


def phase_feat_cli(tmp, dev, results):
    """Phase 22, main path 9: the instance features at full width. The train
    CLI with --instance_feat (the GlobalGenerator of phase 6, the Encoder at
    nef 16, 4 downs, feat_num 3), one epoch at bs 1 over phase 6's scenes,
    held per step to the counts with the Encoder's 9 + 9 IN sites; the port's
    encode_features over the same scenes to a (35, 10, 3) clusters npy; the
    serving CLI with --cluster_path over phase 5's scenes (4 windows, no
    partial load); precompute_feature_maps, then one epoch of
    --load_features over the aligned scenes. Counters zeroed before and read
    after each run. Each distinct call the runs made of a kernel (the
    Encoder's IN sites at 16-256 channels, the 42-channel stem's pad on the
    gather variant among them), against its plain version (check_recorded)."""
    ckpt = os.path.join(tmp, "ckpt_feat")
    root = os.path.join(tmp, "city_train")
    common = ["--dataroot", root, "--checkpoints_dir", ckpt, "--gpu_ids", GPU_IDS, *FEAT_ARGV,
              *ARCH_ARGV]
    run = ["--niter", "1", "--niter_decay", "0", "--print_freq", "1", "--save_epoch_freq",
           "100", "--nThreads", "2"]
    paths, recorded = {}, {}

    def train(name, *extra):
        with recording() as calls:
            state, model, errors, wall, launches, per_step = drive_train_cli(
                ["--name", name, *common, *run, *extra])
        steps = state.step
        if steps < 1 or len(errors) != steps:
            raise AssertionError(f"{name}: {steps} steps, {len(errors)} loss lines")
        for k, n in per_step.items():
            expect_launches(launches[k], n * steps, f"{name} train CLI {k}")
        expect_groups({}, loss_groups_per_step(model.opt), steps, f"{name} train CLI")
        variants = expect_variants(calls, f"{name} train CLI")
        log(f"[{name} train CLI] {steps} steps in {wall:.1f} s; per step {per_step}; "
            f"losses, first step {errors[0]}, last {errors[-1]}; variants {variants}")
        row = dict(wall_s=wall, steps=steps, launches=launches, per_step=per_step,
                   losses=errors, variants=variants)
        recorded[name] = calls
        sites = (generator_counts(model.netG)[0], 1 + 2 * model.netE.n_downsampling,
                 forward_pads(model, encoder=False))
        del model
        torch.cuda.empty_cache()
        return row, sites

    row, (g_sites, e_sites, g_pads) = train("smoke_feat")
    paths["train_instance_feat"] = row
    npy = os.path.join(tmp, "features_clustered_010.npy")
    clusters, launches, calls = drive_tool(
        encode_features.main, ["--name", "smoke_feat", *common, "--out", npy], "encode_features")
    if clusters.shape != (35, 10, 3) or not np.isfinite(clusters).all() \
            or not np.abs(clusters[[24, 26, 33]]).max() > 0:
        raise AssertionError(f"clusters {clusters.shape} not finite or empty")
    # the Encoder a window: its IN sites, and its stem's and head's pads
    windows = launches["instance_norm"] // e_sites
    if windows == 0 or launches != dict({k: 0 for k in launches}, instance_norm=e_sites * windows,
                                        reflect_pad_fwd=2 * windows):
        raise AssertionError(f"encode_features: launches {launches}, {e_sites} IN and 2 pads "
                             "a window")
    recorded["encode_features"] = calls
    paths["encode_features"] = dict(launches=launches,
                                    variants=expect_variants(calls, "encode_features"))
    how_many = 4
    text, slaunches, scalls, swall = serve_cli(
        tmp, "smoke_feat", ckpt, os.path.join(tmp, "city"),
        [*FEAT_ARGV, *ARCH_ARGV, "--cluster_path", npy], os.path.join(tmp, "results_feat"),
        how_many)
    if "loaded feature clusters (35, 10, 3)" not in text:
        raise AssertionError("the serving CLI did not load the clusters")
    expect_launches(slaunches, dict({k: 0 for k in slaunches}, encode=how_many,
                                    instance_norm=g_sites * how_many,
                                    reflect_pad_fwd=g_pads * how_many), "clusters serving CLI")
    recorded["serving_clusters"] = scalls
    paths["serving_clusters"] = dict(wall_s=swall, launches=slaunches,
                                     variants=expect_variants(scalls, "clusters serving CLI"))
    feat_dir, launches, calls = drive_tool(
        precompute_feature_maps.main, ["--name", "smoke_feat", *common], "precompute")
    n_maps = len(os.listdir(feat_dir))
    expect_launches(launches, dict({k: 0 for k in launches}, instance_norm=e_sites * n_maps,
                                   reflect_pad_fwd=2 * n_maps), "precompute_feature_maps")
    fmap = np.load(os.path.join(feat_dir, sorted(os.listdir(feat_dir))[0]))
    if fmap.shape != (*DATAROOT_HW, 3) or not np.isfinite(fmap).all():
        raise AssertionError(f"feature map {fmap.shape} not finite")
    recorded["precompute_feature_maps"] = calls
    paths["precompute_feature_maps"] = dict(
        launches=launches, maps=n_maps, variants=expect_variants(calls, "precompute"))
    row, _ = train("smoke_loadf", "--load_features", "--no-use_bbox_dataset",
                   "--no-use_masked_image")
    paths["train_load_features"] = row
    stem = [c for c in recorded["smoke_feat"]["reflect_pad_bwd"] if c[0][3] == 42]
    if not stem or any(plan_variant("reflect_pad_bwd", c) != "gather" for c in stem):
        raise AssertionError(f"features train CLI: the stem's pad backward {stem}")
    errs, checked = check_recorded(recorded, dev, 98, "features")
    log(f"[features] distinct calls checked {checked}; max|kernel - plain| {errs}")
    results["feat_cli"] = dict(paths, kernel_vs_plain=dict(max_err=errs, distinct_calls=checked))
    return ({p: v["launches"] for p, v in paths.items()},
            {p: v["variants"] for p, v in paths.items()})


# ---------------------------------------------------------------- the data path (slice 10)

# the scale check: the Cityscapes train split at --loadSize 1024 as a uint8
# resident store (label u8, inst as int16 bits, RGB u8), SCALE_RECORDS
# context windows a scene
SCALE_SCENES = 2975
SCALE_HW = (512, 1024)
SCALE_RECORDS = 30
SCALE_WINDOW = 512           # the windows of the scale check's draw (fineSize)
MEASURE_BS = (1, 4)
MEASURE_SCENES = 40          # ~120 windows: 30 batches at bs 4
MEASURE_WARMUP = 4
MEASURE_STEPS = 16
MEASURE_OBJECTS = 30         # objects of the extract_bboxes timing's map
MEASURE_MAP_HW = (512, 1024)
DROPOUT_HW = STEP_HW         # the dropout step's compare_step shape

# data parallel, remat, --debug_nans and spatial sharding (phases 29-33)
REMAT_CASES = (((256, 512), 4, "float32"), ((512, 1024), 4, "bfloat16"))   # (hw, bs, dtype)
REMAT_ITERS = 3
DP_GPU_IDS = "0,0"           # two ranks on the one card (gloo: NCCL refuses a shared card)
DP_BS = 2                    # the global batch: 1 a rank
DP_ITERS = 3
SPATIAL_HW = (1024, 2048)    # the W-sharded forwards' images
SPATIAL_ITERS = 2
RANK_JOIN_S = 600


@contextlib.contextmanager
def snapshot_latest(at_step, dst_root):
    """Copy a run's directory to dst_root right after its train loop writes
    'latest' at train step at_step (a mid-epoch checkpoint to resume from)."""
    orig = CheckpointManager.save

    def save(self, label, model, state, epoch, epoch_iter):
        orig(self, label, model, state, epoch, epoch_iter)
        if label == "latest" and state.step == at_step:
            run = os.path.dirname(self.dir)
            shutil.copytree(run, os.path.join(dst_root, os.path.basename(run)))

    with mock.patch.object(CheckpointManager, "save", save):
        yield


def saved_params(ckpt, name):
    path = os.path.join(ckpt, name, "ckpt", "latest", "state.pt")
    return torch.load(path, map_location="cpu", weights_only=False)["params"]


def same_params(a, b, what):
    bad = [f"{net}.{k}" for net in a for k, t in a[net].items() if not same_bits(t, b[net][k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} parameters differ, first {bad[:3]}")


def run_cli_checked(argv, cli, what, done=0, ref=None):
    """One train CLI run, counters zeroed before and read after, held per
    step to the architecture's launches (a loss line every --print_freq
    steps), per variant to the plans and, with
    ``ref`` = (variants, steps) of a streamed run of the same windows, to
    its launches per variant a step -> a dict of the run."""
    with recording() as calls:
        state, model, errors, wall, launches, per_step = drive_train_cli(argv, cli)
    steps = state.step - done
    every = int(argv[argv.index("--print_freq") + 1]) if "--print_freq" in argv else 1
    if steps < 1 or len(errors) != state.step // every - done // every:
        raise AssertionError(f"{what}: {steps} steps, {len(errors)} loss lines")
    for k, n in per_step.items():
        expect_launches(launches[k], n * steps, f"{what} {k}")
    expect_groups({}, loss_groups_per_step(model.opt), steps, what)
    variants = expect_variants(calls, what)
    if ref is not None:
        ref_variants, ref_steps = ref
        for kind, counts in variants.items():
            expect_launches({v: n * ref_steps for v, n in counts.items()},
                            {v: n * steps for v, n in ref_variants[kind].items()},
                            f"{what}, {kind} variants a step against the streamed path")
    log(f"[{what}] {steps} steps in {wall:.1f} s; launches {launches}; losses first "
        f"{errors[0]}, last {errors[-1]}")
    run = dict(steps=steps, wall_s=wall, launches=launches, variants=variants,
               per_step=per_step, losses=errors, state_step=state.step)
    del model
    torch.cuda.empty_cache()
    return run


def resident_resume(argv, cli, name, tmp, what, ref):
    """A device-resident run of one epoch with cuDNN's deterministic
    algorithms (TF32 is off in the fp32 tier), its mid-epoch 'latest'
    copied aside; then --continue_train from that copy: its losses and its
    final parameters bit for bit the straight run's."""
    ckpt = argv[argv.index("--checkpoints_dir") + 1]
    mid_root = os.path.join(tmp, f"{name}_mid")
    fused = []
    orig_make = train_loop.make_resident_train_step

    def make_fused(*a, **k):
        fused.append(1)
        return orig_make(*a, **k)

    with cudnn_deterministic(), mock.patch.object(train_loop, "make_resident_train_step",
                                                  make_fused):
        n = drive_steps_of(argv, cli)
        at = n // 2
        with snapshot_latest(at, mid_root):
            straight = run_cli_checked(argv + ["--save_latest_freq", str(at)], cli, what,
                                       ref=ref)
        resumed = run_cli_checked(
            [a if a != ckpt else mid_root for a in argv] + ["--continue_train"], cli,
            f"{what} resumed at step {at}", done=at, ref=ref)
    if len(fused) != 2:
        raise AssertionError(f"{what}: the fused resident step was not taken ({fused})")
    if resumed["losses"] != straight["losses"][at:]:
        raise AssertionError(f"{what}: resumed losses {resumed['losses'][:2]} vs straight "
                             f"{straight['losses'][at:at + 2]}")
    same_params(saved_params(ckpt, name), saved_params(mid_root, name), f"{what} resumed")
    log(f"[{what}] resumed from the step-{at} latest: {resumed['steps']} losses and every "
        "parameter bit for bit the straight run's")
    shutil.rmtree(mid_root)
    return straight, resumed, at


def drive_steps_of(argv, cli):
    """Steps an epoch of a train CLI's loader (its records over the batch)."""
    opt_cls = BoxToMaskTrainOptions if cli is box2mask_train else MaskToImageTrainOptions
    opt = parse_cli(opt_cls, argv)
    opt.device_resident_data = False
    return len(CreateDataLoader(opt))


def phase_resident_cli(tmp, results, ref):
    """Main path 10: the mask2image train CLI with --device_resident_data at
    full width over phase 6's scenes: under --uint8_transfer (the uint16
    instance store on the card) with a mid-epoch resume, then in the bf16
    tier with the HTML visuals of the fused step's batch; the latest weights
    served."""
    ckpt = os.path.join(tmp, "ckpt_res")
    base = ["--dataroot", os.path.join(tmp, "city_train"), "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--save_epoch_freq", "100", "--nThreads", "2", "--device_resident_data",
            *ARCH_ARGV]
    u8, resumed, at = resident_resume(base + ["--name", "res_u8", "--uint8_transfer"],
                                      mask2image_train, "res_u8", tmp, "resident train CLI u8",
                                      ref)
    bf16 = run_cli_checked(base + ["--name", "res_bf16", "--dtype", "bfloat16",
                                   "--display_freq", "4"], mask2image_train,
                           "resident train CLI bf16")
    with open(os.path.join(ckpt, "res_bf16", "web", "index.html")) as f:
        html = f.read()
    if "epoch [1]" not in html or "real_image" not in html:
        raise AssertionError("resident bf16 run: web/index.html lacks the batch's visuals")
    opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, name="res_u8", checkpoints_dir=ckpt, **ARCH)
    serve = create_model(opt)
    if not restore_params(opt, serve):
        raise AssertionError("resident run: latest_params.npz not found")
    trained_g = saved_params(ckpt, "res_u8")["G"]
    for k, t in serve.netG.state_dict().items():
        if not same_bits(t.cpu(), trained_g[k]):
            raise AssertionError(f"served G differs from the resident run's at {k}")
    out = serve.inference(encode_inputs(1, 512, 512, serve.device, seed=9))
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("resident run's weights serve a non-finite output")
    log(f"[resident train CLI] latest served: output {tuple(out.shape)} finite")
    results["resident_cli"] = dict(u8=u8, u8_resumed=resumed, resumed_at=at, bf16=bf16)
    del serve
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    return {"train_resident_u8": u8, "train_resident_resume": resumed,
            "train_resident_bf16": bf16}


def phase_resident_b2m_cli(tmp, results, ref):
    """Main path 11: the box2mask train CLI with --device_resident_data
    (phase 14's flags; --bg_box_prob, whose background boxes the resident
    records do not hold, is refused with it) for one epoch with a mid-epoch
    resume; then the streamed box2mask CLI with --device_prefetch 2 against
    its synchronous run, bit for bit."""
    ckpt = os.path.join(tmp, "ckpt_res_b2m")
    base = ["--dataroot", os.path.join(tmp, "city_train"), "--checkpoints_dir", ckpt,
            "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--save_epoch_freq", "100", "--nThreads", "2", "--lambda_ctx_neg", "5.0",
            *flags(B2M_ARCH)]
    res, resumed, at = resident_resume(base + ["--name", "res_b2m", "--device_resident_data"],
                                       box2mask_train, "res_b2m", tmp,
                                       "resident box2mask train CLI", ref)
    runs = {}
    with cudnn_deterministic():
        for depth in ("0", "2"):
            runs[depth] = run_cli_checked(
                base + ["--name", f"pf{depth}", "--bg_box_prob", "0.25", "--device_prefetch",
                        depth], box2mask_train, f"box2mask train CLI --device_prefetch {depth}",
                ref=ref)
    if runs["2"]["losses"] != runs["0"]["losses"]:
        raise AssertionError("--device_prefetch 2 losses differ from the synchronous run's")
    same_params(saved_params(ckpt, "pf0"), saved_params(ckpt, "pf2"), "--device_prefetch 2")
    log("[box2mask prefetch] --device_prefetch 2: every loss and parameter bit for bit the "
        "synchronous run's")
    results["resident_b2m_cli"] = dict(resident=res, resumed=resumed, resumed_at=at,
                                       prefetch=runs["2"], synchronous=runs["0"])
    shutil.rmtree(ckpt)
    return {"box2mask_resident": res, "box2mask_resident_resume": resumed,
            "box2mask_prefetch": runs["2"]}


def phase_dropout(tmp, dev, results, ref):
    """Main path 12: the flagship train CLI with --use_dropout for two
    epochs, the 21st step traced under --profile_dir (the trace file found
    on disk), the dropout masks counted; then a full-width dropout step, the
    kernel path against the plain path with the same masks (compare_step),
    and the law of the masks the card draws (keep rate 0.5 within 5 sigma,
    kept values scaled by 2)."""
    ckpt = os.path.join(tmp, "ckpt_drop")
    prof = os.path.join(tmp, "profile_drop")
    argv = ["--name", "drop", "--dataroot", os.path.join(tmp, "city_train"),
            "--checkpoints_dir", ckpt, "--gpu_ids", GPU_IDS, "--niter", "2", "--niter_decay",
            "0", "--print_freq", "1", "--save_epoch_freq", "100", "--nThreads", "2",
            "--use_dropout", "--profile_dir", prof, *ARCH_ARGV]
    draws = []
    orig_keep = networks.dropout_keep_mask

    def keep_counted(*a, **k):
        draws.append(1)
        return orig_keep(*a, **k)

    with mock.patch.object(networks, "dropout_keep_mask", keep_counted):
        run = run_cli_checked(argv, mask2image_train, "dropout train CLI", ref=ref)
    n_blocks = MaskToImageTrainOptions(**ARCH).n_blocks_global
    if len(draws) != n_blocks * run["steps"]:
        raise AssertionError(f"dropout masks drawn {len(draws)}, expected {n_blocks} a step")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(traces) != 1 or run["steps"] <= train_loop.PROFILE_STEP:
        raise AssertionError(f"--profile_dir wrote {traces} over {run['steps']} steps")
    trace_bytes = os.path.getsize(os.path.join(prof, traces[0]))
    log(f"[dropout train CLI] {len(draws)} masks drawn; --profile_dir trace {traces[0]} "
        f"({trace_bytes} bytes)")
    shutil.rmtree(ckpt)

    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, use_dropout=True, **ARCH)
    model = create_model(opt)
    g = train_steps.seeded_generator(dev, opt.seed, train_steps._DROPOUT_TAG, 0)
    h, w = DROPOUT_HW
    n_down = model.netG.n_downsampling
    shape = (1, h >> n_down, w >> n_down, opt.ngf * 2 ** n_down)
    blocks = [m for m in model.netG.modules() if isinstance(m, networks.ResnetBlock)]
    masks = [networks.dropout_keep_mask(shape, dev, g) for _ in blocks]
    keep_all = torch.stack(masks)
    n = keep_all.numel()
    rate = keep_all.float().mean().item()
    scaled = networks.dropout(torch.ones(shape, device=dev), masks[0])
    values = set(torch.unique(scaled).tolist())
    sigma = 0.5 / math.sqrt(n)
    if abs(rate - 0.5) > 5 * sigma or values != {0.0, 2.0}:
        raise AssertionError(f"dropout masks: keep rate {rate} over {n} (5 sigma "
                             f"{5 * sigma}), values {values}")
    orig_losses = model.losses
    with mock.patch.object(model, "losses", lambda b, params=None, g_only=False:
                           orig_losses(b, params, g_only, rng=dict(zip(blocks, masks)))):
        cmp = compare_step(model, encode_inputs(1, h, w, dev, seed=14))
    log(f"[dropout step] keep rate {rate:.6f} over {n} draws; kept values x2; kernel vs "
        f"plain {cmp['whole_plain_path']} (1-ulp sensitivity "
        f"{cmp['one_ulp_sensitivity']})")
    results["dropout"] = dict(cli=run, masks_drawn=len(draws), trace_file=traces[0],
                              trace_bytes=trace_bytes, keep_rate=rate, draws=n,
                              kernel_vs_plain=cmp)
    del model
    torch.cuda.empty_cache()
    return {"train_dropout": run}


def phase_data_measure(tmp, dev, results):
    """The host data path against the resident one at phase 6's 512x512
    windows, bs 1 and 4, fp32 and bf16, by the port's
    ``tools/bench_loop.py`` at a short steady state (MEASURE_SCENES scenes
    made from the seed; per config MEASURE_WARMUP steps, then
    MEASURE_STEPS timed steps of each path, streamed, prefetched
    (--device_prefetch 2) and fused, all by ``measure_steps``): the
    loop's wait in next() a batch (nThreads 2),
    the epoch's first batch apart; the resident sampler's ms a batch; ms a
    step of each path; the bytes each step copies host to device
    (torch.profiler's Memcpy HtoD) and the device's idle share (1 - the
    kernels' device ms of one profiled step over the ms a step);
    extract_bboxes native against numpy at 1024x512 with 30 objects."""
    from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_loop

    root, ckpt = os.path.join(tmp, "city_measure"), os.path.join(tmp, "measure")
    bench_loop.write_dataroot(root, MEASURE_SCENES, seed=0)
    resident = bench_loop.resident_sampler(bench_loop.train_argv(root, ckpt, 1, "float32",
                                                                 GPU_IDS, ARCH_ARGV))
    rows = []
    for dtype in ("float32", "bfloat16"):
        for bs in MEASURE_BS:
            row = bench_loop.measure(bench_loop.train_argv(root, ckpt, bs, dtype, GPU_IDS,
                                                           ARCH_ARGV),
                                     resident, dev, tmp, MEASURE_WARMUP, MEASURE_STEPS, 1)
            if row["fused_h2d_bytes_per_step"]:
                raise AssertionError(f"the fused step copied from the host: {row}")
            rows.append(row)
            log(f"[data measure] {row}")
    del resident
    torch.cuda.empty_cache()
    from neurips18_hierchical_image_manipulation_tpu_torch.data import hostops, native

    if not native.available():
        raise AssertionError(f"the native data tier did not build: {native.build_error}")
    rng = np.random.RandomState(3)
    inst = rng.randint(0, 34, MEASURE_MAP_HW).astype(np.int32)
    for k in range(MEASURE_OBJECTS):
        y, x = rng.randint(0, MEASURE_MAP_HW[0] - 64), rng.randint(0, MEASURE_MAP_HW[1] - 96)
        inst[y:y + rng.randint(16, 64), x:x + rng.randint(16, 96)] = 24000 + 1000 * (k % 10) + k
    if native.extract_bboxes(inst) != hostops.extract_bboxes(inst):
        raise AssertionError("native extract_bboxes differs from numpy's")
    bbox_ms = {}
    for tier, fn in (("native", native.extract_bboxes), ("numpy", hostops.extract_bboxes)):
        fn(inst)
        t = time.perf_counter()
        for _ in range(10):
            fn(inst)
        bbox_ms[tier] = (time.perf_counter() - t) * 100
    log(f"[data measure] extract_bboxes at {MEASURE_MAP_HW[1]}x{MEASURE_MAP_HW[0]}, {MEASURE_OBJECTS} "
        f"objects: native {bbox_ms['native']:.3f} ms, numpy {bbox_ms['numpy']:.3f} ms")
    results["data_measure"] = dict(rows=rows, scenes=MEASURE_SCENES, warmup=MEASURE_WARMUP,
                                   steps=MEASURE_STEPS, extract_bboxes_ms=bbox_ms,
                                   tier=native.tier())


def phase_resident_scale(dev, results):
    """The Cityscapes train split as a uint8 resident store made on the
    card (2975 scenes at 1024x512, 30 context windows each): the memory
    guard's verdict, the store's bytes, and a bs-4 bbox draw at 512x512
    windows timed on it."""
    from neurips18_hierchical_image_manipulation_tpu_torch.data import device_resident as pdr

    n, (h, w) = SCALE_SCENES, SCALE_HW
    g = torch.Generator(dev).manual_seed(0)
    base = {"label": torch.randint(0, 35, (n, h, w), generator=g, device=dev,
                                   dtype=torch.uint8),
            "inst": torch.randint(-32768, 32767, (n, h, w), generator=g, device=dev,
                                  dtype=torch.int16),
            "image": torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev,
                                   dtype=torch.uint8)}
    m = n * SCALE_RECORDS
    side = torch.randint(h // 8, h, (m,), generator=g, device=dev).float()
    wy = (torch.rand(m, generator=g, device=dev) * (h - side)).floor()
    wx = (torch.rand(m, generator=g, device=dev) * (w - side)).floor()
    recs = {"window": torch.stack([wy, wx, side, side], 1),
            "box": torch.stack([side * 0, side * 0, side / 2, side / 2], 1),
            "image_index": torch.arange(m, device=dev, dtype=torch.int32) // SCALE_RECORDS,
            "cls": torch.full((m,), 26, device=dev, dtype=torch.int32),
            "inst_id": torch.full((m,), 26000, device=dev, dtype=torch.int32)}
    nbytes = sum(t.numel() * t.element_size() for t in (*base.values(), *recs.values()))
    free, total = torch.cuda.mem_get_info(dev)
    pdr._check_hbm_fit(nbytes, f"{n} scenes", dev)
    idx = torch.randint(0, m, (4,), generator=g, device=dev)
    s = SCALE_WINDOW
    ms = cuda_ms(lambda: pdr.bbox_batch_impl(base, recs, idx, s, True), 10)
    batch = pdr.bbox_batch_impl(base, recs, idx, s, True)
    torch.cuda.synchronize()
    if tuple(batch["image"].shape) != (4, s, s, 3) or batch["inst"].dtype != torch.uint16:
        raise AssertionError(f"scale draw: {batch['image'].shape} {batch['inst'].dtype}")
    log(f"[resident scale] {n} scenes at {w}x{h} + {m} windows: {nbytes / 1e9:.3f} GB on the "
        f"card ({nbytes / n / 1e6:.3f} MB a scene), fits the resident budget (free "
        f"{free / 1e9:.1f} of {total / 1e9:.1f} GB); bs-4 draw at {s}x{s} {ms:.3f} ms")
    results["resident_scale"] = dict(scenes=n, hw=[h, w], records=m, store_bytes=nbytes,
                                     free_bytes=free, total_bytes=total, fits=True,
                                     bs4_draw_ms=ms)
    del base, recs, batch
    torch.cuda.empty_cache()


SOURCES = {
    "encode_cond": ("csrc/encode.cu", "ops/pallas/encode.py:104"),
    "instance_norm_bwd": ("csrc/instance_norm.cu", "ops/pallas/instance_norm.py:195"),
    "mse_to_scalar": ("csrc/losses.cu", "ops/pallas/losses.py:39"),
    "l1_to_scalar": ("csrc/losses.cu", "ops/pallas/losses.py:39"),
    "reflect_pad_bwd": ("csrc/reflect_pad.cu", "ops/pallas/reflect_pad.py:82"),
    "reflect_pad_fwd": ("csrc/reflect_pad.cu", None),   # no TPU kernel: jnp.pad
}


def phase_train_main_path_kernels(dev, cli_launches, cli_calls, cli_variants, step_calls,
                                  results):
    """JSON rows of the training kernels, each timed on the calls one step
    of the train CLI made of it (its bbox windows, bs 1, fp32), and the
    per-step table at STEP_HW bs 1 for PERF.md."""
    rows, table = [], []

    def timed(name, calls, seed):
        if name in ("mse_to_scalar", "l1_to_scalar"):
            return time_loss_groups(name, calls["loss_group"], dev, seed)
        return time_sites(name, calls[name], dev, seed)

    for i, name in enumerate(TRAIN_KERNELS):
        src, tpu = SOURCES[name]
        row = dict(name=name, route="cuda", source=f"{PKG}/{src}",
                   replaces=f"{JAX_PKG}/{tpu}" if tpu else "none (jnp.pad, fused by XLA)",
                   launches=cli_launches[name],
                   **timed(name, cli_calls, 20 + i))
        row["per"] = (f"the {row['launches_per_step']} calls one train-CLI step makes "
                      f"(bbox windows, bs 1, fp32)")
        if "terms_per_step" in row:
            # the loss kernel: launches are the groups, its .launches the terms
            row["launches"], row["terms"] = cli_variants[name]["group"], cli_launches[name]
            row["per"] = (f"the {row['terms_per_step']} terms in {row['launches_per_step']} "
                          "launches one train-CLI step makes (bbox windows, bs 1, fp32)")
        row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
        rows.append(row)
        log(f"[main-path kernel] {row}")
        trow = dict(name=name, **timed(name, step_calls, 40 + i))
        table.append(trow)
        log(f"[step {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    # the IN forward over the sites of the same step (library_ms: IN alone)
    trow = dict(name="instance_norm", **time_sites("instance_norm", step_calls["instance_norm"],
                                                    dev, seed=50))
    table.append(trow)
    log(f"[step {STEP_HW[1]}x{STEP_HW[0]} bs 1] {trow}")
    results["train_step_kernels"] = table
    return rows


def phase_profile_train(dev, results, bf16=False, b2m=False, local=False):
    """Device time by kernel over train steps at STEP_HW bs 1 (fp32, or the
    bf16 tier), box2mask's fp32 step at bs 1 or the 1024p LocalEnhancer's
    fp32 step at bs 1, grouped by kind; the idle share is that of the
    unprofiled step (phase 8, 12, 15 or 21)."""
    if b2m:
        opt = BoxToMaskTrainOptions(gpu_ids=GPU_IDS, lambda_ctx_neg=5.0, **B2M_ARCH)
        batch = b2m_batch(1, dev, seed=12)
    elif local:
        opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, **LOCAL_G, **LOCAL_D)
        batch = encode_inputs(1, *HW_1024, dev, seed=12)
    else:
        opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype="bfloat16" if bf16 else "float32",
                                      **ARCH)
        batch = encode_inputs(1, *STEP_HW, dev, seed=12)
    model = create_model(opt)
    step = make_train_step(model, torch.bfloat16 if bf16 else None)
    state = make_optimizers(opt, model, 1000)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    step_ms = (results["box2mask_step"]["rows"][0] if b2m else results["step_bf16"][0] if bf16
               else results["local_step"]["rows"][0] if local
               else results["step"]["rows"][0])["ms_per_step"]
    tag = ("profile box2mask train" if b2m else "profile train bf16" if bf16
           else "profile train 1024p" if local else "profile train")
    profile_by_kind(lambda: step(state, batch), 3, tag, step_ms, results)
    del model
    torch.cuda.empty_cache()


def phase_profile_two_step(dev, results):
    """Device time by kernel over add edits at bs 1 (the full-width stages
    at their seeded init, a scene of DATAROOT_HW), grouped by kind; the
    idle share is that of phase 17's unprofiled add at bs 1."""
    b2m = create_model(BoxToMaskTestOptions(gpu_ids=GPU_IDS, **{**B2M_DEPTH, **B2M_ARCH}))
    m2i = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, **ARCH))
    pipe = TwoStepPipeline(b2m, m2i)
    scene = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        np.random.RandomState(13), 1, hw=DATAROOT_HW, label_nc=35).items()}
    cls = torch.tensor([26], dtype=torch.int32, device=dev)

    def add():
        return pipe.add_object(scene["image"], scene["label"], scene["inst"], scene["boxes"], cls)

    for _ in range(2):
        add()
    torch.cuda.synchronize()
    row = next(r for r in results["two_step_pipeline"]["rows"] if r["mode"] == "add" and r["bs"] == 1)
    profile_by_kind(add, 3, "profile two-step add", row["ms_per_edit_batch"], results)
    del pipe, b2m, m2i
    torch.cuda.empty_cache()


def write_dataroot(root, n=4, phase="test", seed=0):
    """Cityscapes-like scenes of DATAROOT_HW: label ids 0..34 (uint8), inst =
    class id for stuff and class*1000+k for things (mode 'I'), random RGB."""
    from PIL import Image

    h, w = DATAROOT_HW
    rng = np.random.RandomState(seed)
    for sub in (f"{phase}_label", f"{phase}_inst", f"{phase}_img"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        label = np.full((h, w), 7, np.uint8)               # road
        label[: h // 3] = 23                               # sky
        label[h // 3 : h // 2] = rng.choice([11, 21])      # building / vegetation
        label[h // 2 : h // 2 + 8] = rng.randint(0, 35)    # a stray band of any id
        inst = label.astype(np.int32)
        for k in range(3):
            cls = rng.choice([24, 26, 33])                 # person, car, bicycle
            bh, bw = rng.randint(48, 160), rng.randint(64, 240)
            y0, x0 = rng.randint(h // 3, h - bh), rng.randint(0, w - bw)
            label[y0 : y0 + bh, x0 : x0 + bw] = cls
            inst[y0 : y0 + bh, x0 : x0 + bw] = cls * 1000 + k
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(label).save(os.path.join(root, f"{phase}_label", f"{i}.png"))
        Image.fromarray(inst, mode="I").save(os.path.join(root, f"{phase}_inst", f"{i}.png"))
        Image.fromarray(img).save(os.path.join(root, f"{phase}_img", f"{i}.png"))


def phase_serving(tmp, results):
    """The main path: the port's CLI end to end on the card."""
    root = os.path.join(tmp, "city")
    write_dataroot(root)
    outputs, sites = [], []
    orig_inference = Pix2PixHDModel.inference

    def checked_inference(self, batch):
        out = orig_inference(self, batch)
        outputs.append((tuple(out.shape), bool(torch.isfinite(out).all())))
        return out

    per_forward, pads, arch = [], [], {}

    def record_site(module, args, kwargs, _out):
        if len(sites) < per_forward[0]:
            sites.append((tuple(args[0].shape), module.act, kwargs.get("residual") is not None))

    hooks = []
    orig_create = mask2image_test.create_model

    def create_and_hook(opt):
        model = orig_create(opt)
        g = model.netG
        per_forward.append(1 + 2 * g.n_downsampling + 2 * g.n_blocks)  # 27 at full width
        pads.append(forward_pads(model))                               # 19
        arch.update(ngf=g.conv_in.weight.shape[0], n_down=g.n_downsampling,
                    n_blocks=g.n_blocks)
        log(f"[serving] GlobalGenerator {sum(p.numel() for p in g.parameters())} params, "
            f"input_nc {model.generator_input_nc()}, {per_forward[0]} IN sites per forward")
        for m in g.modules():
            if isinstance(m, networks.NormAct):
                hooks.append(m.register_forward_hook(record_site, with_kwargs=True))
        return model

    argv = ["--name", "smoke", "--dataroot", root,
            "--checkpoints_dir", os.path.join(tmp, "ckpt"),
            "--results_dir", os.path.join(tmp, "results"),
            "--gpu_ids", GPU_IDS, "--how_many", "4", *ARCH_ARGV]
    zero_launches()
    t = time.time()
    with mock.patch.object(Pix2PixHDModel, "inference", checked_inference), \
            mock.patch.object(mask2image_test, "create_model", create_and_hook), \
            recording() as calls:
        mask2image_test.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = read_launches()
    all_variants = expect_variants(calls, "serving CLI")
    variants = all_variants["instance_norm"]
    for h in hooks:
        h.remove()
    web = os.path.join(tmp, "results", "smoke", "test_latest")
    with open(os.path.join(web, "index.html")) as f:
        rows = f.read().count("<h3>")
    # gallery files are named after the source image, so crops of one
    # image share a name; the page keeps one row per result
    synth = [n for n in os.listdir(os.path.join(web, "images"))
             if n.endswith("_synthesized_image.png")]
    log(f"[serving] CLI wall {wall:.1f} s (incl. model init + data), outputs {outputs}")
    log(f"[serving] launches {launches}, IN forward variants {variants}; {rows} gallery rows, "
        f"{len(synth)} image files")
    if rows != 4 or not synth:
        raise AssertionError(f"gallery incomplete: {rows} rows, files {synth}")
    if len(outputs) != 4 or not all(f for _, f in outputs):
        raise AssertionError(f"non-finite or missing outputs: {outputs}")
    expect_launches(launches, dict(
        {k: 0 for k in launches}, encode=len(outputs),
        instance_norm=per_forward[0] * len(outputs), reflect_pad_fwd=pads[0] * len(outputs)),
        "serving CLI")
    if len(sites) != per_forward[0]:
        raise AssertionError(f"expected {per_forward[0]} IN sites per forward, saw {len(sites)}")
    if sites != generator_sites(*outputs[0][0][:3], **arch):
        raise AssertionError(f"IN sites off the architecture: {sites}")
    results["serving"] = dict(wall_s=wall, outputs=outputs, launches=launches, variants=variants,
                              all_variants=all_variants)
    results["launches"] = launches
    results["sites"] = sites
    return sites, outputs[0][0]


@contextlib.contextmanager
def plain_path():
    """Route the model through the plain versions (comparison only)."""
    with mock.patch.object(kenc, "encode", kenc.encode_plain), \
            mock.patch.object(kenc, "encode_cond", kenc.encode_cond_plain), \
            mock.patch.object(kin, "instance_norm", kin.instance_norm_plain), \
            mock.patch.object(kin, "instance_norm_act", kin.instance_norm_act_plain), \
            mock.patch.object(klosses, "reduce_group", klosses.reduce_group_plain), \
            mock.patch.object(krp, "reflect_pad", krp.reflect_pad_plain):
        yield


def generator_sites(bs, h, w, ngf=64, n_down=4, n_blocks=9):
    """(shape, act, residual?) of every IN site of one GlobalGenerator
    forward, in order: stem, downs, 2 per resblock, ups (27 at full width)."""
    sites = [((bs, h, w, ngf), "relu", False)]
    sites += [((bs, h >> i, w >> i, ngf << i), "relu", False) for i in range(1, n_down + 1)]
    mid = (bs, h >> n_down, w >> n_down, ngf << n_down)
    for _ in range(n_blocks):
        sites += [(mid, "relu", False), (mid, "none", True)]
    sites += [((bs, h >> i, w >> i, ngf << i), "relu", False) for i in range(n_down - 1, -1, -1)]
    return sites


def time_in_sites(dev, sites, seed):
    """Run every IN site of a forward (each with its own fp32 tensors) through
    the kernel and the plain version; check them; time the whole sequence as
    device time (graph replay). library_ms: F.instance_norm on the same
    inputs, IN alone (it has no residual/activation epilogue)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    calls, nbytes, ops, err = [], 0, 0, 0.0
    for shape, act, has_res in sites:
        x = torch.randn(shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev) if has_res else None
        y = kin.instance_norm(x, act, r)[0]
        yp = kin.instance_norm_plain(x, act, r)[0]
        torch.cuda.synchronize()
        err = max(err, (y - yp).abs().max().item())
        calls.append((x, act, r))
        b, o = in_bytes(shape[0], shape[1] * shape[2], shape[3], 4, has_res)
        nbytes, ops = nbytes + b, ops + o
    if err > IN_FP32_ATOL:
        raise AssertionError(f"IN mismatch over the forward's sites: {err}")

    def run(fn):
        return lambda: [fn(x, a, r) for x, a, r in calls]

    bms, by = bound(nbytes, ops)
    return dict(
        max_abs_err=err,
        ms=graph_ms(run(kin.instance_norm)),
        eager_ms=cuda_ms(run(kin.instance_norm), 20),
        plain_ms=graph_ms(run(kin.instance_norm_plain)),
        library_ms=graph_ms(run(lambda x, a, r: F.instance_norm(x.permute(0, 3, 1, 2)))),
        bound_ms=bms, bound_by=by, bytes=nbytes,
        per=f"the {len(sites)} IN sites of one forward, fp32 "
            "(library_ms: IN alone, no epilogue)",
    )


def phase_forward_sites(dev, results):
    """IN over one 512x256 forward (27 launches) and encode (1 launch), bs 1
    and 8, fp32 — the table of PERF.md."""
    rows = []
    for bs in (1, 8):
        row = dict(bs=bs, **time_in_sites(dev, generator_sites(bs, 256, 512), seed=4))
        rows.append(row)
        log(f"[forward 512x256] instance_norm x27 {row}")
        inp = encode_inputs(bs, 256, 512, dev)
        args = (inp["label"], inp["inst"], inp["image"], inp["boxes"], 35)
        bms, by = bound(*encode_bytes(bs, 256, 512, 35, 3, 4))
        erow = dict(bs=bs, name="encode pad 3", ms=graph_ms(lambda: kenc.encode(*args, pad=3)),
                    plain_ms=graph_ms(lambda: kenc.encode_plain(*args, pad=3)),
                    bound_ms=bms, bound_by=by)
        rows.append(erow)
        log(f"[forward 512x256] {erow}")
    results["forward_512x256"] = rows


def phase_main_path_kernels(dev, sites, out_shape, results):
    """JSON rows: each kernel timed on the inputs the serving path gives it
    (one 512x512 bbox window, bs 1, fp32)."""
    h, w = out_shape[1:3]
    inp = encode_inputs(1, h, w, dev, seed=3)
    args = (inp["label"], inp["inst"], inp["image"], inp["boxes"], 35)
    got, want = kenc.encode(*args, pad=3), kenc.encode_plain(*args, pad=3)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        raise AssertionError("encode mismatch at the serving shape")
    err = (got - want).abs().max().item()
    nbytes, ops = encode_bytes(1, h, w, 35, 3, 4)
    bms, by = bound(nbytes, ops)
    enc = dict(
        name="encode (pad 3)", variant="pad3", route="cuda", source=f"{PKG}/csrc/encode.cu",
        replaces=f"{JAX_PKG}/ops/pallas/encode.py:205",
        launches=results["serving"]["all_variants"]["encode"]["pad3"], max_abs_err=err,
        ms=graph_ms(lambda: kenc.encode(*args, pad=3), 50),
        eager_ms=cuda_ms(lambda: kenc.encode(*args, pad=3), 50),
        plain_ms=graph_ms(lambda: kenc.encode_plain(*args, pad=3)),
        bound_ms=bms, bound_by=by, library_ms=None,
        per=f"one (1, {h}, {w}) bbox window, pad 3, fp32",
    )
    inn = dict(
        name="instance_norm", route="cuda", source=f"{PKG}/csrc/instance_norm.cu",
        replaces=f"{JAX_PKG}/ops/pallas/instance_norm.py:118",
        launches=results["launches"]["instance_norm"],
        **time_in_sites(dev, sites, seed=2),
    )
    for row in (enc, inn):
        row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
        log(f"[main-path kernel] {row}")
    return [enc, inn]


def encode_pad0_row(local_table, train_variants, serve_variants):
    """JSON row of row 2 (``encode_full``, the pad-0 encode): its launches on
    main path 8 (the 1024p train and serving CLIs), timed on the call one
    1024x512 LocalEnhancer step makes of it (phase 19)."""
    t = next(r for r in local_table if r["name"] == "encode")
    row = dict(name="encode (pad 0)", variant="pad0", route="cuda",
               source=f"{PKG}/csrc/encode.cu", replaces=f"{JAX_PKG}/ops/pallas/encode.py:142",
               launches=train_variants["encode"]["pad0"] + serve_variants["encode"]["pad0"],
               max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
               bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
               per=f"the {t['launches_per_step']} call one {HW_1024[1]}x{HW_1024[0]} "
                   "LocalEnhancer step makes, bs 1, fp32")
    row["max_abs_diff"], row["kernel_ms"] = row["max_abs_err"], row["ms"]
    log(f"[main-path kernel] {row}")
    return row


def phase_model(dev, results):
    opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, **ARCH)
    model = create_model(opt)
    nparams = sum(p.numel() for p in model.netG.parameters())
    log(f"[model] GlobalGenerator params {nparams}, precision {model.conv_precision_resolved}")
    rows = []
    for bs, iters in ((1, 10), (8, 3)):
        batch = encode_inputs(bs, 256, 512, dev, seed=5)
        out = model.inference(batch)
        with plain_path():
            ref = model.inference(batch)
        torch.cuda.synchronize()
        diff = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or diff > MODEL_ATOL:
            raise AssertionError(f"model bs{bs}: kernel vs plain max|diff| {diff}")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            model.inference(batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            model.inference(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / iters * 1e3
        with plain_path():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                model.inference(batch)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t) / iters * 1e3
        row = dict(bs=bs, hw=[256, 512], dtype="float32", precision="highest",
                   ms_per_batch=ms, ms_per_image=ms / bs, images_per_s=bs * 1e3 / ms,
                   plain_ms_per_batch=plain, max_abs_diff_vs_plain=diff,
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
        rows.append(row)
        log(f"[model] {row}")
    # TF32 convolutions (the --dtype bfloat16 / --conv_precision default tier)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    batch = encode_inputs(8, 256, 512, dev, seed=5)
    ms = cuda_ms(lambda: model.inference(batch), 3)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows.append(dict(bs=8, hw=[256, 512], dtype="float32", precision="default (TF32)",
                     ms_per_batch=ms, ms_per_image=ms / 8, images_per_s=8e3 / ms))
    log(f"[model] {rows[-1]}")
    del model
    # --norm batch: the unpadded (pad 0) encode mode, BASELINE config 1 size
    mb = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, norm="batch", **ARCH))
    batch = encode_inputs(1, 128, 256, dev, seed=6)
    before = kenc.encode.launches
    out = mb.inference(batch)
    launched = kenc.encode.launches - before
    with plain_path():
        ref = mb.inference(batch)
    torch.cuda.synchronize()
    diff = (out - ref).abs().max().item()
    expect_launches(launched, 1, "--norm batch forward, encode")
    if not torch.isfinite(out).all() or diff > MODEL_ATOL:
        raise AssertionError(f"--norm batch forward: diff {diff}")
    log(f"[model] --norm batch 256x128: out {tuple(out.shape)}, max|diff| vs plain {diff}")
    results["model"] = rows
    results["norm_batch_max_abs_diff"] = diff


def phase_profile(dev, results):
    """Device time by kernel name over one bs-1 512x256 forward."""
    from torch.profiler import ProfilerActivity, profile

    model = create_model(MaskToImageTestOptions(gpu_ids=GPU_IDS, **ARCH))
    batch = encode_inputs(1, 256, 512, dev, seed=7)
    for _ in range(2):
        model.inference(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.inference(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    log(table)
    results["profile_table"] = table


# ------------------------------------------- data parallel, remat, spatial

class ConvCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the forward convolutions dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def grads_after(model, batch, dtype=None, nudge=False):
    """(metrics, gradients) of one G+D objective from zeroed gradients,
    cuDNN deterministic; ``nudge`` moves the image up by one ulp of the
    dtype the step computes in first (bf16: the image's bf16 bits plus 1,
    which the step's cast keeps)."""
    if nudge:
        img = batch["image"]
        if dtype == torch.bfloat16:
            bits = img.to(torch.bfloat16).view(torch.int16)
            img = (bits + 1).view(torch.bfloat16).to(img.dtype)   # images lie in [-1, 1]
        else:
            img = torch.nextafter(img, torch.full_like(img, 2.0))
        batch = dict(batch, image=img)
    for m in grad_audit.trained(model).values():
        m.zero_grad(set_to_none=True)
    with cudnn_deterministic():
        params, b = _loss_inputs(model, batch, dtype)
        total, metrics, _ = model.losses(b, params)
        total.backward()
    return {k: v.item() for k, v in metrics.items()}, grads_of(model)


def held_to_sensitivity(got, want, sens, metrics, want_metrics, what):
    """``got`` gradients against ``want`` within STEP_SENS_FACTOR times the
    1-ulp sensitivity ``sens`` (compare_step's bar), the metrics within
    STEP_LOSS_RTOL -> the record."""
    diffs = _leaf_diffs(got, want)
    whole = _worst(diffs)
    bits = all(x is None and y is None or torch.equal(x, y) for (_, x), (_, y) in zip(got, want))
    loss_rel = max(abs(metrics[k] - want_metrics[k]) / max(abs(want_metrics[k]), 1e-30)
                   for k in want_metrics)
    log(f"[{what}] gradients (max|diff|/max|g|, ||diff||/||g||, leaf) {whole}, bit-equal "
        f"{bits}; 1-ulp sensitivity {sens}; losses max rel {loss_rel:.3g}")
    if loss_rel > STEP_LOSS_RTOL or whole[0] > STEP_SENS_FACTOR * max(sens[0], 1e-30) or \
            whole[1] > STEP_SENS_FACTOR * max(sens[1], 1e-30):
        raise AssertionError(f"{what}: gradients {whole} beyond {STEP_SENS_FACTOR}x the "
                             f"sensitivity {sens}, or losses {loss_rel}")
    return dict(gradients=whole, bit_equal=bits, sensitivity=sens, max_loss_rel=loss_rel)


def expect_remat_launches(policy, launches, none, n_blocks):
    """A remat policy launches what ``none`` launches, but for the IN
    forwards and the reflect pads' forwards its recompute adds (none under
    ``none``; the pads 2 a resblock) -> the IN forwards it adds."""
    again = ("instance_norm", "reflect_pad_fwd")
    extra = {k: launches[k] - none[k] for k in again}
    if {k: v for k, v in launches.items() if k not in again} != \
            {k: v for k, v in none.items() if k not in again} or \
            (policy == "none") != (extra["instance_norm"] == 0) or \
            extra["reflect_pad_fwd"] != (0 if policy == "none" else 2 * n_blocks):
        raise AssertionError(f"remat {policy}: launches {launches} vs none {none}")
    return extra["instance_norm"]


def phase_remat(dev, results):
    """Phase 29: --remat_policy none / block / conv_out on the flagship step
    (fp32 512x256 bs 4 and bf16 1024x512 bs 4): ms a step, peak memory, the
    convolutions backward launches again, every kernel's launches, and the
    losses and gradients against none's (cuDNN deterministic)."""
    rows = []
    for hw, bs, dtype in REMAT_CASES:
        compute = torch.bfloat16 if dtype == "bfloat16" else None
        batch = encode_inputs(bs, *hw, dev, seed=12)
        ref = None
        for policy in networks.REMAT_POLICIES:
            opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, dtype=dtype, remat_policy=policy,
                                          **ARCH)
            model = create_model(opt)
            zero_launches()
            for m in grad_audit.trained(model).values():
                m.zero_grad(set_to_none=True)
            with cudnn_deterministic():
                params, b = _loss_inputs(model, batch, compute)
                total, metrics, _ = model.losses(b, params)
                fwd = read_launches()
                with ConvCount() as convs:
                    total.backward()
            torch.cuda.synchronize()
            launches, variants = read_launches(), read_variants()
            in_bwd = {k: launches[k] - fwd[k] for k in launches}
            metrics = {k: v.item() for k, v in metrics.items()}
            grads = grads_of(model)
            row = dict(hw=list(hw), bs=bs, dtype=dtype, policy=policy,
                       convs_recomputed_in_backward=convs.n, launches=launches,
                       variants=variants, launches_in_backward=in_bwd)
            if ref is None:
                sens = _worst(_leaf_diffs(grads_after(model, batch, compute, nudge=True)[1],
                                          grads))
                ref = (grads, metrics, sens, launches)
            else:
                row["vs_none"] = held_to_sensitivity(grads, ref[0], ref[2], metrics, ref[1],
                                                     f"remat {policy} {dtype} bs {bs}")
            want_convs = 0 if policy != "block" else 2 * model.netG.n_blocks
            if convs.n != want_convs:
                raise AssertionError(f"remat {policy}: {convs.n} convolutions in backward, "
                                     f"want {want_convs}")
            row["instance_norm_recomputed"] = expect_remat_launches(
                policy, launches, ref[3], model.netG.n_blocks)
            del grads
            state = make_optimizers(opt, model, 1000)
            step = make_train_step(model, compute)
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(REMAT_ITERS):
                step(state, batch)
            torch.cuda.synchronize()
            row["ms_per_step"] = (time.perf_counter() - t) / REMAT_ITERS * 1e3
            row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            log(f"[remat] {row}")
            rows.append(row)
            del model, state, step
            torch.cuda.empty_cache()
    results["remat"] = rows
    first = [r for r in rows if r["hw"] == list(REMAT_CASES[0][0])]
    return ({f"remat_{r['policy']}": r["launches"] for r in first},
            {f"remat_{r['policy']}": r["variants"] for r in first})


def phase_debug_nans(dev, results):
    """Phase 30: --debug_nans on the card: a batch with a NaN pixel raises
    FloatingPointError before the optimizers step; a clean one trains."""
    opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, debug_nans=True, **ARCH)
    model = create_model(opt)
    state = make_optimizers(opt, model, 1000)
    step = make_train_step(model, debug_nans=True)
    batch = encode_inputs(1, *STEP_HW, dev, seed=13)
    metrics, _ = step(state, batch)
    poisoned = dict(batch, image=batch["image"].clone())
    poisoned["image"][0, 5, 7, 1] = float("nan")
    w = model.netG.conv_in.weight.detach().clone()
    try:
        step(state, poisoned)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("--debug_nans: a NaN batch trained without a word")
    if state.step != 1 or not torch.equal(w, model.netG.conv_in.weight):
        raise AssertionError("--debug_nans: the poisoned step moved the parameters")
    log(f"[debug_nans] clean step losses {({k: v.item() for k, v in metrics.items()})}; "
        f"poisoned step raised: {raised}")
    results["debug_nans"] = dict(raised=raised)
    del model, state
    torch.cuda.empty_cache()


def _spatial_nets(dev):
    """The flagship GlobalGenerator and the 1024p LocalEnhancer (mask2image's
    39 input channels), random weights from a seed, on ``dev``."""
    gen = torch.Generator().manual_seed(21)
    g = networks.GlobalGenerator(39, ngf=ARCH.get("ngf", 64),
                                 n_downsampling=ARCH.get("n_downsample_global", 4),
                                 n_blocks=ARCH.get("n_blocks_global", 9))
    g.reset_parameters(gen)
    le = networks.LocalEnhancer(39, ngf=LOCAL_G["ngf"],
                                n_downsample_global=ARCH.get("n_downsample_global", 4),
                                n_blocks_global=ARCH.get("n_blocks_global", 9),
                                n_local_enhancers=LOCAL_G["n_local_enhancers"],
                                n_blocks_local=LOCAL_G["n_blocks_local"])
    le.reset_parameters(gen)
    return {"global": g.to(dev).eval(), "local": le.to(dev).eval()}


def _spatial_fwd(kind, net, mesh):
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import spatial

    if kind == "local":
        return spatial.make_spatial_local_enhancer(
            mesh, net, n_downsample_global=getattr(net, "global").n_downsampling,
            n_blocks_global=getattr(net, "global").n_blocks,
            n_local_enhancers=net.n_local_enhancers, n_blocks_local=net.n_blocks_local)
    return spatial.make_spatial_generator(mesh, net, n_downsampling=net.n_downsampling,
                                          n_blocks=net.n_blocks)


def rank_phase(rank, world, init, cfg, out_dir):
    """One of phase 31's ranks (two gloo ranks sharing the card): the DP
    step (against the single-process step on the concatenated batch, rank
    0), the resident DP step and the W-sharded forwards (against the
    unsharded ones, rank 0); its launches and times to a JSON file."""
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import distributed, make_mesh
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import spatial

    global ARCH, LOCAL_G
    ARCH, LOCAL_G = cfg["arch"], cfg["local_g"]
    dev = distributed.rank_devices(cfg["gpu_ids"], world)[rank]
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    distributed.maybe_initialize(init, world, rank, "gloo", dev, timeout_s=300)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    peak = ((lambda: torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else (lambda: 0))
    try:
        mesh = make_mesh((world,), ("data",))
        out = {"rank": rank, "device": str(dev)}
        opt = MaskToImageTrainOptions(gpu_ids=cfg["gpu_ids"], **ARCH)
        model = create_model(opt)
        state = make_optimizers(opt, model, 1000)
        train_steps.replicate(model, state)
        gbatch = encode_inputs(cfg["bs"], *cfg["hw"], dev, seed=14)
        shard = train_steps.shard_batch(gbatch, mesh)
        step = train_steps.make_dp_train_step(model, mesh)
        zero_launches()
        with cudnn_deterministic():
            metrics, _ = step(state, shard)
        sync()
        out["dp_launches"], out["dp_variants"] = read_launches(), read_variants()
        dp = ({k: v.item() for k, v in metrics.items()}, grads_of(model))
        for _ in range(1):
            step(state, shard)
        sync()
        t = time.perf_counter()
        for _ in range(cfg["iters"]):
            step(state, shard)
        sync()
        out["dp_ms"] = (time.perf_counter() - t) / cfg["iters"] * 1e3
        out["dp_peak_mem_bytes"] = peak()
        if rank == 0:
            ref = create_model(opt)
            single = grads_after(ref, gbatch)
            sens = _worst(_leaf_diffs(grads_after(ref, gbatch, nudge=True)[1], single[1]))
            out["dp_vs_single"] = held_to_sensitivity(dp[1], single[1], sens, dp[0], single[0],
                                                      "DP step vs single-process step")
            rstate = make_optimizers(opt, ref, 1000)
            zero_launches()
            make_train_step(ref)(rstate, shard)    # the single-card step at the rank's batch
            sync()
            out["single_launches"], out["single_variants"] = read_launches(), read_variants()
            del ref, rstate, single
        del dp
        # the resident DP step over the train CLI's dataroot
        ropt = MaskToImageTrainOptions(gpu_ids=cfg["gpu_ids"], dataroot=cfg["dataroot"],
                                       device_resident_data=True, batchSize=cfg["bs"],
                                       **{k: v for k, v in ARCH.items() if k != "batchSize"})
        loader = CreateDataLoader(ropt)
        sample_fn, data = loader.fused_sampler()
        rstep, _ = train_steps.make_resident_dp_train_step(model, mesh, sample_fn,
                                                           loader.n_samples, cfg["bs"], seed=5)
        zero_launches()
        for _ in range(2):
            metrics, _ = rstep(state, data)
        sync()
        out["resident_launches"], out["resident_variants"] = read_launches(), read_variants()
        out["resident_losses"] = {k: v.item() for k, v in metrics.items()}
        del model, state, step, rstep, loader, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the W-sharded forwards
        out["spatial"] = {}
        for kind, net in _spatial_nets(dev).items():
            x = torch.randn((1, *cfg["spatial_hw"], 39), generator=torch.Generator(dev).manual_seed(
                22), device=dev)
            fwd = _spatial_fwd(kind, net, mesh)
            slab = spatial.shard_w(x, mesh).contiguous()
            zero_launches()
            y = fwd(slab)
            sync()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
            t = time.perf_counter()
            for _ in range(cfg["spatial_iters"]):
                y = fwd(slab)
            sync()
            rec = dict(ms=(time.perf_counter() - t) / cfg["spatial_iters"] * 1e3,
                       peak_mem_bytes=peak(), resident_bytes=base, launches=read_launches(),
                       slab=list(slab.shape))
            full = spatial.gather_w(y, mesh)
            if rank == 0:
                with torch.no_grad():
                    want = net(x)
                    sync()
                    if dev.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(dev)
                    t = time.perf_counter()
                    for _ in range(cfg["spatial_iters"]):
                        want = net(x)
                    sync()
                rec.update(unsharded_ms=(time.perf_counter() - t) / cfg["spatial_iters"] * 1e3,
                           unsharded_peak_mem_bytes=peak(),
                           max_abs_err=(full - want).abs().max().item(),
                           shape=list(full.shape))
                del want
            out["spatial"][kind] = rec
            del x, y, full, net
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
    finally:
        distributed.shutdown(True)


def phase_parallel(tmp, dev, results):
    """Phase 31: the DP step at world size 1 over NCCL in this process
    (against the single step, bit for bit where cuDNN is deterministic),
    then two gloo ranks sharing the card (``rank_phase``): the DP step per
    rank against the single-card step at the rank's batch (launches per
    kernel and variant) and against the single-process step on the
    concatenated batch, the resident DP step, and the W-sharded
    GlobalGenerator and LocalEnhancer at SPATIAL_HW against their unsharded
    forwards, which launch none of the port's kernels. The DP times over
    gloo measure the host-staged transport of one card, not scaling."""
    from neurips18_hierchical_image_manipulation_tpu_torch.parallel import distributed, make_mesh

    init = os.path.join(tmp, "nccl_init")
    distributed.maybe_initialize(f"file://{init}", 1, 0, "nccl" if dev.type == "cuda" else "gloo",
                                 dev, timeout_s=300)
    try:
        backend = torch.distributed.get_backend()
        opt = MaskToImageTrainOptions(gpu_ids=GPU_IDS, **ARCH)
        model = create_model(opt)
        batch = encode_inputs(1, *STEP_HW, dev, seed=15)
        single = grads_after(model, batch)
        sens = _worst(_leaf_diffs(grads_after(model, batch, nudge=True)[1], single[1]))
        mesh = make_mesh((1,), ("data",))
        state = make_optimizers(opt, model, 1000)
        step = train_steps.make_dp_train_step(model, mesh)
        zero_launches()
        with cudnn_deterministic():
            metrics, _ = step(state, batch)
        torch.cuda.synchronize()
        w1_launches, w1_variants = read_launches(), read_variants()
        w1 = held_to_sensitivity(grads_of(model), single[1], sens,
                                 {k: v.item() for k, v in metrics.items()}, single[0],
                                 f"DP step, world size 1 over {backend}")
        step(state, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DP_ITERS):
            step(state, batch)
        torch.cuda.synchronize()
        w1["ms_per_step"] = (time.perf_counter() - t) / DP_ITERS * 1e3
        w1["transport"] = f"{backend}, world size 1"
        del model, state, step, single
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown(True)
    log(f"[parallel] world size 1: {w1}")
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    cfg = dict(gpu_ids=DP_GPU_IDS, arch=ARCH, local_g=LOCAL_G, hw=list(STEP_HW), bs=DP_BS,
               iters=DP_ITERS, dataroot=os.path.join(tmp, "city_train"),
               spatial_hw=list(SPATIAL_HW), spatial_iters=SPATIAL_ITERS)
    t = time.time()
    distributed.spawn(rank_phase, 2, args=(2, f"file://{os.path.join(tmp, 'gloo_init')}", cfg,
                                           out_dir), join_timeout_s=RANK_JOIN_S)
    wall = time.time() - t
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0, r1 = ranks
    for r in ranks:   # every rank launches what one single-card step at its batch launches
        expect_launches(r["dp_launches"], r0["single_launches"], f"DP step rank {r['rank']}")
        if r["dp_variants"] != r0["single_variants"]:
            raise AssertionError(f"DP rank {r['rank']} variants {r['dp_variants']} vs "
                                 f"{r0['single_variants']}")
        expect_launches(r["resident_launches"],
                        {k: 2 * n for k, n in r0["single_launches"].items()},
                        f"resident DP step rank {r['rank']}")
        if not all(np.isfinite(v) for v in r["resident_losses"].values()):
            raise AssertionError(f"resident DP losses {r['resident_losses']}")
        for kind, rec in r["spatial"].items():
            expect_launches(rec["launches"], {k: 0 for k in rec["launches"]},
                            f"spatial {kind} rank {r['rank']}")
    for kind, rec in r0["spatial"].items():
        if rec["max_abs_err"] > MODEL_ATOL:
            raise AssertionError(f"spatial {kind}: max |diff| {rec['max_abs_err']} vs unsharded")
    transport = "gloo, 2 ranks sharing one card (host-staged collectives)"
    log(f"[parallel] {transport}: DP step {r0['dp_ms']:.2f} / {r1['dp_ms']:.2f} ms (rank 0 / 1), "
        f"peak {r0['dp_peak_mem_bytes']} B; vs single {r0['dp_vs_single']}; spawn + phase "
        f"{wall:.1f} s")
    for kind in r0["spatial"]:
        a, b = r0["spatial"][kind], r1["spatial"][kind]
        log(f"[parallel] spatial {kind} {SPATIAL_HW[1]}x{SPATIAL_HW[0]} ({transport}): "
            f"{a['ms']:.1f} / {b['ms']:.1f} ms, peak {a['peak_mem_bytes']} / "
            f"{b['peak_mem_bytes']} B (rank 0 / 1); unsharded {a['unsharded_ms']:.1f} ms, peak "
            f"{a['unsharded_peak_mem_bytes']} B; max |diff| {a['max_abs_err']:.3g}")
    results["parallel"] = dict(world1=w1, ranks=ranks, transport=transport, wall_s=wall,
                               world1_launches=w1_launches)
    return ({"dp_world1": w1_launches, "dp_rank0": r0["dp_launches"],
             "dp_rank1": r1["dp_launches"], "resident_dp_rank0": r0["resident_launches"],
             "spatial_rank0": r0["spatial"]["global"]["launches"]},
            {"dp_world1": w1_variants, "dp_rank0": r0["dp_variants"],
             "dp_rank1": r1["dp_variants"], "resident_dp_rank0": r0["resident_variants"],
             "spatial_rank0": {k: {v: 0 for v in d} for k, d in w1_variants.items()}})


def phase_parallel_clis(tmp, results):
    """Phases 32-33: main path 13, the mask2image train CLI over two gloo
    ranks on the card (``--gpu_ids 0,0 --mesh_devices 2``, the fused
    resident DP step) one epoch, rank 0 alone writing; and the serving CLI
    ``--spatial_shards 2`` against phase 5's unsharded gallery."""
    from PIL import Image

    ckpt = os.path.join(tmp, "ckpt_dp")
    root = os.path.join(tmp, "city_dp")
    write_dataroot(root, n=1, phase="train", seed=3)
    argv = ["--name", "smoke_dp", "--dataroot", root,
            "--checkpoints_dir", ckpt, "--gpu_ids", DP_GPU_IDS, "--mesh_devices", "2",
            "--batchSize", str(DP_BS), "--device_resident_data", "--niter", "1",
            "--niter_decay", "0", "--print_freq", "1", "--save_epoch_freq", "100", *ARCH_ARGV]
    t = time.time()
    if mask2image_train.main(argv) is not None:
        raise AssertionError("the DP train CLI trained in this process")
    wall = time.time() - t
    with open(os.path.join(ckpt, "smoke_dp", "loss_log.txt")) as f:
        log_txt = f.read()
    lines = [ln for ln in log_txt.splitlines() if ln.startswith("(epoch: ")]
    with open(os.path.join(ckpt, "smoke_dp", "iter.txt")) as f:
        it = f.read()
    if log_txt.count("Training Loss") != 1 or not lines or it != "2,0" or \
            not os.path.exists(os.path.join(ckpt, "smoke_dp", "ckpt", "latest_params.npz")):
        raise AssertionError(f"DP CLI wrote {log_txt!r}, iter.txt {it!r}")
    vals = [float(v) for ln in lines for v in re.findall(r": (-?[0-9.]+|nan|inf)", ln)[1:]]
    if not all(np.isfinite(v) for v in vals):
        raise AssertionError(f"DP CLI losses {lines}")
    log(f"[DP CLI] 2 gloo ranks on the card, {len(lines)} steps in {wall:.1f} s (spawn, "
        f"model init, upload, checkpoint writes)")
    res = os.path.join(tmp, "results_spatial")
    argv = ["--name", "smoke", "--dataroot", os.path.join(tmp, "city"),
            "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--results_dir", res,
            "--gpu_ids", DP_GPU_IDS, "--how_many", "4", "--spatial_shards", "2", *ARCH_ARGV]
    t = time.time()
    mask2image_test.main(argv)
    swall = time.time() - t
    worst, n = 0, 0
    ref_dir = os.path.join(tmp, "results", "smoke", "test_latest", "images")
    got_dir = os.path.join(res, "smoke", "test_latest", "images")
    for name in sorted(os.listdir(ref_dir)):
        if name.endswith("_synthesized_image.png"):
            a = np.asarray(Image.open(os.path.join(ref_dir, name))).astype(int)
            b = np.asarray(Image.open(os.path.join(got_dir, name))).astype(int)
            worst, n = max(worst, int(np.abs(a - b).max())), n + 1
    if n == 0 or worst > 1:
        raise AssertionError(f"spatial serving CLI: {n} images, worst level diff {worst}")
    log(f"[spatial CLI] --spatial_shards 2 over 2 gloo ranks on the card: {n} images equal to "
        f"the unsharded gallery within {worst} level(s), {swall:.1f} s")
    results["parallel_clis"] = dict(dp_cli_steps=len(lines), dp_cli_wall_s=wall,
                                    spatial_cli_images=n, spatial_cli_worst_level=worst,
                                    spatial_cli_wall_s=swall)


# ---------------------------------------------------------------- the tools (phases 34-36)

TOOLS_HOW_MANY = 4           # windows the parity render and FID take
GRAIN_WORKERS = 2            # the train CLIs' decode processes in phase 39
GRAIN_BENCH_WORKERS = (0, 2, 4)
GRAIN_BENCH_BS = 4


@contextlib.contextmanager
def worker_probe(path):
    """Each grain decode worker appends (its pid, torch.cuda.is_initialized())
    to ``path`` as it starts (``grain_pipeline.worker_init``)."""
    orig = grain_pipeline.worker_init

    def probe(worker_id):
        with open(path, "a") as f:
            f.write(f"{os.getpid()} {worker_id} {torch.cuda.is_initialized()}\n")
        orig(worker_id)

    with mock.patch.object(grain_pipeline, "worker_init", probe):
        yield


def grain_serial_batches(root):
    """Serial-mode batches of phase 6's scenes (two epochs) from the thread
    loader and from grain at 0 and GRAIN_WORKERS workers, bit for bit."""
    runs = {}
    for name, extra in (("threads", []), ("grain0", ["--data_backend", "grain"]),
                        (f"grain{GRAIN_WORKERS}", ["--data_backend", "grain", "--grain_workers",
                                                   str(GRAIN_WORKERS)])):
        loader = CreateDataLoader(parse_cli(MaskToImageTrainOptions, [
            "--dataroot", root, "--gpu_ids", GPU_IDS, "--serial_batches", *ARCH_ARGV, *extra]))
        runs[name] = list(loader) + list(loader)
    ref = runs["threads"]
    for name, got in runs.items():
        if len(got) != len(ref) or not ref:
            raise AssertionError(f"grain serial batches: {name} {len(got)} vs {len(ref)}")
        for i, (a, b) in enumerate(zip(ref, got)):
            if sorted(a) != sorted(b):
                raise AssertionError(f"grain serial batch {i}: keys {sorted(b)}")
            for k in a:
                same = (a[k] == b[k] if isinstance(a[k], list)
                        else a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))
                if not same:
                    raise AssertionError(f"grain serial batch {i} ({name}): {k} differs")
    return len(ref)


def phase_grain(tmp, dev, results, m2i_ref, b2m_ref):
    """Phase 39, main paths 14 and 15: the grain pipeline on the train CLIs
    at full width and beside the other host paths in bench_loop."""
    t0 = time.time()
    root = os.path.join(tmp, "city_train")
    probe = os.path.join(tmp, "grain_workers.txt")
    with worker_probe(probe):
        n_serial = grain_serial_batches(root)
        log(f"[grain] serial mode: {n_serial} batches (two epochs) at --grain_workers 0 and "
            f"{GRAIN_WORKERS} bit for bit the thread loader's")
        ckpt = os.path.join(tmp, "ckpt_grain")
        mid_root = os.path.join(tmp, "ckpt_grain_mid")
        argv = ["--name", "grain", "--dataroot", root, "--checkpoints_dir", ckpt,
                "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
                "--save_epoch_freq", "100", "--data_backend", "grain", "--grain_workers",
                str(GRAIN_WORKERS), *ARCH_ARGV]
        with cudnn_deterministic():
            at = drive_steps_of(argv, mask2image_train) // 2
            with snapshot_latest(at, mid_root):
                straight = run_cli_checked(argv + ["--save_latest_freq", str(at)],
                                           mask2image_train, "grain train CLI", ref=m2i_ref)
            resumed = run_cli_checked(
                [a if a != ckpt else mid_root for a in argv] + ["--continue_train"],
                mask2image_train, f"grain train CLI resumed at step {at}", done=at,
                ref=m2i_ref)
        if resumed["losses"] != straight["losses"][at:]:
            raise AssertionError(f"grain resume: losses {resumed['losses'][:2]} vs "
                                 f"{straight['losses'][at:at + 2]}")
        same_params(saved_params(ckpt, "grain"), saved_params(mid_root, "grain"),
                    "grain train CLI resumed")
        log(f"[grain train CLI] resumed from the step-{at} latest: {resumed['steps']} losses "
            "and every parameter bit for bit the straight run's")
        opt = MaskToImageTestOptions(gpu_ids=GPU_IDS, name="grain", checkpoints_dir=ckpt,
                                     **ARCH)
        serve = create_model(opt)
        if not restore_params(opt, serve):
            raise AssertionError("grain run: latest_params.npz not found")
        trained_g = saved_params(ckpt, "grain")["G"]
        for k, t in serve.netG.state_dict().items():
            if not same_bits(t.cpu(), trained_g[k]):
                raise AssertionError(f"served G differs from the grain run's at {k}")
        out = serve.inference(encode_inputs(1, 512, 512, serve.device, seed=9))
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("grain run's weights serve a non-finite output")
        log(f"[grain train CLI] latest served: output {tuple(out.shape)} finite")
        del serve
        shutil.rmtree(ckpt)
        shutil.rmtree(mid_root)
        torch.cuda.empty_cache()
        b2m_ckpt = os.path.join(tmp, "ckpt_grain_b2m")
        b2m = run_cli_checked(
            ["--name", "grain_b2m", "--dataroot", root, "--checkpoints_dir", b2m_ckpt,
             "--gpu_ids", GPU_IDS, "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
             "--save_epoch_freq", "100", "--lambda_ctx_neg", "5.0", "--bg_box_prob", "0.25",
             "--data_backend", "grain", "--grain_workers", str(GRAIN_WORKERS),
             *flags(B2M_ARCH)], box2mask_train, "grain box2mask train CLI", ref=b2m_ref)
        shutil.rmtree(b2m_ckpt)
        rows = grain_bench(tmp, dev)
    with open(probe) as f:
        workers = [ln.split() for ln in f.read().splitlines()]
    if not workers or any(w[2] != "False" or int(w[0]) == os.getpid() for w in workers):
        raise AssertionError(f"grain workers: {workers}")
    log(f"[grain] {len(workers)} decode workers started, none with a CUDA context")
    results["grain"] = dict(serial_batches=n_serial, train=straight, resumed=resumed,
                            resumed_at=at, box2mask=b2m, bench=rows,
                            workers_started=len(workers), grain_workers=GRAIN_WORKERS)
    phase_seconds(39, "grain", t0, results)
    return {"train_grain": straight, "train_grain_resume": resumed, "box2mask_grain": b2m}


def grain_bench(tmp, dev):
    """tools/bench_loop at phase 27's size, bf16 at GRAIN_BENCH_BS: threads,
    grain at GRAIN_BENCH_WORKERS, prefetched, fused."""
    from neurips18_hierchical_image_manipulation_tpu_torch.tools import bench_loop

    root, ckpt = os.path.join(tmp, "city_measure"), os.path.join(tmp, "measure_grain")
    if not os.path.isdir(root):
        bench_loop.write_dataroot(root, MEASURE_SCENES, seed=0)
    resident = bench_loop.resident_sampler(bench_loop.train_argv(root, ckpt, 1, "float32",
                                                                 GPU_IDS, ARCH_ARGV))
    row = bench_loop.measure(
        bench_loop.train_argv(root, ckpt, GRAIN_BENCH_BS, "bfloat16", GPU_IDS, ARCH_ARGV),
        resident, dev, tmp, MEASURE_WARMUP, MEASURE_STEPS, 1,
        grain_workers=GRAIN_BENCH_WORKERS)
    missing = [f"grain{w}" for w in GRAIN_BENCH_WORKERS
               if w <= bench_loop.cores() and f"grain{w}" not in row]
    if missing:
        raise AssertionError(f"bench_loop measured no {missing}")
    row["cores"] = bench_loop.cores()
    for path in ("streamed", *(f"grain{w}" for w in GRAIN_BENCH_WORKERS), "prefetched",
                 "fused"):
        for r in row.get(path, []):
            log(f"[grain bench] bf16 bs {GRAIN_BENCH_BS} {path}: {r['ms_per_step']:.3f} ms a "
                f"step, wait {r.get('wait_ms_mean', 0.0):.3f} ms, in-line copy "
                f"{r.get('copy_ms_mean', 0.0):.3f} ms, idle share {r['idle_share']:.4f} "
                f"({row['cores']} cores)")
    del resident
    torch.cuda.empty_cache()
    return row


PARITY_ARGV = []             # parity_report flags (empty: its full-width defaults)
CONVERT_HW = (256, 512)      # the converted G against the reference-format module
CONVERT_ATOL = MODEL_ATOL
# the exported stages: (stage, test-option overrides, fineSize); box2mask at
# full width (its test options keep the base depth 4 / 9)
EXPORT_CASES = (("mask2image", {}, 512),
                ("box2mask", {"ngf": 64, "n_downsample_global": 3, "n_blocks_global": 4}, 128))
# the eager and reloaded programs timed by CUDA events in EXPORT_ROUNDS
# interleaved rounds of this many calls each; a stage's ms count as resolved
# when each program's rounds lie within EXPORT_SPREAD of their median
EXPORT_ITERS = {"mask2image": 10, "box2mask": 50}
EXPORT_ROUNDS = 5
EXPORT_SPREAD = 0.03
# the procedural-world chain, short (phase 36); the 1024p world cut from 64
# scenes to 16
DYN_ARGV = ["--steps", "16", "--bs", "16", "--n_images", "64"]
DYN_B2M_ARGV = ["--steps", "40"]
DYN_GALLERY_ARGV = ["--m2i_steps", "40"]
DYN_METRIC_SCENES = 8
DYN_1024P_ARGV = ["--global_steps", "4", "--local_steps", "4", "--n_images", "16"]
# phase 37: the measurement tools at cut sizes (their full-size runs are
# separate calls, reports/torch_r13/); the port-step tools at the CPU tests'
# widths, the oracle at full width
MEASURE_ALL_ARGV = ["--bs", "2", "--iters", "2", "--with_1024p"]
MEASURE_STEP_ARGV = ["--smoke", "--bs", "2"]
MEASURE_ABLATE_ENV = {"HIMAN_BENCH_BS": "2", "HIMAN_BENCH_ITERS": "1"}
MEASURE_CONVT_ARGV = ["--bs", "2", "--iters", "2"]
MEASURE_ORACLE_ARGV = ["--batches", "1", "--iters", "2"]
FLAGSHIP_BS = 32             # the full-size reports' batch, its kernel calls checked
PASSTHROUGH = ("remove_label_passthrough", "remove_image_passthrough",
               "add_label_passthrough", "add_image_passthrough")


def phase_seconds(n, name, t0, results):
    s = time.time() - t0
    results.setdefault("tool_phase_s", {})[name] = s
    log(f"[phase {n} {name}] {s:.1f} s")


def phase_tools_convert(tmp, dev, results):
    """Phase 34: full-width pix2pixHD stand-ins (label_nc 35, ngf 64, 4
    downs, 9 resblocks, input_nc 36, VGG19) written by the parity runbook,
    which converts them and renders phase 5's scenes with the converted G
    (4 windows) for FID: counters zeroed before and read after, the render
    held to the serving counts (27 IN forwards and one no-image encode a
    window); FID finite over the converted VGG19. The converted G on the
    card against the reference-format module run by plain PyTorch / cuDNN
    (fp32, TF32 off) at 512x256; the bbox records of preprocess_city_bboxes
    against data/bbox.extract_bbox_records; the converted VGG19 through
    cli/evaluate.load_vgg."""
    t0 = time.time()
    root, weights = os.path.join(tmp, "city"), os.path.join(tmp, "parity_weights")
    models, orig_create = [], parity_report.create_model

    def create_and_keep(opt):
        models.append(orig_create(opt))
        return models[-1]

    zero_launches()
    with recording() as calls, mock.patch.object(parity_report, "create_model", create_and_keep):
        report = parity_report.main([
            "--weights_dir", weights, "--dataroot", root,
            "--out", os.path.join(tmp, "parity_report.json"), "--gpu_ids", GPU_IDS,
            "--how_many", str(TOOLS_HOW_MANY), "--make_standins", *PARITY_ARGV])
    torch.cuda.synchronize()
    launches = read_launches()
    variants = expect_variants(calls, "parity render")
    (model,) = models
    fid, n = report["stages"]["fid"], TOOLS_HOW_MANY
    if (fid["samples"] != n or not np.isfinite(fid["value"])
            or fid["features"] != "vgg19-pretrained"):
        raise AssertionError(f"parity report: {report['stages']}")
    s = model.opt.fineSize
    if calls["instance_norm"] != stage_sites(model) * n or \
            calls["encode"] != [((1, s, s), 3, "cond")] * n:
        raise AssertionError(f"parity render: calls off the serving path "
                             f"({len(calls['instance_norm'])} IN, {calls['encode']})")
    expect_launches(launches, dict({k: 0 for k in launches}, encode_cond=n,
                                   instance_norm=len(stage_sites(model)) * n,
                                   reflect_pad_fwd=forward_pads(model) * n), "parity render")
    log(f"[parity report] {json.dumps(report['stages'])}; launches {launches}")

    # the converted G against pix2pixHD's module, both on the card
    sd = torch.load(os.path.join(weights, "latest_net_G.pth"), map_location="cpu",
                    weights_only=True)
    g = model.netG
    ref = pix2pixhd_format.GlobalGeneratorT(g.conv_in.weight.shape[1], 3,
                                            g.conv_in.weight.shape[0], g.n_downsampling,
                                            g.n_blocks).to(dev).eval()
    ref.load_state_dict(sd)
    convert_torch_checkpoint.load_pix2pixhd_into(model, sd, "G")
    x = torch.randn(1, g.conv_in.weight.shape[1], *CONVERT_HW,
                    generator=torch.Generator().manual_seed(34)).to(dev)
    with precision_scope(model), torch.no_grad():   # fp32: TF32 off for both
        want = ref(x).permute(0, 2, 3, 1)
        got = model.netG(x.permute(0, 2, 3, 1).contiguous())
    torch.cuda.synchronize()
    g_err = (got - want).abs().max().item()
    log(f"[convert] the converted G against pix2pixHD's module at "
        f"{CONVERT_HW[1]}x{CONVERT_HW[0]} fp32: max|diff| {g_err:.3g} (atol {CONVERT_ATOL})")
    if not g_err <= CONVERT_ATOL:
        raise AssertionError(f"converted G off the reference by {g_err}")
    del g, model, models, ref, sd, got, want
    torch.cuda.empty_cache()

    # bbox preprocessing against the dataset's own extraction
    records = preprocess_city_bboxes.main(["--dataroot", root, "--phase", "test"])
    os.remove(os.path.join(root, "test_bboxes.json"))   # later readers keep scanning
    want_records = extract_bbox_records(AlignedDataset(MaskToImageTestOptions(
        dataroot=root, resize_or_crop="none", gpu_ids=GPU_IDS)))
    if records != want_records or not records:
        raise AssertionError(f"preprocess_city_bboxes: {len(records)} records against "
                             f"{len(want_records)}")

    # the converted VGG19 read by the evaluators
    vgg_npz = os.path.join(tmp, "vgg_converted.npz")
    load_vgg_weights.main(["--pth", os.path.join(weights, "vgg19.pth"), "--out", vgg_npz])
    vsd = torch.load(os.path.join(weights, "vgg19.pth"), weights_only=True)
    vgg = networks.Vgg19Features()
    evaluate.load_vgg(vgg_npz, vgg)
    for (b, c), i in load_vgg_weights.TORCHVISION_CONV_INDICES.items():
        conv = getattr(vgg, f"conv{b}_{c}")
        if not (torch.equal(conv.weight, vsd[f"features.{i}.weight"])
                and torch.equal(conv.bias, vsd[f"features.{i}.bias"])):
            raise AssertionError(f"VGG19 conv{b}_{c} changed through the npz")
    log(f"[convert] {len(records)} bbox records equal extract_bbox_records; VGG19 through "
        "load_vgg_weights and evaluate.load_vgg bit for bit")
    results["tools_convert"] = dict(report=report["stages"], launches=launches,
                                    variants=variants, g_max_abs_diff=g_err,
                                    bbox_records=len(records))
    phase_seconds(34, "tools_convert", t0, results)
    return {"parity_report": {"launches": launches, "variants": variants}}


def phase_tools_export(tmp, results):
    """Phase 35: both stages exported on the card by tools/export_inference
    (mask2image: the flagship at fineSize 512; box2mask: full width at crop
    128; bs 1), saved, reloaded and rerun under cudnn_deterministic(): the
    graph's himan:: ops, the reloaded program's output against the eager
    forward's (bits, else the max |diff|), rows 3 and 4 launched as one
    eager forward launches them (held to the architecture), ms at bs 1 of
    each, the .pt2 bytes."""
    t0 = time.time()
    paths = {}
    rows = {}
    for stage, arch, fine in EXPORT_CASES:
        model, batch = export_inference.build(stage, 35, fine, 1, GPU_IDS, **arch)
        t = time.time()
        ep = export_inference.export(stage, model, batch)
        path = os.path.join(tmp, f"{stage}.pt2")
        nbytes = export_inference.save(ep, path)
        prog = export_inference.load(path).module()
        export_s = time.time() - t
        ops = kops.exported_ops(ep.graph_module)
        del ep
        encodes = [((1, fine, fine), 3)] if stage == "mask2image" else []
        with cudnn_deterministic(), torch.no_grad():
            runs = {}
            for who, fn in (("eager", lambda: model.inference(batch)), ("reloaded",
                                                                       lambda: prog(batch))):
                fn()
                zero_launches()
                with recording() as calls:
                    out = fn()
                torch.cuda.synchronize()
                variants = expect_path_launches(calls, read_launches(), stage_sites(model),
                                                encodes, forward_pads(model),
                                                f"export {stage} {who}")
                runs[who] = dict(fn=fn, out=out if isinstance(out, tuple) else (out,),
                                 launches=read_launches(), variants=variants)
            timing = interleaved_ms({who: r["fn"] for who, r in runs.items()},
                                    EXPORT_ITERS[stage], EXPORT_ROUNDS)
        expect_launches(runs["reloaded"]["launches"], runs["eager"]["launches"],
                        f"export {stage}: the reloaded program against eager")
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(runs["eager"]["out"], runs["reloaded"]["out"])]
        bits = all(same_bits(a, b) for a, b in zip(runs["eager"]["out"], runs["reloaded"]["out"]))
        if not bits and not max(diffs) <= MODEL_ATOL:
            raise AssertionError(f"export {stage}: reloaded output off eager by {diffs}")
        resolved = all(t["spread"] <= EXPORT_SPREAD for t in timing.values())
        rows[stage] = dict(bytes=nbytes, ops=ops, export_save_load_s=export_s, same_bits=bits,
                           max_abs_diff=max(diffs), ms=timing, ms_resolved=resolved,
                           launches=runs["reloaded"]["launches"])
        ms = ", ".join(f"{who} {t['median']:.3f} ms (rounds {min(t['rounds']):.3f}-"
                       f"{max(t['rounds']):.3f})" for who, t in timing.items())
        ratio = (f"reloaded / eager {timing['reloaded']['median'] / timing['eager']['median']:.3f}"
                 if resolved else f"unresolved (a spread over {EXPORT_SPREAD:.0%}): no ratio")
        log(f"[export {stage}] {nbytes} bytes, ops {ops}, export + save + load {export_s:.1f} s; "
            f"reloaded output {'bit for bit eager' if bits else f'max|diff| {max(diffs):.3g}'}; "
            f"bs 1, CUDA events, {EXPORT_ROUNDS} x {EXPORT_ITERS[stage]} calls: {ms}; {ratio}; "
            f"launches {runs['reloaded']['launches']}")
        paths[f"export_{stage}"] = {k: runs["reloaded"][k] for k in ("launches", "variants")}
        del model, batch, prog, runs
        os.remove(path)
        torch.cuda.empty_cache()
    results["tools_export"] = rows
    phase_seconds(35, "tools_export", t0, results)
    return paths


@contextlib.contextmanager
def tool_paths(what, paths):
    """Inside: every run of a train CLI held per step to its architecture
    (run_cli_checked), every evaluate and two-step demo run counted; each
    with the counters zeroed before and read after, summed into
    paths[f"{what}_{cli}"]."""
    origs = {m: m.main for m in (mask2image_train, box2mask_train, evaluate, two_step_demo)}

    def wrap(mod):
        def main(argv):
            name = f"{what}_{mod.__name__.rsplit('.', 1)[1]}"
            with mock.patch.object(mod, "main", origs[mod]):
                if mod in (mask2image_train, box2mask_train):
                    out = run_cli_checked(argv, mod, name)
                    launches, variants = out["launches"], out["variants"]
                else:
                    zero_launches()
                    out = origs[mod](argv)
                    torch.cuda.synchronize()
                    launches, variants = read_launches(), read_variants()
            add_paths(paths.setdefault(name, {"launches": {}, "variants": {}}), launches,
                      variants)
            return out
        return main

    with contextlib.ExitStack() as stack:
        for mod in origs:
            stack.enter_context(mock.patch.object(mod, "main", wrap(mod)))
        yield paths


def phase_tools_dynamics(tmp, results):
    """Phase 36: the procedural-world chain at full width, short:
    train_dynamics (the flagship, bf16, bs 16, fused resident step),
    train_dynamics_b2m, two_step_gallery, two_step_metrics over 8 paired
    scenes and train_dynamics_1024p (global stage, --load_pretrain,
    --niter_fix_global). Every train CLI run held per step to its
    architecture's launches (the loss groups 2 + 2) and per variant to the
    plans; every loss finite; the four *_passthrough metrics exactly 0 in
    every scene; each summary JSON written."""
    t0 = time.time()
    d = os.path.join(tmp, "dyn")
    paths, out = {}, {}
    gpu = ["--gpu_ids", GPU_IDS]
    b2m_world, b2m_ckpt = os.path.join(d, "world_b2m"), os.path.join(d, "ckpt_b2m")
    with tool_paths("dynamics", paths):
        out["dynamics"] = train_dynamics.main(DYN_ARGV + gpu + [
            "--dataroot", os.path.join(d, "world"), "--ckpt", os.path.join(d, "ckpt"),
            "--out", os.path.join(d, "dynamics")])
        out["dynamics_b2m"] = train_dynamics_b2m.main(DYN_B2M_ARGV + gpu + [
            "--dataroot", b2m_world, "--ckpt", b2m_ckpt,
            "--out", os.path.join(d, "dynamics_b2m")])
        out["two_step_gallery"] = two_step_gallery.main(DYN_GALLERY_ARGV + gpu + [
            "--world", b2m_world, "--ckpt", b2m_ckpt, "--out", os.path.join(d, "two_step")])
    zero_launches()
    metrics = two_step_metrics.main(gpu + ["--ckpt", b2m_ckpt, "--n_scenes",
                                           str(DYN_METRIC_SCENES),
                                           "--out", os.path.join(d, "two_step")])
    torch.cuda.synchronize()
    paths["dynamics_two_step_metrics"] = {"launches": read_launches(),
                                          "variants": read_variants()}
    with tool_paths("dynamics_1024p", paths):
        out["dynamics_1024p"] = train_dynamics_1024p.main(DYN_1024P_ARGV + gpu + [
            "--dataroot", os.path.join(d, "world_1024p"), "--ckpt", os.path.join(d, "ckpt_1024p"),
            "--out", os.path.join(d, "dynamics_1024p")])

    leaks = {k: [r[k] for r in metrics["rows"]] for k in PASSTHROUGH}
    if len(metrics["rows"]) != DYN_METRIC_SCENES or any(v != 0.0 for vs in leaks.values()
                                                        for v in vs):
        raise AssertionError(f"two_step_metrics: passthroughs {leaks}")
    finite = [out["dynamics"]["finite"], out["dynamics_b2m"]["finite"],
              *(s["finite"] for s in out["dynamics_1024p"]["stages"].values())]
    if not all(finite) or not all(np.isfinite([out["dynamics_b2m"]["miou_trained"],
                                               out["dynamics_b2m"]["miou_random_init"]])):
        raise AssertionError(f"dynamics: non-finite losses or metrics {finite}")
    images = {e: v["images"] for e, v in out["two_step_gallery"]["edits"].items()}
    if images != {e: 16 for e in two_step_gallery.EDITS}:
        raise AssertionError(f"two_step_gallery: {images}")
    for sub, name in (("dynamics", "summary.json"), ("dynamics_b2m", "summary_b2m.json"),
                      ("two_step", "summary.json"), ("dynamics_1024p", "summary.json")):
        if not os.path.exists(os.path.join(d, sub, name)):
            raise AssertionError(f"{sub}/{name} not written")
    log(f"[dynamics] metrics {json.dumps(metrics['metrics'])}; b2m mIoU random "
        f"{out['dynamics_b2m']['miou_random_init']:.4f} -> trained "
        f"{out['dynamics_b2m']['miou_trained']:.4f}; CLI paths {sorted(paths)}")
    results["tools_dynamics"] = dict(
        summaries=out, edit_metrics=metrics["metrics"],
        paths={k: v["launches"] for k, v in paths.items()})
    phase_seconds(36, "tools_dynamics", t0, results)
    return paths


@contextlib.contextmanager
def counted_steps():
    """Inside: every step ``tools/roofline_step.make_step`` hands out counts
    its calls -> [[model, steps], ...]."""
    runs, orig = [], roofline_step.make_step

    def make_step(opt, model, compute_dtype):
        step, state = orig(opt, model, compute_dtype)
        run = [model, 0]
        runs.append(run)

        def counted(state, batch):
            run[1] += 1
            return step(state, batch)
        return counted, state

    with mock.patch.object(roofline_step, "make_step", make_step):
        yield runs


def expect_recorded_launches(calls, launches, what):
    """Each recorded call of a wrapper launched its kernel once (the loss
    kernel: each term counted), and conv3x3_in_act none."""
    want = {k: len(calls[k]) for k in PLANNED + ("mse_to_scalar", "l1_to_scalar",
                                               "loss_group_bwd")}
    want["encode"] = len(image_encodes(calls))
    # a no-image encode (encode_cond's, or G's input without RGB) is recorded
    # as an encode call and launches on encode_cond's counter
    want["encode_cond"] = len(calls["encode"]) - want["encode"]
    want["conv3x3_in_act"] = 0
    expect_launches({k: launches[k] for k in want}, want, f"{what}, against its calls")


def flagship_bs32_calls(dev):
    """The calls one step of the full-size flagship (512x256, bs 32, the
    bf16 tier, masked RGB, VGG + FM: the tools' default config) makes of
    each kernel, held to the architecture's count."""
    args = argparse.Namespace(smoke=False, bs=FLAGSHIP_BS, dtype="bfloat16", gpu_ids=GPU_IDS)
    opt, model, batch, cdt = roofline_step.flagship(args)
    calls = step_calls_of(model, batch, cdt)
    expect_recorded(calls, per_step_of(model), opt, f"flagship step bs {FLAGSHIP_BS} bf16")
    del model, batch
    torch.cuda.empty_cache()
    return calls


def phase_tools_measure(tmp, dev, results):
    """Phase 37: the measurement tools at cut sizes (MEASURE_*), each with
    the counters zeroed before and read after; every report written. Each
    tool's distinct kernel calls, and those of one full-size bs-32 bf16
    flagship step (the size of the committed reports), against their plain
    versions on the variant the plan picks (check_recorded)."""
    t0 = time.time()
    d = os.path.join(tmp, "measure")
    specs, trace = os.path.join(d, "specs.json"), os.path.join(d, "trace")
    paths, out, errs = {}, {}, {}

    def worst(tag, recorded, seed):
        e, counts = check_recorded(recorded, dev, seed, tag)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        log(f"[{tag}] distinct calls checked {counts}; max|kernel - plain| {e}")

    def run(name, fn, argv, env=None, per_step=False, gpu=True):
        zero_launches()
        report = os.path.join(d, f"{name}.json")
        with recording() as calls, counted_steps() as steps, \
                mock.patch.dict(os.environ, env or {}):
            out[name] = fn(argv + (["--gpu_ids", GPU_IDS] if gpu else []) + ["--out", report])
        torch.cuda.synchronize()
        launches, variants = read_launches(), read_variants()
        expect_recorded_launches(calls, launches, f"tool {name}")
        expect_variants(calls, f"tool {name}")
        n = sum(k for _, k in steps)
        if per_step:
            want = {k: 0 for k in launches}
            for model, k in steps:
                for kind, v in per_step_of(model).items():
                    want[kind] += k * v
            expect_launches(launches, want, f"tool {name}, {n} train steps")
        if not os.path.exists(report):
            raise AssertionError(f"tool {name}: {report} not written")
        add_paths(paths.setdefault(f"tool_{name.split('#')[0]}", {"launches": {}, "variants": {}}),
                  launches, variants)
        log(f"[tool {name}] {n} flagship steps; launches {launches}")
        worst(f"tool {name}", {name: calls}, 200 + len(out))
        return launches

    run("bench_all", bench_all.main, MEASURE_ALL_ARGV)
    run("bench_ablate", bench_ablate.main, ["--smoke"],
        dict(MEASURE_ABLATE_ENV, HIMAN_ABLATE_ONLY="full,no_vgg"), per_step=True)
    run("bench_ablate#rest", bench_ablate.main, ["--smoke"],
        dict(MEASURE_ABLATE_ENV, HIMAN_ABLATE_ONLY="g_only,no_fm,g_vgg,d_only"))
    none = run("bench_convt", bench_convt.main, MEASURE_CONVT_ARGV)
    run("roofline_step", roofline_step.main, ["--collect", "--bench", "--iters", "2",
                                              "--specs", specs, "--trace_dir", trace,
                                              *MEASURE_STEP_ARGV], per_step=True)
    run("trace_attrib", trace_attrib.main, [trace, "10", "--steps", "1", *MEASURE_STEP_ARGV],
        per_step=True)
    run("byte_ledger", byte_ledger.main, ["--saved", "--trace", trace, "--steps", "1",
                                          "--specs", specs, *MEASURE_STEP_ARGV])
    run("profile_decode", profile_decode.main, [trace], gpu=False)
    oracle = run("bench_torch_oracle", bench_torch_oracle.main, MEASURE_ORACLE_ARGV)
    for name, launches in (("bench_convt", none), ("bench_torch_oracle", oracle)):
        expect_launches(launches, {k: 0 for k in launches}, f"tool {name} (no port kernel)")
    worst(f"flagship bs {FLAGSHIP_BS} bf16", {"step": flagship_bs32_calls(dev)}, 230)
    rates = out["bench_torch_oracle"]["h100_img_per_s"]
    rl = out["roofline_step"]
    if not all(np.isfinite([rl["measured_step_ms"], rl["attainable_step_ms"],
                            *(v for t in rates.values() for v in t.values())])):
        raise AssertionError(f"tools_measure: non-finite {rl['measured_step_ms']} {rates}")
    results["tools_measure"] = dict(
        bench_all=out["bench_all"]["configs"],
        bench_ablate=out["bench_ablate"]["variants"] + out["bench_ablate#rest"]["variants"],
        bench_convt=out["bench_convt"]["rows"],
        roofline_step={k: rl[k] for k in ("measured_step_ms", "attainable_step_ms",
                                          "headroom_pct", "conv_standalone_ms",
                                          "nonconv_bound_ms", "unclassified_pct")},
        trace_attrib={k: out["trace_attrib"][k] for k in ("device_ms_per_step",
                                                          "unclassified_pct",
                                                          "unclassified_kernels")},
        oracle=rates, paths={k: v["launches"] for k, v in paths.items()}, max_err=errs)
    log(f"[tools_measure] roofline {results['tools_measure']['roofline_step']}; oracle {rates}")
    phase_seconds(37, "tools_measure", t0, results)
    return paths


# phase 38: each train path's step on the card against the same step on the
# CPU, at full width; the 1024p step cut to one LocalEnhancer at 512x256
GRAD_STEP_HW = STEP_HW       # the flagship and --instance_feat steps (512x256)
GRAD_LOCAL_HW = STEP_HW      # the 1024p step's LocalEnhancer (its trunk at 256x128)
GRAD_B2M_BS = 2              # a box2mask batch with a null-class (background) box
GRAD_SEED = 380
# ROADMAP C.14, open: the bf16 tier's Encoder gradient. Each instance's
# feature gradient is the sum of G's input gradient over its pixels, which
# cancels to 0.03-3 % of the sum of its magnitudes; the bf16 step's
# per-pixel gradient is several % off the fp32 one, so E's bf16 gradient
# misses the bf16 bars (E.conv_out.weight at cosine 0.57 at 512x256). Path
# c's bf16 misses must be E's, and some must show, or the entry is stale.
BF16_KNOWN_MISSES = {"c instance_feat": "E."}


def _grad_paths():
    """(name, options of a gpu_ids and option overrides, batch on a device,
    the card's nudge) of phase 38's train paths."""
    def m2i(**arch):
        return lambda g, **kw: MaskToImageTrainOptions(gpu_ids=g, **arch, **kw)
    return (
        ("a flagship", m2i(**ARCH),
         lambda d: encode_inputs(1, *GRAD_STEP_HW, d, seed=GRAD_SEED), "image"),
        ("b 1024p LocalEnhancer", m2i(**LOCAL_G, **LOCAL_D),
         lambda d: encode_inputs(1, *GRAD_LOCAL_HW, d, seed=GRAD_SEED + 1), "image"),
        ("c instance_feat", m2i(**FEAT, **ARCH),
         lambda d: encode_inputs(1, *GRAD_STEP_HW, d, seed=GRAD_SEED + 2), "image"),
        ("d box2mask",
         lambda g, **kw: BoxToMaskTrainOptions(gpu_ids=g, lambda_ctx_neg=5.0, **B2M_ARCH, **kw),
         lambda d: b2m_batch(GRAD_B2M_BS, d, seed=GRAD_SEED + 3), "params"),
    )


def channels_last_view_pool(x):
    """``nnops.avg_pool_3x3s2`` before the C.12 repair: AvgPool2d on the
    channels_last view of the NHWC tensor, whose input gradient is wrong on
    the card (reports/torch_r13/c12_oracle/pool_grad.py)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1,
                        count_include_pad=False).permute(0, 2, 3, 1).contiguous()


def _pre_repair_control(name, card, model16, batch, nudge, ref):
    """Path ``name``'s check with the pool as it was before the C.12 repair
    on the card, fp32 (``check_step`` builds its bar from the card's spread
    under that pool) and bf16, against the same CPU step ``ref``: both must
    miss (G's tensors among them), or the bars could not see C.12."""
    with mock.patch.object(nnops, "avg_pool_3x3s2", channels_last_view_pool):
        rep, ref_grads = grad_audit.check_step(card, None, batch, None, nudge, ref=ref)
        bf = grad_audit.check_bf16(model16, batch, ref_grads)
    out = {"fp32_over_bar": rep["misses"], "bf16_over_bar": bf["misses"],
           "fp32_bar": rep["bar"], "fp32_worst_max_rel": rep["worst_max_rel"],
           "fp32_worst_flips": rep["worst_flips"], "fp32_worst_rel_l2": rep["worst_rel_l2"],
           "bf16_lowest_cos": bf["worst_cos"], "bf16_worst_flips": bf["worst_flips"],
           "bf16_worst_norm": bf["worst_norm"]}
    log(f"[grads vs cpu] control, {name} with the pre-repair pool: fp32 "
        f"{len(rep['misses'])} of {rep['tensors']} tensors over its bar {rep['bar']} (largest "
        f"max|diff|/max|g| {rep['worst_max_rel']}, flipped {rep['worst_flips']}, "
        f"||diff||/||g|| {rep['worst_rel_l2']}); bf16 {len(bf['misses'])} (lowest cosine "
        f"{bf['worst_cos']}, flipped {bf['worst_flips']}, | ||g16|| / ||g|| - 1 | "
        f"{bf['worst_norm']})")
    if not all(any(k.startswith("G.") for k in out[f"{t}_over_bar"]) for t in ("fp32", "bf16")):
        raise AssertionError(f"phase 38: the bars do not see the pre-repair pool on {name}: "
                             f"{out}")
    return out


def _on_cpu(batch):
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}


def phase_grads_vs_cpu(dev, results):
    """Phase 38, gradients against the CPU: each train path's one
    make_train_step step on the card (fp32, TF32 off, the hand-written
    kernels) against the same step on the CPU (fp32, the plain versions,
    another summation order in every op) from the same parameters (copied)
    and batch, no dropout (tools/grad_audit.check_step): the losses and
    every G, D and E parameter's gradient, per tensor max |diff| / max |g|
    and the flipped-sign share within the path's bar (grad_audit.bar_of:
    SPREAD_FACTOR x the card's own largest spread over two more card runs,
    the same step again and one with its image, or box2mask's parameters,
    nudged one ulp, within the floors and caps), and ||diff|| / ||g||
    within REL_L2_BAR; then the bf16 tier's gradients on the card against
    the same CPU step, per tensor within BF16_COS, BF16_FLIPS and BF16_NORM
    (check_bf16), but for the known misses of BF16_KNOWN_MISSES, which must
    show. Paths: a, the flagship (num_D 2, VGG19, LSGAN + FM +
    VGG); b, the 1024p LocalEnhancer (one enhancer, num_D 3, the trunk at
    ngf 64); c, --instance_feat (the Encoder through segment_mean_2d); d,
    box2mask (the two-stream G, the layout D); e, the serving forwards
    (GlobalGenerator and box2mask inference at bs 1, outputs only). The
    DP, resident and remat steps are held bit-equal on the card to the
    single step (phases 29 and 31) and need no step of their own here. Any
    miss fails the phase. A control: paths a and b again on the card with
    the pool as it was before the C.12 repair must miss both the fp32 bar
    (built anew from the card's spread under that pool) and the bf16
    bars."""
    t0 = time.time()
    out, misses = {}, {}
    for name, opt_of, batch_of, nudge in _grad_paths():
        t = time.time()
        card, cpu = create_model(opt_of(GPU_IDS)), create_model(opt_of("-1"))
        model16 = create_model(opt_of(GPU_IDS, dtype="bfloat16"))
        grad_audit.copy_params(card, cpu)
        grad_audit.copy_params(card, model16)
        batch = batch_of(dev)
        t_build = time.time() - t
        rep, ref = grad_audit.check_step(card, cpu, batch, _on_cpu(batch), nudge)
        t_check = time.time() - t - t_build
        bf = grad_audit.check_bf16(model16, batch, ref)
        w, f, l2, bar = rep["worst_max_rel"], rep["worst_flips"], rep["worst_rel_l2"], rep["bar"]
        log(f"[grads vs cpu] {name}: {rep['tensors']} tensors; largest max|diff|/max|g| "
            f"{w[0]:.3g} ({w[1]}) against the bar {bar['max_rel']:.3g}; largest "
            f"flipped-sign share {f[0]:.3g} ({f[1]}) against the bar {bar['flips']:.3g}; largest "
            f"||diff||/||g|| {l2[0]:.3g} ({l2[1]}) against {bar['rel_l2']}; the card's own "
            f"spread {rep['spread']}; losses max rel {max(rep['loss_rel'].values()):.3g}; bf16: "
            f"lowest cosine {bf['worst_cos'][0]:.4f} ({bf['worst_cos'][1]}) against "
            f"{bf['bar_cos']}, largest flipped-sign share {bf['worst_flips'][0]:.3g} "
            f"({bf['worst_flips'][1]}) against {bf['bar_flips']}, largest | ||g16|| / ||g|| - 1 | "
            f"{bf['worst_norm'][0]:.3g} ({bf['worst_norm'][1]}) against {bf['bar_norm']}"
            f"; misses {rep['misses']} / bf16 {bf['misses']}; models {t_build:.1f} s, "
            f"card x3 + cpu {t_check:.1f} s (the cpu step {rep['ref_step_s']:.1f} s)")
        out[name] = {"fp32": {k: v for k, v in rep.items() if k != "per_tensor"},
                     "bf16": {k: v for k, v in bf.items() if k != "per_tensor"},
                     "per_tensor": {k: {**v, **{f"bf16_{m}": bf["per_tensor"][k][m]
                                               for m in ("cos", "flips", "norm_ratio")}}
                                    for k, v in rep["per_tensor"].items()},
                     "models_s": t_build, "card_and_cpu_s": t_check}
        prefix = BF16_KNOWN_MISSES.get(name)
        known = [k for k in bf["misses"] if prefix and k.startswith(prefix)]
        bf16_misses = [k for k in bf["misses"] if k not in known]
        if prefix and not known:
            bf16_misses.append(f"the known misses {BF16_KNOWN_MISSES[name]}* do not show "
                               "(ROADMAP C.14 repaired?)")
        out[name]["bf16_known_misses"] = known
        if rep["misses"] or bf16_misses:
            misses[name] = {"fp32": rep["misses"], "bf16": bf16_misses}
        if name[0] in "ab":
            out[f"control {name[0]}: the pre-repair pool"] = _pre_repair_control(
                name, card, model16, batch, nudge, (rep["ref_losses"], ref))
        del card, cpu, model16, ref
        torch.cuda.empty_cache()
    serving = (
        ("e serving GlobalGenerator", lambda g: MaskToImageTestOptions(gpu_ids=g, **ARCH),
         lambda d: encode_inputs(1, *GRAD_STEP_HW, d, seed=GRAD_SEED + 4), MODEL_ATOL),
        ("e serving box2mask",
         lambda g: BoxToMaskTestOptions(gpu_ids=g, **{**B2M_DEPTH, **B2M_ARCH}),
         lambda d: b2m_batch(1, d, seed=GRAD_SEED + 5), B2M_PROBS_ATOL),
    )
    for name, opt_of, batch_of, atol in serving:
        card, cpu = create_model(opt_of(GPU_IDS)), create_model(opt_of("-1"))
        grad_audit.copy_params(card, cpu)
        batch = batch_of(dev)
        with precision_scope(card):
            got = card.inference(batch)
        with precision_scope(cpu):
            want = cpu.inference(_on_cpu(batch))
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        diff = max(float((a.float().cpu() - b.float()).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        log(f"[grads vs cpu] {name}: outputs max|card - cpu| {diff:.3g} (bar {atol}), "
            f"finite {finite}")
        out[name] = {"max_abs_diff": diff, "bar": atol}
        if not finite or diff > atol:
            misses[name] = diff
        del card, cpu
        torch.cuda.empty_cache()
    results["grads_vs_cpu"] = dict(paths=out, floors=grad_audit.FLOORS, caps=grad_audit.CAPS,
                                   rel_l2_bar=grad_audit.REL_L2_BAR,
                                   spread_factor=grad_audit.SPREAD_FACTOR)
    phase_seconds(38, "grads_vs_cpu", t0, results)
    if misses:
        raise AssertionError(f"phase 38, gradients against the CPU: misses {misses}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true", help="add a torch.profiler table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    results = {"card": card}
    t0 = time.time()
    phase_build()
    phase_kernels(dev, results)
    phase_train_kernels(dev, results)
    phase_conv_in(dev, results)
    phase_b2m_kernels(dev, results)
    local_table = phase_local_kernels(dev, results)
    with tempfile.TemporaryDirectory() as tmp:
        sites, out_shape = phase_serving(tmp, results)
        cli_launches, cli_calls, cli_variants = phase_train_cli(tmp, results)
        bf16_launches = phase_train_cli_bf16(tmp, results)
        roofline_launches = phase_roofline(tmp, results)
        b2m_launches, b2m_variants, b2m_serve_launches, b2m_serve_variants = phase_b2m_cli(
            tmp, results)
        two_step_launches, two_step_variants = phase_two_step_cli(tmp, results)
        phase_two_step_pipeline(tmp, dev, results)
        eval_launches, eval_variants = phase_evaluate_cli(tmp, results)
        local_launches, local_variants, local_serve_launches, local_serve_variants = \
            phase_local_cli(tmp, dev, results)
        feat_launches, feat_variants = phase_feat_cli(tmp, dev, results)
        m2i_ref = (cli_variants, results["train_cli"]["steps"])
        b2m_ref = (b2m_variants, results["box2mask_cli"]["train"]["steps"])
        data_paths = {**phase_resident_cli(tmp, results, m2i_ref),
                      **phase_resident_b2m_cli(tmp, results, b2m_ref),
                      **phase_dropout(tmp, dev, results, m2i_ref)}
        phase_data_measure(tmp, dev, results)
        par_launches, par_variants = phase_parallel(tmp, dev, results)
        phase_parallel_clis(tmp, results)
        tools_run = {**phase_tools_convert(tmp, dev, results), **phase_tools_export(tmp, results),
                     **phase_tools_dynamics(tmp, results),
                     **phase_tools_measure(tmp, dev, results)}
        data_paths.update(phase_grain(tmp, dev, results, m2i_ref, b2m_ref))
    phase_resident_scale(dev, results)
    kernels = phase_main_path_kernels(dev, sites, out_shape, results)
    phase_forward_sites(dev, results)
    phase_model(dev, results)
    step_calls = phase_train_step(dev, results)
    phase_train_step_bf16(dev, results)
    phase_b2m_step(dev, results)
    phase_local_step(dev, results)
    phase_feat_step(dev, results)
    remat_launches, remat_variants = phase_remat(dev, results)
    phase_debug_nans(dev, results)
    kernels += phase_train_main_path_kernels(dev, cli_launches, cli_calls, cli_variants,
                                             step_calls, results)
    # every kernel's launches per variant on each main path
    path_variants = {"serving": results["serving"]["all_variants"], "train": cli_variants,
                     "train_bf16_pool": results["train_cli_bf16"]["variants"],
                     "roofline": results["roofline"]["all_variants"],
                     "box2mask_train": b2m_variants, "box2mask_serving": b2m_serve_variants,
                     "two_step": two_step_variants, "evaluate": eval_variants,
                     "train_1024p": local_variants, "serving_1024p": local_serve_variants,
                     **feat_variants, **{p: r["variants"] for p, r in data_paths.items()},
                     **par_variants, **remat_variants,
                     **{p: r["variants"] for p, r in tools_run.items()}}
    path_launches = {"serving": results["launches"], "train": cli_launches,
                     "train_bf16_pool": bf16_launches, "roofline": roofline_launches,
                     "box2mask_train": b2m_launches, "box2mask_serving": b2m_serve_launches,
                     "two_step": two_step_launches, "evaluate": eval_launches,
                     "train_1024p": local_launches, "serving_1024p": local_serve_launches,
                     **feat_launches, **{p: r["launches"] for p, r in data_paths.items()},
                     **par_launches, **remat_launches,
                     **{p: r["launches"] for p, r in tools_run.items()}}
    kernels.append(encode_pad0_row(local_table, local_variants, local_serve_variants))
    kernels.append(conv_in_main_path_row(dev, results))
    kernels.append(conv_in_fp32_row(results, path_variants))
    # launches per variant on the main path of the row (the plan functions'
    # split, checked in phases 6 and 11)
    for row in kernels:
        if row["name"] == "instance_norm":
            row["variants"] = results["serving"]["variants"]
        if row["name"] in ("instance_norm_bwd", "reflect_pad_bwd", "reflect_pad_fwd"):
            row["variants"] = cli_variants[row["name"]]
        if row["name"] == "conv3x3_in_act":
            row["variants"] = results["roofline"]["variants"]
    for row in kernels:
        name = row["name"]
        if name == "conv3x3_in_act (fp32)":
            continue
        if name.startswith("encode ("):    # the encode kernel's pad variants, a row each
            row["launches_by_path"] = {p: v["encode"][row["variant"]]
                                       for p, v in path_variants.items()}
            continue
        row["launches_by_path"] = {p: v[name] for p, v in path_launches.items()}
        if name in ("mse_to_scalar", "l1_to_scalar"):
            row["terms_by_path"] = row["launches_by_path"]
            row["launches_by_path"] = {p: v[name]["group"] for p, v in path_variants.items()}
    phase_grads_vs_cpu(dev, results)
    if args.profile:
        phase_profile(dev, results)
        phase_profile_train(dev, results)
        phase_profile_train(dev, results, bf16=True)
        phase_profile_train(dev, results, b2m=True)
        phase_profile_train(dev, results, local=True)
        phase_profile_two_step(dev, results)
    results["kernels"] = kernels
    results["seconds"] = time.time() - t0
    log(f"[done] {results['seconds']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

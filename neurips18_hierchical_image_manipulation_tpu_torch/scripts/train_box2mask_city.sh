#!/bin/bash
# Canonical structure-generator training config (SURVEY.md C27 equivalent).
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.box2mask_train \
  --name box2mask_city \
  --dataroot ./datasets/cityscapes \
  --label_nc 35 --fineSize 128 --contextMargin 2.0 \
  --ngf 64 --n_downsample_global 3 --n_blocks_global 4 \
  --batchSize 32 --niter 100 --niter_decay 100 \
  --dtype bfloat16 "$@"

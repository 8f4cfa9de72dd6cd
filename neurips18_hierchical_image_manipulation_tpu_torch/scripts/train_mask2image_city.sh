#!/bin/bash
# Canonical image-generator training config: Cityscapes 512x256 wide format.
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_train \
  --name mask2image_city \
  --dataroot ./datasets/cityscapes \
  --label_nc 35 --loadSize 512 --fineSize 256 --resize_or_crop scale_width \
  --ngf 64 --n_downsample_global 4 --n_blocks_global 9 \
  --num_D 2 --n_layers_D 3 \
  --batchSize 8 --niter 100 --niter_decay 100 \
  --dtype bfloat16 "$@"

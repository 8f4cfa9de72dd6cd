#!/bin/bash
# Hi-res (1024x512) coarse-to-fine stage: LocalEnhancer on top of the
# trained global generator, global trunk frozen for the first 20 epochs
# (pix2pixHD's two-stage recipe; SURVEY C15 LocalEnhancer + niter_fix_global).
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_train \
  --name mask2image_city_1024p \
  --dataroot ./datasets/cityscapes \
  --netG local --ngf 32 --n_local_enhancers 1 --n_blocks_local 3 \
  --label_nc 35 --loadSize 1024 --fineSize 512 --resize_or_crop scale_width \
  --niter_fix_global 20 \
  --num_D 3 --n_layers_D 3 \
  --batchSize 4 --niter 50 --niter_decay 50 \
  --load_pretrain ./checkpoints/mask2image_city \
  --dtype bfloat16 "$@"

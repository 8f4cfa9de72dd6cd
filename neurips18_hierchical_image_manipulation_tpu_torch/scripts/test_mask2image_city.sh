#!/bin/bash
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.mask2image_test \
  --name mask2image_city --dataroot ./datasets/cityscapes \
  --label_nc 35 --loadSize 512 --fineSize 256 --resize_or_crop scale_width \
  --which_epoch latest --how_many 50 "$@"

#!/bin/bash
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.box2mask_test \
  --name box2mask_city --dataroot ./datasets/cityscapes \
  --label_nc 35 --fineSize 128 --which_epoch latest --how_many 50 "$@"

#!/bin/bash
# Joint two-step manipulation demo: add/remove/swap object edits.
python -m neurips18_hierchical_image_manipulation_tpu_torch.cli.two_step_demo \
  --b2m_name box2mask_city --m2i_name mask2image_city \
  --dataroot ./datasets/cityscapes --edit add --cls 26 "$@"

"""himan in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of ``neurips18_hierchical_image_manipulation_tpu`` (the JAX
package, which stays the reference). It covers the mask2image stage:
serving, ``cli/mask2image_test.py`` -> ``models/pix2pixhd.py``
(``encode_input`` + ``inference``) -> ``models/networks.py``
(``GlobalGenerator``); and training, ``cli/mask2image_train.py`` ->
``train/loop.py`` -> ``train/steps.make_train_step`` ->
``Pix2PixHDModel.losses`` (GlobalGenerator, ``MultiscaleDiscriminator``,
``Vgg19Features``, the ``losses/`` package) with Adam (``train/state.py``).

Layout: public functions take and return NHWC tensors like the JAX
package; convolutions run on the channels_last NCHW view of the same
memory. Kernels: every TPU kernel on the path is a hand-written CUDA
kernel under ``csrc/`` with its wrapper and plain PyTorch version under
``kernels/``. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.

This package imports no JAX and no module of the JAX package.
"""

__version__ = "0.1.0"

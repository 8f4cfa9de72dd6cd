"""A third model for the tests: pix2pixHD's reference and counts under
another name, in a directory of its own that the registry searches only when
it is told to. It shows that a model enters the benchmark as one new module."""

from port_bench.reference.pix2pixhd import (Reference, d_input, g_layers,  # noqa: F401
                                            linear, vgg_taps)

MODEL = "pix2pixHD-twin"

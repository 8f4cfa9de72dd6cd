"""The benchmark's own tests: on the CPU at tiny widths (the port's plain
versions of its kernels), and, marked ``cuda``, on a card.

    python -m pytest port_bench/tests            # the CPU tests
    python -m pytest -m cuda port_bench/tests    # on a machine with a card
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips without one (decided here, never while a
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    here, at run time, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m cuda tests/)")
    return torch.device("cuda", 0)


@pytest.fixture
def restore_torch_precision():
    """The port's create_model sets process-wide TF32 switches."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

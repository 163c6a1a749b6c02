"""Fixtures of the benchmark's tests. Tests that need the card are marked
``cuda`` and take the ``cuda_card`` fixture, which decides at run time."""

import pytest


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")

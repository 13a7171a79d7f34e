"""The benchmark's tests: `cuda`-marked tests take the `card` fixture,
which skips them where no card is present (decided when the test runs,
never while a module is imported)."""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")

"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the root of a checkout. Tests marked `card` need a CUDA card and skip
without one, deciding inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips on a machine without one')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (TF32 and the program\'s kernels '
                    'exist only there)')
    return torch.device('cuda', 0)

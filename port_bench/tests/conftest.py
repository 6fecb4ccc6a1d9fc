"""The benchmark's own tests. They run on the CPU; a test that needs a
CUDA card takes the ``card`` fixture, which skips it where there is none
(decided when the test runs, never while modules are imported).

    python -m pytest port_bench/tests -q            # here
    python -m pytest port_bench/tests -q -m card    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

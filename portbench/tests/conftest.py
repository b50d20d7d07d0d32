"""The benchmark's own tests: ``pytest portbench/tests`` from the root.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is found (decided when
the test runs, never at import).
"""
import json

import pytest

from portbench_support import TINY


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A cell of ``BENCHMARK.json`` with the 32x32 configuration the CPU
    tests run (``tiny.json``): returns ``make(cell_name)``."""
    from portbench.harness import common

    def make(name):
        cell = common.cell_for(name)
        with open(TINY) as fh:
            cell.config = json.load(fh)
        return cell

    return make

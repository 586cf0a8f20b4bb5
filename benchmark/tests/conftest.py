"""The harness's own tests. Run them with

    python -m pytest benchmark/tests -q

on the CPU (every test but the `card` ones, at a tiny size with the
program's plain kernels), and on the card, where the `card` tests run a
real cell too. Whether a card is present is decided inside a fixture,
never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.device("cuda:0")


@pytest.fixture
def cards4():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("fewer than 4 CUDA cards: this test runs on four")
    return [torch.device(f"cuda:{i}") for i in range(4)]


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory):
    from benchmark.tests import tiny

    return tiny.folder(str(tmp_path_factory.mktemp("bench")))

"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests that need the card carry the ``card`` marker and decide inside the
test whether there is one; on the CPU they skip. On the card:
``python -m pytest portbench/tests -q -m card``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    from .tiny import count_cpu_launches, make_root

    torch.set_num_threads(2)
    count_cpu_launches(monkeypatch)
    return make_root(str(tmp_path))

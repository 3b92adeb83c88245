"""The temporal BLSTM U-Net on a device mesh: one float64 step against the
one-device step (tests/test_torch_parallel_zoo.py)."""

import pytest

from test_torch_parallel_zoo import HELD, check_on_meshes, step_settings


@pytest.fixture(autouse=True, scope="module")
def _settings():
    # float64 products of width 1728, which threads speed up (the
    # others' 15 x 15 convolutions are bound by memory)
    with step_settings(4):
        yield


@pytest.mark.parametrize("name", HELD["test_torch_parallel_zoo_blstm"])
def test_zoo_step_on_a_mesh_is_the_one_device_step(name):
    check_on_meshes(name)

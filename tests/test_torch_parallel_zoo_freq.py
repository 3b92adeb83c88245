"""The freq U-Nets, the large-kernel U-Net and the BLUnet on a device mesh:
one float64 step against the one-device step
(tests/test_torch_parallel_zoo.py)."""

import pytest

from test_torch_parallel_zoo import HELD, check_on_meshes, step_settings


@pytest.fixture(autouse=True, scope="module")
def _settings():
    with step_settings(1):
        yield


@pytest.mark.parametrize("name", HELD["test_torch_parallel_zoo_freq"])
def test_zoo_step_on_a_mesh_is_the_one_device_step(name):
    check_on_meshes(name)

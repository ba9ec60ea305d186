"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-card hardware is not available in CI; sharding tests emulate an
8-device mesh on CPU (the analogue of the reference testing its CUDA
programs against serial C on one box, test/diff.sh).

Tests that need the card carry the ``gpu`` marker and the ``gpu``
fixture, which skips them where JAX runs on the CPU.  Selecting them
(``python -m pytest tests/ -m gpu``) leaves JAX on its default backend,
so on a machine with a GPU they run there.
"""

import os

import pytest


def pytest_configure(config):
    # Before any test module imports jax.
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # f64 available for exact-vs-C-double oracle comparisons.
    os.environ.setdefault("JAX_ENABLE_X64", "1")


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests/ -m gpu` "
                    "on a machine with one")
    return dev


@pytest.fixture
def eight_devices():
    """The 8-device mesh's devices; skips when fewer are visible."""
    import jax

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest)")
    return devices

"""Test harness config.

By default the tests run on the CPU backend with 8 virtual devices, so
sharding semantics (psum grads, sharded grid query) are testable without a
card. When ``JAX_PLATFORMS`` names the GPU (``cuda`` or ``gpu``) the backend is
left alone: that is how the card-only tier runs,

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Card-only tests carry the ``gpu`` marker and take the ``gpu_device`` fixture,
which skips them when JAX finds no GPU. The decision is made inside the
fixture, never at import, so every xdist worker collects the same tests.
"""

import os

_platforms = os.environ.get("JAX_PLATFORMS", "")
if not any(p in _platforms for p in ("cuda", "gpu")):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run on the card with "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture(scope="session")
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, JAX has {dev.platform} "
                    "(JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
    return dev

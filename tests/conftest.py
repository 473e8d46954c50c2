"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count).  Both variables are set before
anything imports jax.  Tests that need the GPU carry the `gpu` marker and
skip here; chip_smoke.py runs those paths on the card.
"""

import os

_FLAG = "--xla_force_host_platform_device_count=8"

os.environ["JAX_PLATFORMS"] = "cpu"
_xla = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                if "xla_force_host_platform_device_count" not in f)
os.environ["XLA_FLAGS"] = (_xla + " " + _FLAG).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_mesh():
    import jax
    assert jax.default_backend() == "cpu", (
        f"tests must run on the virtual CPU mesh, got "
        f"{jax.default_backend()!r}")
    assert len(jax.devices()) >= 8, (
        f"need 8 virtual devices, have {len(jax.devices())}")
    yield

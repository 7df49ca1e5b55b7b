"""Test configuration.

Tests run on the CPU backend with 8 virtual devices unless JAX_PLATFORMS
says otherwise, so sharding logic is exercised without accelerators (the
standard JAX trick; SURVEY.md §4). Tests that need a GPU carry the `gpu`
marker and take the `gpu_device` fixture, which skips them when there is
none; `python chip_smoke.py` runs them on the card.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REFERENCE_ROOT = "/root/reference"


def reference_path(*parts):
    return os.path.join(REFERENCE_ROOT, *parts)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("card-only test: JAX finds no GPU")

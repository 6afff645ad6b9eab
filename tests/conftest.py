"""Test harness: force an 8-device virtual CPU mesh before jax initialises.

The tests run on the CPU; multi-device paths are validated there via
``xla_force_host_platform_device_count``, and the platform is pinned
in-process.  Tests that need the GPU take the ``gpu`` fixture, which
skips them when no GPU is present (run them on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``)."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

# the CPU unless the caller names platforms (the GPU tests run on the card
# with JAX_PLATFORMS=cuda,cpu)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest

from mcmc_colorer_tpu.graph.generate import erdos_renyi


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.  Tests
    that take it carry the ``gpu`` marker."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu tests/)")
    return devs[0]


@pytest.fixture(scope="session")
def small_er():
    """ER(60, 0.2): small but dense enough to have conflicts at init."""
    return erdos_renyi(60, 0.2, seed=7)


@pytest.fixture(scope="session")
def medium_er():
    return erdos_renyi(500, 0.05, seed=3)

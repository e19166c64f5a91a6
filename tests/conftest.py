"""Test harness config: run on a faked 8-device CPU mesh (SURVEY.md §4).

Must run before anything imports jax. With ICPX_TEST_GPU=1 the suite
runs on the default backend instead, which is how the `gpu`-marked
tests run on a machine with a card:

    ICPX_TEST_GPU=1 python -m pytest -m gpu tests/
"""

import os

_ON_GPU = os.environ.get("ICPX_TEST_GPU") == "1"

if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    # backends initialize lazily, so this (before first device use)
    # puts the whole session on the faked 8-device CPU mesh
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
if not _ON_GPU:
    assert jax.device_count() == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU. Decided here,
    at test time, never while a module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: ICPX_TEST_GPU=1 pytest -m gpu")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound live compiled-executable state across the (200+ test) suite.

    With the full suite's accumulated executables, XLA's CPU backend
    segfaults inside backend_compile on a later module's (individually
    healthy) jit — reproducibly at the same suite position, never in
    isolation. Clearing jax's caches at module boundaries bounds that
    state; cross-module cache reuse is minimal anyway (different shapes).
    """
    yield
    jax.clear_caches()

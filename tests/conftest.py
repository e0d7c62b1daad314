"""Test configuration.

Runs everything on a virtual 8-device CPU mesh (the standard JAX trick for
testing multi-device sharding on one host; SURVEY.md §4.6) and enables x64
so numerical parity checks against float64 numpy oracles are meaningful.

The CPU is the only platform unless ``JAX_PLATFORMS`` names it among
others: ``JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/`` also
opens the GPU for the ``gpu``-marked tests, while the CPU stays the
default device.
"""

import os

platforms = os.environ.get("JAX_PLATFORMS", "")
if "cpu" not in platforms.split(","):
    platforms = "cpu"
os.environ["JAX_PLATFORMS"] = platforms
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_enable_x64", True)
if platforms != "cpu":
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
else:
    assert jax.default_backend() == "cpu", jax.default_backend()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """The first GPU, for tests marked ``gpu``; skips where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cpu,cuda)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated XLA-CPU compiler state.

    Full-suite runs (~157 tests, hundreds of compiled programs) have twice
    segfaulted inside `backend_compile_and_load` around the 140th test; the
    same tests pass in isolation and in split runs. Clearing JAX's
    compilation caches at module boundaries bounds the compiler state that
    triggers it. (If a full run still crashes, split it:
    `pytest tests/test_[a-m]*.py` then `pytest tests/test_[n-z]*.py`.)
    """
    yield
    jax.clear_caches()

"""Test configuration.

With ``JAX_PLATFORMS`` unset or ``cpu``, force the CPU backend with 8 virtual
devices so the multi-device sharding paths are testable without GPUs
(SURVEY.md §4.3).  Must run before anything imports jax.

Tests marked ``gpu`` need a GPU; the ``_gpu_marker`` fixture skips them when
JAX finds none.  Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

CPU_RUN = os.environ.get("JAX_PLATFORMS", "") in ("", "cpu")
if CPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="session")
def _cpu_devices():
    """The CPU run's device layout: 8 virtual CPU devices."""
    if CPU_RUN:
        assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
        assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test when JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {platform}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_program_accumulation():
    """Clear JAX's compiled-executable caches at every module boundary.

    The full suite in ONE process deterministically segfaulted the XLA:CPU
    compiler near the end (a fresh compile died inside
    ``backend_compile_and_load``), while any ~60-test subset passed,
    including the crashing tests standalone: the trigger is TOTAL
    accumulated compiled programs in the process, not any specific test.
    Clearing at module boundaries bounds the live-executable count;
    session-scoped jitted callables (e.g. the memoized SPMD programs)
    transparently recompile on next use."""
    yield
    jax.clear_caches()

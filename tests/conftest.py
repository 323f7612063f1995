"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device sharding tests exercise the halo-exchange path without
several cards (SURVEY.md §4.3); numeric tests need complex128 for the
reference's 1e-12 tolerances.

The platform is JAX_PLATFORMS when set, else the CPU: tests marked `gpu`
run only with a GPU platform in the list (JAX_PLATFORMS=cuda,cpu) and skip
otherwise, decided by the `gpu_device` fixture.

NOTE: jax may already be imported by the interpreter before this module
runs, so we use jax.config.update (effective until backends initialize).
"""
import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX found {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(4302529)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_state():
    """Drop compiled-executable state between test modules.

    The full suite compiles ~250+ XLA:CPU programs in one process;
    beyond roughly the 200-program mark the process starts segfaulting
    at RANDOM later points (measured r5: three crashes at three
    different sites — a disk-cache executable serialization, a
    backend_compile, an EAGER einsum dispatch — while every <=130-test
    subset passes and the r4 suite, at 194 tests, sat just under the
    threshold). Clearing the aot_call executable cache and jax's
    internal caches per module keeps the live-executable population
    bounded; costs some per-module recompilation."""
    yield
    from tpu_multigrid.utils.compile import clear_cache
    clear_cache()
    jax.clear_caches()

"""Regression tests for the driver entry points (__graft_entry__.py).

The multichip dry run once regressed because utils/compile.aot_call
cached executables without input shardings in the key. These tests pin (a) the exact entry-point sequence the driver
runs, and (b) the aot_call cache-key mechanism itself.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as graft  # noqa: E402


def test_dryrun_multichip_8():
    """The driver's exact multichip validation call on the virtual 8-CPU
    mesh. Must build the sharded hierarchy and run one sharded NTL cycle."""
    graft.dryrun_multichip(8)


def test_entry_then_dryrun_no_cache_collision():
    """Worst-case ordering: a single-device program compiles (and seeds the
    aot_call cache) BEFORE the sharded path runs.  With sharding-blind keys
    this raised 'compiled for input shardings that disagree'."""
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(float(out[2]))
    graft.dryrun_multichip(8)


def test_aot_call_sharding_in_key():
    """aot_call must compile distinct executables for single-device vs
    mesh-sharded args even under an identical caller key."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tpu_multigrid.utils import compile as uc

    def f(x):
        return (x * 2.0).sum()

    x_single = jnp.ones((8, 8))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("x", "y"))
    x_sharded = jax.device_put(x_single, NamedSharding(mesh, P("x", "y")))

    n0 = len(uc._cache)
    r1 = uc.aot_call(f, x_single, key=("collision-test",))
    n1 = len(uc._cache)
    r2 = uc.aot_call(f, x_sharded, key=("collision-test",))
    n2 = len(uc._cache)
    assert n1 == n0 + 1 and n2 == n1 + 1, "sharded args must get a fresh key"
    assert float(r1) == float(r2) == 128.0
    # and a genuine cache hit still happens for identical signatures
    uc.aot_call(f, x_sharded, key=("collision-test",))
    assert len(uc._cache) == n2

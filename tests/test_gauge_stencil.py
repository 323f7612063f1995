"""Spin-projected (links-only) level-0 fast path == dense stencil path.

The compact representation must be mathematically identical to
assemble(...) + apply_D / smoothers on the dense D (reference math,
level.h:131-175); these tests pin that equivalence on random gauge
fields in complex128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.models import gauge, operators
from tpu_multigrid.ops import stencil, smoothers, gauge_stencil as gs


def _setup(stencil_name, L=24, m=0.1, seed=0):
    rng = np.random.default_rng(seed)
    U = gauge.gauge_from_phases(rng.uniform(-np.pi, np.pi, size=(2, L, L)),
                                jnp.complex128)
    D = operators.assemble(stencil_name, U, m)
    n = 2 if stencil_name == "wilson" else 1
    v = jnp.asarray(rng.normal(size=(n, L, L))
                    + 1j * rng.normal(size=(n, L, L)))
    return U, D, v


@pytest.mark.parametrize("st", ["wilson", "laplace"])
def test_apply_u_matches_dense(st):
    U, D, v = _setup(st)
    dense = stencil.apply_D(D, v)
    compact = gs.apply_u(st, U, 0.1, v)
    assert float(jnp.max(jnp.abs(dense - compact))) < 1e-12


@pytest.mark.parametrize("st", ["wilson", "laplace"])
@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
def test_smoother_u_matches_dense(st, kind):
    U, D, v = _setup(st, seed=3)
    r = _setup(st, seed=4)[2]
    Dinv = stencil.site_inverse(D[0])
    dense = smoothers._SWEEPS[kind](D, Dinv, v, r)
    compact = (gs.jacobi_sweep_u if kind == "jacobi"
               else gs.rbgs_sweep_u)(st, U, 0.1, v, r)
    assert float(jnp.max(jnp.abs(dense - compact))) < 1e-12


def test_smooth_u_multi_sweep():
    U, D, v = _setup("wilson", seed=5)
    r = _setup("wilson", seed=6)[2]
    Dinv = stencil.site_inverse(D[0])
    dense = v
    for _ in range(3):
        dense = smoothers.rbgs_sweep(D, Dinv, dense, r)
    compact = gs.smooth_u("wilson", U, 0.1, v, r, 3, "rbgs")
    assert float(jnp.max(jnp.abs(dense - compact))) < 1e-11


def test_apply_D_unrolled_matches_einsum():
    import numpy as np
    import jax.numpy as jnp
    from tpu_multigrid.models import gauge, operators
    from tpu_multigrid.ops.stencil import apply_D, apply_D_unrolled

    rng = np.random.default_rng(11)
    for stencil, n in (("laplace", 1), ("wilson", 2)):
        U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, 12, 12)),
                                    jnp.complex128)
        D = operators.assemble(stencil, U, -0.03)
        v = jnp.asarray(rng.normal(size=(n, 12, 12))
                        + 1j * rng.normal(size=(n, 12, 12)))
        np.testing.assert_allclose(np.asarray(apply_D_unrolled(D, v)),
                                   np.asarray(apply_D(D, v)),
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("L", [32, 48, 64])
@pytest.mark.parametrize("st", ["wilson", "laplace"])
@pytest.mark.parametrize("op", ["apply", "residual", "jacobi", "rbgs"])
def test_level0_xla_path_matches_dense(op, st, L):
    """The level-0 links-only XLA path (apply_u / residual_u / smooth_u,
    what solver/cycles dispatches at level 0) against the dense reference
    (ops/stencil, ops/smoothers) on the assembled operator, across
    lattice sizes: the only level-0 path left on every platform."""
    U, D, v = _setup(st, L=L, seed=L)
    r = _setup(st, L=L, seed=L + 1)[2]
    if op == "apply":
        got, ref = gs.apply_u(st, U, 0.1, v), stencil.apply_D(D, v)
    elif op == "residual":
        got = gs.residual_u(st, U, 0.1, v, r)
        ref = stencil.residual(D, v, r)
    else:
        got = gs.smooth_u(st, U, 0.1, v, r, 3, op)
        ref = smoothers.smooth(D, stencil.site_inverse(D[0]), v, r, 3, op)
    err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
    assert err < 1e-12, err

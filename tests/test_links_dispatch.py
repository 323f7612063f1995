"""Production-solve dispatch of the level-0 links-only fast path.

These tests pin that (a) a hierarchy carrying gauge links routes wilson
level-0 smoother sweeps and residuals through ops/gauge_stencil and
(b) the solve trajectory is the dense trajectory —
identical math (reference level.h:100-128 smoother, :155-172 hopping
structure), different streaming representation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_multigrid as mg
from tpu_multigrid.solver import cycles
from tpu_multigrid.solver.driver import solve, solve_chunked
from tpu_multigrid.solver.hierarchy import zero_fields


def _build(dtype, links, L=32, smoother="rbgs"):
    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                      n_copies=4, num_iters=4, null_iters=24, dtype=dtype,
                      smoother=smoother, res_threshold=1e-6, links=links)
    rng = np.random.default_rng(7)
    U = mg.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)
    hier = mg.build_hierarchy(D, cfg, check=False, U=U)
    return cfg, hier, mg.point_source(cfg)


def test_links_active_policy():
    cfg, hier, _ = _build("complex64", "auto")
    assert hier.gauge is not None
    assert cycles.links_active(cfg, hier.gauge, 0)
    assert not cycles.links_active(cfg, hier.gauge, 1)       # coarse: dense
    assert not cycles.links_active(cfg.replace(links="off"), hier.gauge, 0)
    c128 = cfg.replace(dtype="complex128")
    assert not cycles.links_active(c128, hier.gauge, 0)      # auto: c64 only
    assert cycles.links_active(c128.replace(links="on"), hier.gauge, 0)
    lap = cfg.replace(stencil="laplace")
    assert not cycles.links_active(lap, hier.gauge, 0)
    assert not cycles.links_active(cfg, None, 0)


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_cycle_links_matches_dense(smoother):
    """One NTL cycle with links='on' == the dense-path cycle (c128 so the
    comparison is at reassociation-level tolerance)."""
    cfg, hier, b = _build("complex128", "on", smoother=smoother)
    dense_cfg = cfg.replace(links="off")
    phis0 = zero_fields(cfg)
    p1, a1 = cycles.cycle(hier, phis0, b, cfg)
    p2, a2 = cycles.cycle(hier, phis0, b, dense_cfg)
    np.testing.assert_allclose(np.asarray(p1[0]), np.asarray(p2[0]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=1e-10)
    r1 = cycles.residual_norm_ratio0(hier, p1[0], b, cfg)
    r2 = cycles.residual_norm_ratio0(hier, p2[0], b, dense_cfg)
    assert abs(float(r1) - float(r2)) < 1e-12


def test_solve_links_same_cycle_count():
    """Full while-loop solve: links path converges in the same number of
    cycles as the dense path (c64 production mode)."""
    cfg, hier, b = _build("complex64", "auto")
    out_links = solve(hier, b, cfg, max_iters=50)
    out_dense = solve(hier, b, cfg.replace(links="off"), max_iters=50)
    assert out_links.converged and out_dense.converged
    assert out_links.iters == out_dense.iters
    np.testing.assert_allclose(out_links.phi, out_dense.phi,
                               rtol=0, atol=5e-5)


def test_solve_chunked_links():
    cfg, hier, b = _build("complex64", "auto")
    out = solve_chunked(hier, b, cfg, max_iters=50, chunk=5)
    assert out.converged


def test_vcycle_and_fmg_links():
    """Telescoping V-cycle + FMG init also route through the links path
    without changing the math."""
    cfg, hier, b = _build("complex128", "on")
    cfg = cfg.replace(ntl=False)
    phis0 = zero_fields(cfg)
    p1 = cycles.v_cycle(hier, phis0, b, cfg)
    p2 = cycles.v_cycle(hier, phis0, b, cfg.replace(links="off"))
    np.testing.assert_allclose(np.asarray(p1[0]), np.asarray(p2[0]),
                               rtol=0, atol=1e-12)
    f1 = cycles.fmg_init(hier, b, cfg)
    f2 = cycles.fmg_init(hier, b, cfg.replace(links="off"))
    np.testing.assert_allclose(np.asarray(f1[0]), np.asarray(f2[0]),
                               rtol=0, atol=1e-12)


def test_cast_hierarchy_keeps_gauge():
    """solve_ir's inner c64 view must carry the links so inner cycles use
    the fast path."""
    cfg, hier, _ = _build("complex128", "auto")
    h64 = mg.cast_hierarchy(hier, jnp.complex64)
    assert h64.gauge is not None and h64.gauge.dtype == jnp.complex64

"""Generation-1 geometric-MG tests (BASELINE config 1: 64^2, 2 levels)."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.solver import geometric as geo


def test_restrict_prolong_shapes():
    r = jnp.arange(16.0).reshape(4, 4)
    c = geo.geo_restrict(r)
    assert c.shape == (2, 2)
    np.testing.assert_allclose(np.asarray(c)[0, 0],
                               0.25 * (0 + 1 + 4 + 5))
    f = geo.geo_prolong(c)
    assert f.shape == (4, 4)
    assert float(f[0, 0]) == float(f[1, 1]) == float(c[0, 0])


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_geo_converges_64(smoother):
    # NOTE: at the reference's m=0.002 a shallow 2-level hierarchy leaves
    # the near-zero constant mode essentially undamped (the reference's own
    # run uses 9 levels at L=2048 so m^2 a^2 grows to O(1) on the coarsest
    # grid); unit tests use a moderate mass.
    cfg = geo.GeoConfig(L=64, m=0.5, nlevels=2, num_iters=20,
                        res_threshold=1e-12, smoother=smoother)
    b = geo.geo_source(cfg)
    phi, iters, res, hist = geo.geo_solve(b, cfg, max_iters=500)
    assert res < 1e-12, res
    # solution satisfies the gen-1 operator equation
    res0 = float(geo.geo_residue_l1(jnp.asarray(phi), b, cfg))
    assert res0 < 1e-11


def test_geo_deep_hierarchy_handles_small_mass():
    """With enough levels the tiny-mass constant mode is handled: deeper
    hierarchies converge strictly faster at m=0.002."""
    b64 = geo.geo_source(geo.GeoConfig(L=64))
    res = {}
    for nl in (2, 5):
        cfg = geo.GeoConfig(L=64, m=0.002, nlevels=nl, num_iters=20,
                            res_threshold=0.0)
        _, _, r, _ = geo.geo_solve(b64, cfg, max_iters=40)
        res[nl] = r
    assert res[5] < 0.5 * res[2]


def test_geo_mg_beats_relaxation():
    """MG converges far faster than pure relaxation."""
    cfg = geo.GeoConfig(L=64, m=0.2, nlevels=3, num_iters=10,
                        res_threshold=1e-10)
    b = geo.geo_source(cfg)
    _, iters_mg, res_mg, _ = geo.geo_solve(b, cfg, max_iters=300)
    assert res_mg < 1e-10
    cfg0 = geo.GeoConfig(L=64, m=0.2, nlevels=0, num_iters=10,
                         res_threshold=1e-10)
    _, iters_rel, res_rel, _ = geo.geo_solve(b, cfg0, max_iters=300)
    # pure relaxation stalls on low modes
    assert res_rel > 1e3 * res_mg or iters_rel >= 10 * iters_mg


def test_geo_spacing_scales():
    cfg = geo.GeoConfig(L=64, nlevels=3, m=0.1)
    assert cfg.spacings == (1.0, 2.0, 4.0, 8.0)
    np.testing.assert_allclose(
        cfg.scales[2], 1.0 / (4.0 + 0.1 ** 2 * 16.0))


def test_geo_solve_ir_matches_f64():
    """Mixed-precision defect correction (f32 V-cycles, f64 outer loop)
    contracts like the pure-f64 solve and reaches the same solution well
    below the f32 floor (the gen-1 mode of bench geo2048)."""
    import numpy as np
    from tpu_multigrid.solver.geometric import (GeoConfig, geo_source,
                                                geo_solve, geo_solve_ir)
    cfg = GeoConfig(L=64, m=0.064, nlevels=4, res_threshold=1e-10,
                    max_iters=30)
    b = geo_source(cfg)
    phi64, it64, res64, _ = geo_solve(b, cfg, chunk=2)
    phi_ir, it_ir, res_ir, _ = geo_solve_ir(b, cfg, chunk=2)
    assert res_ir < 1e-10          # far below the f32 sum|r| floor (~1e-3)
    assert it_ir <= it64 + 4       # same contraction regime
    np.testing.assert_allclose(phi_ir, phi64, rtol=0, atol=1e-11 *
                               np.max(np.abs(phi64)))


def test_residual_floor_estimate_scale():
    """geo_residual_floor ~ eps * sum(per-site term magnitudes): positive,
    scales with eps(dtype), and sits orders below the initial residual but
    above zero for a converged phi."""
    import numpy as np
    import jax.numpy as jnp
    from tpu_multigrid.solver.geometric import (GeoConfig, geo_source,
                                                geo_residual_floor)

    cfg = GeoConfig(L=32, nlevels=3, dtype="float64")
    b = geo_source(cfg)
    phi = jnp.ones((32, 32), jnp.float64)
    f64 = geo_residual_floor(phi, b, cfg)
    f32 = geo_residual_floor(phi.astype(jnp.float32),
                             b.astype(jnp.float32), cfg)
    assert 0 < f64 < 1e-9
    # eps ratio between f32 and f64 is ~2^29
    assert 1e7 < f32 / f64 < 1e10

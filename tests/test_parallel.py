"""Distributed-path tests on the virtual 8-device CPU mesh: halo exchange
vs jnp.roll ground truth, sharded stencil/smoother equivalence, and the
full sharded (NTL-)V-cycle solve matching the single-device solver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpu_multigrid.config import MGConfig
from tpu_multigrid.models import gauge, operators
from tpu_multigrid.ops import stencil
from tpu_multigrid.parallel import halo, sharded
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source, zero_fields
from tpu_multigrid.solver.driver import solve


requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def mesh24():
    return sharded.make_mesh((2, 4))


@requires_8
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_shift_halo_matches_roll(d, rng):
    mesh = mesh24()
    v = jnp.asarray(rng.normal(size=(2, 16, 16))
                    + 1j * rng.normal(size=(2, 16, 16)))
    f = jax.jit(jax.shard_map(lambda x: halo.shift_halo(x, d), mesh=mesh,
                              in_specs=P(None, "x", "y"),
                              out_specs=P(None, "x", "y")))
    np.testing.assert_allclose(np.asarray(f(v)),
                               np.asarray(stencil.shift(v, d)), atol=0)


@requires_8
def test_apply_d_sharded_matches(rng):
    mesh = mesh24()
    L = 16
    U = gauge.gauge_from_phases(rng.normal(size=(2, L, L)) * 0.3)
    D = operators.assemble_wilson(U, -0.05)
    v = jnp.asarray(rng.normal(size=(2, L, L)) + 1j * rng.normal(size=(2, L, L)))
    f = jax.jit(jax.shard_map(halo.apply_D_sharded, mesh=mesh,
                              in_specs=(P(None, None, None, "x", "y"),
                                        P(None, "x", "y")),
                              out_specs=P(None, "x", "y")))
    np.testing.assert_allclose(np.asarray(f(D, v)),
                               np.asarray(stencil.apply_D(D, v)), atol=1e-12)


@requires_8
def test_smoother_sharded_matches(rng):
    from tpu_multigrid.ops.smoothers import smooth
    mesh = mesh24()
    L = 16
    U = gauge.gauge_from_phases(rng.normal(size=(2, L, L)) * 0.3)
    D = operators.assemble_laplace(U, 0.2)
    Dinv = stencil.site_inverse(D[0])
    b = jnp.asarray(rng.normal(size=(1, L, L)) + 0j)
    phi = jnp.zeros_like(b)
    f = jax.jit(jax.shard_map(
        lambda D, Di, p, r: halo.smooth_sharded(D, Di, p, r, 5, "rbgs"),
        mesh=mesh,
        in_specs=(P(None, None, None, "x", "y"), P(None, None, "x", "y"),
                  P(None, "x", "y"), P(None, "x", "y")),
        out_specs=P(None, "x", "y")))
    got = np.asarray(f(D, Dinv, phi, b))
    want = np.asarray(smooth(D, Dinv, phi, b, 5, "rbgs"))
    np.testing.assert_allclose(got, want, atol=1e-12)


@requires_8
@pytest.mark.parametrize("stencil_name,ntl", [("laplace", False),
                                              ("laplace", True),
                                              ("wilson", True)])
def test_sharded_solve_matches_single_device(stencil_name, ntl, rng):
    mesh = mesh24()
    L = 32
    cfg = MGConfig(L=L, stencil=stencil_name, m=0.1, nlevels=2, ntl=ntl,
                   num_iters=6, null_iters=60, res_threshold=1e-9)
    U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = operators.assemble(cfg.stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg)
    b = point_source(cfg)

    ref = solve(hier, b, cfg, max_iters=100)
    assert ref.converged

    solver = sharded.make_sharded_solver(cfg, mesh, max_iters=100)(hier)
    hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
    phis, iters, res = solver(hier_s, zero_fields(cfg), b)
    assert float(res) < cfg.res_threshold
    # identical math => same iteration count and (near-)identical solution
    assert int(iters) == ref.iters
    np.testing.assert_allclose(np.asarray(phis[0]), ref.phi, atol=1e-10)


@requires_8
def test_sharded_avg_coarse_matches_single_device(rng):
    """gen-2 single-interpolation recombination inside the shard_map
    cycle matches the single-device path."""
    mesh = mesh24()
    L = 32
    cfg = MGConfig(L=L, stencil="laplace", m=0.1, nlevels=2, ntl=True,
                   min_res=False, ntl_combine="avg_coarse", num_iters=6,
                   null_iters=60, res_threshold=1e-9)
    U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = operators.assemble(cfg.stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg)
    b = point_source(cfg)

    ref = solve(hier, b, cfg, max_iters=200)
    assert ref.converged

    solver = sharded.make_sharded_solver(cfg, mesh, max_iters=200)(hier)
    hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
    phis, iters, res = solver(hier_s, zero_fields(cfg), b)
    assert float(res) < cfg.res_threshold
    assert int(iters) == ref.iters
    np.testing.assert_allclose(np.asarray(phis[0]), ref.phi, atol=1e-10)


@requires_8
def test_shardable_levels():
    mesh = mesh24()
    cfg = MGConfig(L=32, stencil="laplace", m=0.1, nlevels=3)
    sh = sharded.shardable_levels(cfg, mesh)
    # 32 -> (16,8) local ok; 16 -> (8,4) ok; 8 -> (4,2) ok but coarsest of
    # nlevels=3 is level 3 (L=4 -> local (2,1)) -> replicated
    assert sh[0] and sh[1] and sh[2]
    assert not sh[3]


@requires_8
@pytest.mark.parametrize("stencil_name", ["laplace", "wilson"])
def test_sharded_setup_matches_single_device(stencil_name, rng):
    """Distributed near-null setup (halo smoother + sharded ortho +
    sharded Galerkin) reproduces the single-device hierarchy."""
    from tpu_multigrid.parallel.setup import build_hierarchy_sharded
    mesh = mesh24()
    L = 32
    cfg = MGConfig(L=L, stencil=stencil_name, m=0.1, nlevels=2,
                   num_iters=6, null_iters=40, res_threshold=1e-9)
    U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = operators.assemble(cfg.stencil, U, cfg.m)
    h_ref = build_hierarchy(D, cfg, check=False)
    h_sh = build_hierarchy_sharded(D, cfg, mesh)
    for l in range(cfg.nlevels):
        np.testing.assert_allclose(np.asarray(h_sh.levels[l].phi_null),
                                   np.asarray(h_ref.levels[l].phi_null),
                                   atol=1e-11, err_msg=f"phi_null lvl {l}")
        np.testing.assert_allclose(np.asarray(h_sh.levels[l + 1].D),
                                   np.asarray(h_ref.levels[l + 1].D),
                                   atol=1e-11, err_msg=f"Dc lvl {l+1}")
    out = solve(h_sh, point_source(cfg), cfg, max_iters=100)
    assert out.converged


def test_sharded_smoother_downgrade_warns():
    """gs_lex/chebyshev silently ran as rbgs in the sharded cycle; the
    downgrade must now be surfaced."""
    import warnings
    from tpu_multigrid.config import MGConfig
    from tpu_multigrid.parallel import sharded

    mesh = sharded.make_mesh((2, 4))
    cfg = MGConfig(L=16, stencil="laplace", m=0.1, nlevels=1,
                   smoother="gs_lex")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sharded.make_sharded_cycle(cfg, mesh)
    assert any("downgrades smoother 'gs_lex'" in str(x.message) for x in w)

    cfg_ok = MGConfig(L=16, stencil="laplace", m=0.1, nlevels=1,
                      smoother="rbgs")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sharded.make_sharded_cycle(cfg_ok, mesh)
    assert not any("downgrades" in str(x.message) for x in w)


@requires_8
def test_sharded_chebyshev_matches_single_device(rng):
    """Chebyshev now runs natively in the sharded cycle (no rbgs
    downgrade): identical trajectory to the single-device solve."""
    import warnings
    from tpu_multigrid.solver import eigs
    mesh = mesh24()
    L = 32
    cfg = MGConfig(L=L, stencil="wilson", m=0.1, nlevels=2, ntl=True,
                   num_iters=6, null_iters=60, res_threshold=1e-9)
    U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = operators.assemble(cfg.stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg)
    cfg_ch = eigs.chebyshev_config(cfg, hier)
    b = point_source(cfg)

    ref = solve(hier, b, cfg_ch, max_iters=100)
    assert ref.converged

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        solver = sharded.make_sharded_solver(cfg_ch, mesh, max_iters=100)(hier)
    assert not any("downgrades" in str(x.message) for x in w)
    hier_s = sharded.shard_hierarchy(hier, cfg_ch, mesh)
    phis, iters, res = solver(hier_s, zero_fields(cfg_ch), b)
    assert float(res) < cfg_ch.res_threshold
    assert int(iters) == ref.iters
    np.testing.assert_allclose(np.asarray(phis[0]), ref.phi, atol=1e-10)


@requires_8
def test_halo_overlap_matches_concat(rng):
    """Interior/boundary-split hop schedule == permute-then-concat
    baseline == single-device roll ground truth (SURVEY §5.8 overlap
    structure; identical per-site contractions, different association)."""
    mesh = mesh24()
    L = 16
    U = gauge.gauge_from_phases(rng.normal(size=(2, L, L)) * 0.3)
    D = operators.assemble_wilson(U, -0.05)
    v = jnp.asarray(rng.normal(size=(2, L, L))
                    + 1j * rng.normal(size=(2, L, L)))
    specs = dict(in_specs=(P(None, None, None, "x", "y"),
                           P(None, "x", "y")),
                 out_specs=P(None, "x", "y"))
    f_ov = jax.jit(jax.shard_map(
        lambda D, v: halo.apply_D_sharded(D, v, overlap=True),
        mesh=mesh, **specs))
    f_cc = jax.jit(jax.shard_map(
        lambda D, v: halo.apply_D_sharded(D, v, overlap=False),
        mesh=mesh, **specs))
    ref = np.asarray(stencil.apply_D(D, v))
    np.testing.assert_allclose(np.asarray(f_ov(D, v)), ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(f_ov(D, v)),
                               np.asarray(f_cc(D, v)), atol=1e-13)


@requires_8
def test_sharded_solve_overlap_flag(rng):
    """The full sharded NTL solve gives the same trajectory with the
    overlap schedule and the concat baseline (flag-selectable,
    cfg.halo_overlap)."""
    L = 16
    cfg = MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                   n_copies=4, num_iters=3, null_iters=16,
                   dtype="complex64", smoother="rbgs", res_threshold=1e-20)
    mesh = mesh24()
    U = gauge.gauge_from_phases(0.2 * rng.normal(size=(2, L, L)),
                                cfg.cdtype)
    D = operators.assemble(cfg.stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg, check=False)
    b = point_source(cfg)
    phis = zero_fields(cfg)
    outs = {}
    for ov in (True, False):
        c = cfg.replace(halo_overlap=ov)
        solver = sharded.make_sharded_solver(c, mesh, max_iters=3)(hier)
        hs = sharded.shard_hierarchy(hier, c, mesh)
        ph, it, res = solver(hs, phis, b)
        outs[ov] = (np.asarray(ph[0]), float(res))
    np.testing.assert_allclose(outs[True][0], outs[False][0], atol=1e-5)
    assert abs(outs[True][1] - outs[False][1]) < 1e-6

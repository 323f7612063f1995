"""End-to-end MG solve tests: convergence of the telescoping V-cycle and
the NTL cycle on gauged Laplace and Wilson systems, MG vs unpreconditioned
minimal-residual (the >= 5x cycle-reduction target), and smoother behavior."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.config import MGConfig
from tpu_multigrid.models import gauge, operators
from tpu_multigrid.ops.stencil import residual_norm_ratio, apply_D
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source, zero_fields
from tpu_multigrid.solver.driver import solve, solve_with_history, mr_solve


def setup_problem(stencil, L=32, nlevels=2, m=0.1, ntl=False, seed=0,
                  gauged=False, smoother="rbgs", num_iters=10, null_iters=100):
    cfg = MGConfig(L=L, stencil=stencil, m=m, nlevels=nlevels, ntl=ntl,
                   num_iters=num_iters, null_iters=null_iters,
                   smoother=smoother, res_threshold=1e-10)
    if gauged:
        rng = np.random.default_rng(seed)
        U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)),
                                    cfg.cdtype)
    else:
        U = gauge.identity_gauge(L, cfg.cdtype)
    D = operators.assemble(stencil, U, m)
    hier = build_hierarchy(D, cfg)
    b = point_source(cfg)
    return cfg, hier, D, b


def test_laplace_vcycle_converges():
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.05)
    out = solve(hier, b, cfg, max_iters=200)
    assert out.converged, f"residual {out.resmag}"
    # Solution actually solves the system.
    res = float(residual_norm_ratio(D, jnp.asarray(out.phi), b))
    assert res < 1e-9


def test_laplace_gauged_vcycle_converges():
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.05,
                                    gauged=True)
    out = solve(hier, b, cfg, max_iters=300)
    assert out.converged, f"residual {out.resmag}"


def test_wilson_vcycle_converges():
    cfg, hier, D, b = setup_problem("wilson", L=16, nlevels=2, m=0.1,
                                    gauged=True)
    out = solve(hier, b, cfg, max_iters=300)
    assert out.converged, f"residual {out.resmag}"


@pytest.mark.parametrize("min_res", [True, False])
def test_ntl_converges(min_res):
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.05,
                                    ntl=True)
    cfg = cfg.replace(min_res=min_res)
    out = solve_with_history(hier, b, cfg, max_iters=200)
    assert out.converged, f"residual {out.resmag}"
    assert out.ntl_weights.shape[1] == cfg.n_copies
    if min_res:
        # weights should not all be exactly the plain average
        assert not np.allclose(out.ntl_weights[0], 0.25)


def test_ntl_single_interpolation_variant():
    """gen-2 '_singleinterpolation' capability: average the COARSE copies
    and prolongate once (telescoping_2d_laplace_Mgrid_singleinterpolation
    .cpp:306-315) — converges, and differs from the per-copy-prolong
    average after one cycle."""
    from tpu_multigrid.solver.cycles import ntl_cycle
    from tpu_multigrid.solver.hierarchy import zero_fields

    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.05,
                                    ntl=True)
    cfg_si = cfg.replace(min_res=False, ntl_combine="avg_coarse")
    out = solve_with_history(hier, b, cfg_si, max_iters=300)
    assert out.converged, f"residual {out.resmag}"

    cfg_avg = cfg.replace(min_res=False, ntl_combine="avg_prolong")
    p1, _ = ntl_cycle(hier, zero_fields(cfg_si), b, cfg_si)
    p2, _ = ntl_cycle(hier, zero_fields(cfg_avg), b, cfg_avg)
    assert not np.allclose(np.asarray(p1[0]), np.asarray(p2[0]))


def test_ntl_wilson_converges():
    cfg, hier, D, b = setup_problem("wilson", L=16, nlevels=2, m=0.1,
                                    gauged=True, ntl=True)
    out = solve(hier, b, cfg, max_iters=300)
    assert out.converged, f"residual {out.resmag}"


def test_mg_beats_mr_by_5x():
    """BASELINE north star: >= 5x cycle-count reduction vs unpreconditioned
    minimal residual at 1e-8 (here on a small near-critical laplace)."""
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=3, m=0.01,
                                    num_iters=4)
    cfg = cfg.replace(res_threshold=1e-8)
    out = solve(hier, b, cfg, max_iters=1000)
    assert out.converged
    _, mr_iters, mr_res = mr_solve(D, b, tol=1e-8, max_iters=200000)
    assert mr_res < 1e-8
    assert mr_iters >= 5 * out.iters, (mr_iters, out.iters)


def test_jacobi_smoother_converges():
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.1,
                                    smoother="jacobi", num_iters=20)
    out = solve(hier, b, cfg, max_iters=300)
    assert out.converged


def test_gs_lex_matches_relaxation_property():
    """Lexicographic GS reduces the residual at least as fast as Jacobi on
    a small problem (sanity check of the wavefront implementation)."""
    from tpu_multigrid.ops.smoothers import smooth
    from tpu_multigrid.ops.stencil import site_inverse
    cfg = MGConfig(L=8, stencil="laplace", m=0.5, nlevels=1)
    U = gauge.identity_gauge(8, cfg.cdtype)
    D = operators.assemble("laplace", U, cfg.m)
    Dinv = site_inverse(D[0])
    b = point_source(cfg)
    phi0 = jnp.zeros_like(b)
    r_j = float(residual_norm_ratio(D, smooth(D, Dinv, phi0, b, 10, "jacobi"), b))
    r_g = float(residual_norm_ratio(D, smooth(D, Dinv, phi0, b, 10, "gs_lex"), b))
    assert r_g <= r_j * 1.01
    assert r_g < 1.0


def test_history_monotone_tail():
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=2, m=0.1)
    out = solve_with_history(hier, b, cfg, max_iters=100)
    assert out.converged
    h = out.history
    # after the first few cycles the residual decreases monotonically
    assert np.all(np.diff(h[2:]) < 0)


@pytest.mark.parametrize("stencil_name,ndc", [("laplace", 1),
                                              ("laplace", 3),
                                              ("wilson", 2)])
def test_configurable_coarse_dof(stencil_name, ndc):
    """Variable coarse dof (reference early-gen capability: e.g. the
    single-null-vector variant has ndof_coarse=1)."""
    from tpu_multigrid.models import gauge as G, operators as O
    from tpu_multigrid.solver.hierarchy import build_hierarchy
    from tpu_multigrid import testing as T
    cfg = MGConfig(L=16, stencil=stencil_name, m=0.3, nlevels=2,
                   num_iters=8, null_iters=80, res_threshold=1e-9,
                   ndof_coarse=ndc)
    assert cfg.n_dof[1] == ndc
    U = G.identity_gauge(16, cfg.cdtype)
    D = O.assemble(cfg.stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg)
    checks = T.run_mg_tests(hier, cfg)
    bad = {k: v for k, v in checks.items() if v > T.EPSILON}
    assert not bad, bad
    out = solve(hier, point_source(cfg), cfg, max_iters=300)
    assert out.converged


def test_gamma1_cycle_equals_vcycle():
    """gamma_cycle with gamma=1 reproduces the reference V-cycle exactly."""
    from tpu_multigrid.solver.cycles import v_cycle, gamma_cycle
    cfg, hier, D, b = setup_problem("laplace", L=16, nlevels=2, m=0.2,
                                    null_iters=60)
    phis = zero_fields(cfg)
    p1 = v_cycle(hier, phis, b, cfg)
    p2 = gamma_cycle(hier, phis, b, cfg)
    for a, c in zip(p1, p2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_wcycle_converges_at_least_as_fast():
    cfg, hier, D, b = setup_problem("laplace", L=32, nlevels=3, m=0.01,
                                    num_iters=4)
    out_v = solve(hier, b, cfg, max_iters=300)
    out_w = solve(hier, b, cfg.replace(cycle_gamma=2), max_iters=300)
    assert out_w.converged and out_v.converged
    assert out_w.iters <= out_v.iters


def test_iterative_refinement_matches_f64_solve():
    """Mixed-precision IR (complex64 inner cycles, f64 defect correction)
    reaches the f64 threshold in about the same total cycle count as the
    all-f64 solve, and the solutions agree to f64 rounding."""
    from tpu_multigrid.solver.driver import solve_ir
    cfg, hier, D, b = setup_problem("wilson", L=32, nlevels=2, m=0.1,
                                    ntl=True, gauged=True, num_iters=8,
                                    null_iters=80)
    cfg = cfg.replace(res_threshold=1e-12)
    ref = solve(hier, b, cfg, max_iters=100)
    out = solve_ir(hier, b, cfg, inner_cycles=2, max_iters=100)
    assert ref.converged and out.converged
    assert out.resmag < 1e-12
    assert out.iters <= 2 * ref.iters
    assert np.max(np.abs(out.phi - ref.phi)) < 1e-11
    # each outer step contracts by roughly the 2-cycle MG factor
    assert out.history[-1] < 1e-3 * out.history[0]


def test_ir_planes_mode_matches_c128():
    """solve_ir planes mode (F64 real/imag plane programs; see
    apply_D_planes) is bit-level equivalent to the C128 path, with a
    c64-built hierarchy + exact c128 D_outer (c64 setup, c128 outer
    step)."""
    from tpu_multigrid.solver.driver import solve_ir
    L = 32
    cfg64 = MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                     num_iters=4, null_iters=60, dtype="complex64",
                     smoother="rbgs")
    rng = np.random.default_rng(cfg64.seed)
    ph = 0.2 * rng.normal(size=(2, L, L))
    D64 = operators.assemble("wilson",
                             gauge.gauge_from_phases(ph, cfg64.cdtype),
                             cfg64.m)
    hier = build_hierarchy(D64, cfg64, check=False)
    cfg128 = cfg64.replace(dtype="complex128", res_threshold=1e-12)
    D128 = np.asarray(operators.assemble(
        "wilson", gauge.gauge_from_phases(ph, np.complex128), cfg128.m))
    b = np.zeros((2, L, L), np.complex128)
    b[0, 2, 2] = 5.0
    o_pl = solve_ir(hier, b, cfg128, inner_cycles=2, max_iters=100,
                    D_outer=D128, planes=True)
    o_cx = solve_ir(hier, jnp.asarray(b), cfg128, inner_cycles=2,
                    max_iters=100, D_outer=jnp.asarray(D128), planes=False)
    assert o_pl.converged and o_cx.converged
    assert o_pl.iters == o_cx.iters
    assert np.max(np.abs(o_pl.phi - o_cx.phi)) < 1e-13


def test_apply_d_planes_matches():
    """stencil.apply_D_planes == apply_D on the recombined complex."""
    from tpu_multigrid.ops.stencil import apply_D_planes
    L = 16
    rng = np.random.default_rng(5)
    U = gauge.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)),
                                jnp.complex128)
    D = operators.assemble("wilson", U, -0.05)
    v = jnp.asarray(rng.normal(size=(2, L, L))
                    + 1j * rng.normal(size=(2, L, L)))
    orr, oii = apply_D_planes(jnp.real(D), jnp.imag(D),
                              jnp.real(v), jnp.imag(v))
    want = apply_D(D, v)
    np.testing.assert_allclose(np.asarray(orr + 1j * oii),
                               np.asarray(want), atol=1e-13)


def test_fmg_solve():
    """FMG initial guess converges at least as fast as a zero start
    (its own sweep counted as one cycle)."""
    import tpu_multigrid as mg
    cfg, hier, D, b = setup_problem("wilson", L=16, nlevels=2, m=0.1,
                                    num_iters=4)
    out0 = mg.solve_chunked(hier, b, cfg, max_iters=300, chunk=1)
    outf = mg.solve_fmg(hier, b, cfg, max_iters=300, chunk=1)
    assert outf.converged
    assert outf.iters <= out0.iters + 1

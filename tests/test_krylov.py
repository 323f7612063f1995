"""MG-preconditioned FGMRES: convergence on systems where the stationary
cycle struggles (near-critical Wilson) and equivalence on easy systems."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.config import MGConfig
from tpu_multigrid.models import gauge, operators
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source
from tpu_multigrid.solver.driver import solve
from tpu_multigrid.solver.krylov import fgmres_solve
from tpu_multigrid.ops.stencil import residual_norm_ratio


def test_fgmres_easy_system():
    cfg = MGConfig(L=16, stencil="laplace", m=0.2, nlevels=2, num_iters=6,
                   null_iters=60, res_threshold=1e-9)
    D = operators.assemble("laplace", gauge.identity_gauge(16, cfg.cdtype),
                           cfg.m)
    hier = build_hierarchy(D, cfg, check=False)
    b = point_source(cfg)
    phi, iters, rel = fgmres_solve(hier, b, cfg, tol=1e-9)
    assert rel < 1e-9
    assert float(residual_norm_ratio(D, jnp.asarray(phi), b)) < 1e-8


def test_fgmres_rescues_hard_wilson():
    """At m=-0.02 on a beta=32 ensemble the Wilson operator is mildly
    indefinite: the stationary MG iteration diverges, but the same MG
    cycle as an FGMRES preconditioner converges."""
    theta = gauge.heatbath_ensemble(16, 32.0, 60, 7)
    cfg = MGConfig(L=16, stencil="wilson", m=-0.02, nlevels=2, num_iters=6,
                   null_iters=150, res_threshold=1e-8)
    U = gauge.gauge_from_phases(theta, cfg.cdtype)
    D = operators.assemble("wilson", U, cfg.m)
    hier = build_hierarchy(D, cfg, check=False)
    b = point_source(cfg)

    stat = solve(hier, b, cfg, max_iters=60)
    phi, iters, rel = fgmres_solve(hier, b, cfg, tol=1e-8, restart=15,
                                   max_restarts=20)
    assert rel < 1e-8, rel
    # and it must be the rescue: either the stationary solve failed or
    # FGMRES needed far fewer operator applications
    assert (not stat.converged) or iters <= stat.iters


def test_adjoint_stencil_identities():
    """adjoint_stencil == dense conj-transpose; laplace hermitian,
    wilson gamma5-hermitian (D^H = g5 D g5)."""
    from tpu_multigrid.ops.stencil import adjoint_stencil, apply_D
    from tpu_multigrid.analysis import dense_operator

    rng = np.random.default_rng(5)
    theta = rng.normal(size=(2, 8, 8)) * 0.3
    U = gauge.gauge_from_phases(theta, jnp.complex128)
    for st in ("laplace", "wilson"):
        D = operators.assemble(st, U, -0.03)
        Dd = adjoint_stencil(D)
        A = np.asarray(dense_operator(D))
        Ad = np.asarray(dense_operator(Dd))
        np.testing.assert_allclose(Ad, A.conj().T, atol=1e-14)
        n = D.shape[1]
        v = jnp.asarray(rng.normal(size=(n, 8, 8))
                        + 1j * rng.normal(size=(n, 8, 8)))
        if st == "wilson":
            g5v = jnp.stack([v[0], -v[1]])
            g5Dg5 = jnp.stack([apply_D(D, g5v)[0], -apply_D(D, g5v)[1]])
            np.testing.assert_allclose(np.asarray(apply_D(Dd, v)),
                                       np.asarray(g5Dg5), atol=1e-13)


def test_cgnr_solves_indefinite_wilson():
    """CGNR converges on the truly indefinite operator (m well below m_c
    on a beta=32 ensemble) where the stationary cycle diverges and
    MR stalls — the reference's literal m=-0.07 regime (full-scale run:
    scripts/wilson_m007.py part B)."""
    from tpu_multigrid.solver.krylov import cgnr_solve

    theta = gauge.heatbath_ensemble(16, 32.0, 60, 7)
    U = gauge.gauge_from_phases(theta, jnp.complex128)
    D = operators.assemble("wilson", U, -0.07)
    b = jnp.zeros((2, 16, 16), jnp.complex128).at[0, 2, 2].set(5.0)
    x, iters, rel = cgnr_solve(D, b, tol=1e-10, max_iters=20000,
                               chunk=250)
    assert rel < 1e-10, (iters, rel)
    from tpu_multigrid.ops.stencil import residual
    true = float(jnp.linalg.norm(residual(D, x, b))
                 / jnp.linalg.norm(b))
    assert true < 1e-9


def test_cgnr_ir_reaches_f64_accuracy_from_c64_inner():
    """cgnr_solve_ir: c64 inner solves + f64-plane outer defect
    correction reach 1e-10 true f64 residual."""
    from tpu_multigrid.solver.krylov import cgnr_solve_ir
    from tpu_multigrid.utils.xfer import device_complex

    theta = gauge.heatbath_ensemble(12, 32.0, 60, 7)
    with np.errstate(all="ignore"):
        U128 = np.asarray(gauge.gauge_from_phases(theta, jnp.complex128))
    D128 = np.asarray(operators.assemble(
        "wilson", jnp.asarray(U128), -0.07))
    b = np.zeros((2, 12, 12), np.complex128)
    b[0, 2, 2] = 5.0
    U64 = device_complex(U128, jnp.complex64)
    D64 = operators.assemble("wilson", U64, -0.07)
    out = cgnr_solve_ir(D64, D128, b, tol=1e-10, inner_tol=1e-4,
                        inner_max=4000, max_outer=8, chunk=200)
    assert out["rel"] < 1e-10, out

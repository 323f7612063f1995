"""Compiled-in self-test suite of the reference, as reusable property
checks (reference tests.h:5-295; tolerance Epsilon = 1e-12).

Each function returns a scalar "violation" (max abs deviation) so callers —
pytest, or the runtime pre-solve check pass f_MG_tests — can assert
against the reference tolerance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import MGConfig
from .models.operators import gamma5
from .ops.stencil import apply_D, shift
from .ops.transfer import restrict, prolong
from .solver.hierarchy import Hierarchy

EPSILON = 1.0e-12       # reference tests.h tolerance (double precision)


def epsilon_for(cfg) -> float:
    """Self-test tolerance for the run's dtype: the reference's 1e-12
    (tests.h:10) presumes double; complex64 hierarchies pass the same
    structural checks at f32 rounding scale (~1e-4)."""
    return EPSILON if cfg.dtype == "complex128" else 1.0e-4


def test1_restriction_prolongation(phi_null, vec_c, quad, bx, by):
    """P (P^dagger v_c) = v_c for any coarse v_c (tests.h:5-43) —
    requires block-orthonormal near-null rows. Returns max abs diff."""
    vf = prolong(phi_null, vec_c, quad, bx, by)
    back = restrict(phi_null, vf, quad, bx, by)
    return jnp.max(jnp.abs(back - vec_c))


def test2_galerkin(D_c, D_f, phi_null, vec_c, quad, bx, by):
    """D_c v = P (D_f (P^dagger v)) for random coarse v (tests.h:46-92)."""
    vf = prolong(phi_null, vec_c, quad, bx, by)
    Dv = apply_D(D_f, vf)
    lhs = restrict(phi_null, Dv, quad, bx, by)
    rhs = apply_D(D_c, vec_c)
    return jnp.max(jnp.abs(lhs - rhs))


def test3_hermiticity(D, stencil: str):
    """Element-wise stencil (gamma5-)hermiticity (tests.h:94-182).

    laplace: D_1(x) = D_2(x+x)^H, D_3(x) = D_4(x+y)^H, D_0 = D_0^H.
    wilson:  same with gamma5 M^H gamma5.
    """
    n = D.shape[1]

    def adj(M):  # conj-transpose of per-site blocks [n,n,L,L]
        return jnp.conj(jnp.swapaxes(M, 0, 1))

    def g5adj(M):
        g5 = jnp.asarray(gamma5(n), dtype=D.dtype)
        return jnp.einsum("ij,jkxy,kl->ilxy", g5, adj(M), g5)

    trans = adj if stencil == "laplace" else g5adj
    worst = 0.0
    worst = jnp.maximum(worst, jnp.max(jnp.abs(D[1] - trans(shift(D[2], 1)))))
    worst = jnp.maximum(worst, jnp.max(jnp.abs(D[3] - trans(shift(D[4], 3)))))
    worst = jnp.maximum(worst, jnp.max(jnp.abs(D[0] - trans(D[0]))))
    return worst


def test4_hermiticity_full(D, vec, stencil: str):
    """<v|D|v> real (laplace) / <v|D gamma5|v> real (wilson)
    (tests.h:184-248). Returns the RELATIVE imaginary part
    |Im <...>| / |<...>| — the raw inner product is O(L^2) in magnitude,
    so an absolute measure conflates reduction rounding, which depends on
    the device's summation order, with a genuine hermiticity
    violation."""
    n = D.shape[1]
    if stencil == "wilson":
        g5 = jnp.asarray(gamma5(n), dtype=D.dtype)
        D = jnp.einsum("sijxy,jk->sikxy", D, g5)
    w = apply_D(D, vec)
    val = jnp.sum(jnp.conj(vec) * w)
    return jnp.abs(jnp.imag(val)) / jnp.maximum(jnp.abs(val),
                                                jnp.finfo(vec.real.dtype).tiny)


def test_gauge_invariance_solve(cfg: MGConfig, U, omega, max_iters=200):
    """Gauge-invariance of the full MG solve (reference test program
    mgrid_test4_gauge_invariance.cpp; f_test_gauge_transform,
    6_ntl-mg_new_code/1_new_code/tests.h:171-215):

    solving D[U] phi = b and D[U'] phi' = Omega b with
    U'_mu(x) = Omega(x) U_mu(x) Omega(x+mu)^dagger must give
    phi' = Omega phi. Returns max |phi' - Omega phi| (post-convergence).
    """
    import jax.numpy as jnp
    from .models.operators import assemble
    from .models.gauge import gauge_transform
    from .solver.hierarchy import build_hierarchy, point_source
    from .solver.driver import solve

    D1 = assemble(cfg.stencil, U, cfg.m)
    D2 = assemble(cfg.stencil, gauge_transform(U, omega), cfg.m)
    b = point_source(cfg)
    h1 = build_hierarchy(D1, cfg, check=False)
    h2 = build_hierarchy(D2, cfg, check=False)
    out1 = solve(h1, b, cfg, max_iters=max_iters)
    out2 = solve(h2, omega[None] * b, cfg, max_iters=max_iters)
    if not (out1.converged and out2.converged):
        raise RuntimeError("gauge-invariance check: solves did not converge")
    rotated = np.asarray(omega)[None] * out1.phi
    return float(np.max(np.abs(out2.phi - rotated)))


def run_mg_tests(hier: Hierarchy, cfg: MGConfig, key=None) -> dict:
    """Run the full pre-solve verification pass at every level and every
    NTL copy on fresh random vectors (reference f_MG_tests, tests.h:250-295).

    Returns {check_name: violation}; all values should be < EPSILON.
    """
    from .utils.compile import aot_call

    if key is None:
        key = jax.random.PRNGKey(cfg.seed + 1)
    out = {}
    bx, by = cfg.block_x, cfg.block_y

    # Each level's checks run as ONE fused AOT program fetching a real
    # f32 vector of violations — including the random test vector's
    # generation (fold_in per level, inside the program) — instead of
    # hundreds of eager dispatches.
    #
    # Matmul precision: on the GPU an f32/c64 contraction may run in TF32
    # (~3 decimal digits) unless pinned, and these are EXACT identity
    # checks held to 1e-4 in c64. The programs pin HIGHEST.
    def _vec(key, lvl, n, S):
        k = jax.random.fold_in(key, lvl)
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (n, S, S), minval=-np.pi,
                                   maxval=np.pi)
                + 1j * jax.random.uniform(k2, (n, S, S), minval=-np.pi,
                                          maxval=np.pi)).astype(cfg.cdtype)

    for lvl in range(cfg.nlevels + 1):
        n, S = cfg.n_dof[lvl], cfg.sizes[lvl]
        lev = hier.levels[lvl]
        ntl_bottom = cfg.ntl and lvl == cfg.nlevels
        if ntl_bottom:
            for q in range(cfg.n_copies):
                pn = hier.ntl.phi_null[q]
                Dq = hier.ntl.D[q]
                fine = hier.levels[lvl - 1]

                def prog(pn, Dq, Df, key, lvl=lvl, q=q, n=n, S=S):
                    with jax.default_matmul_precision("highest"):
                        vec = _vec(key, lvl, n, S)
                        return jnp.stack([
                            test1_restriction_prolongation(pn, vec, q + 1,
                                                           bx, by),
                            test2_galerkin(Dq, Df, pn, vec, q + 1, bx, by),
                            test3_hermiticity(Dq, cfg.stencil),
                            test4_hermiticity_full(Dq, vec, cfg.stencil),
                        ]).astype(jnp.float32)

                vals = np.asarray(aot_call(
                    prog, pn, Dq, fine.D, key,
                    key=("mgtests_ntl", cfg, lvl, q)))
                for i, t in enumerate(("test1", "test2", "test3", "test4")):
                    out[f"lvl{lvl}_ntl{q}_{t}"] = float(vals[i])
        elif lvl > 0:
            fine = hier.levels[lvl - 1]

            def prog(Dl, Df, pn, key, lvl=lvl, n=n, S=S):
                with jax.default_matmul_precision("highest"):
                    vec = _vec(key, lvl, n, S)
                    return jnp.stack([
                        test1_restriction_prolongation(pn, vec, cfg.quad,
                                                       bx, by),
                        test2_galerkin(Dl, Df, pn, vec, cfg.quad, bx, by),
                        test3_hermiticity(Dl, cfg.stencil),
                        test4_hermiticity_full(Dl, vec, cfg.stencil),
                    ]).astype(jnp.float32)

            vals = np.asarray(aot_call(
                prog, lev.D, fine.D, fine.phi_null, key,
                key=("mgtests", cfg, lvl)))
            for i, t in enumerate(("test1", "test2", "test3", "test4")):
                out[f"lvl{lvl}_{t}"] = float(vals[i])
        else:
            def prog(Dl, key, lvl=lvl, n=n, S=S):
                with jax.default_matmul_precision("highest"):
                    vec = _vec(key, lvl, n, S)
                    return jnp.stack([
                        test3_hermiticity(Dl, cfg.stencil),
                        test4_hermiticity_full(Dl, vec, cfg.stencil),
                    ]).astype(jnp.float32)

            vals = np.asarray(aot_call(prog, lev.D, key,
                                       key=("mgtests0", cfg, lvl)))
            out[f"lvl{lvl}_test3"] = float(vals[0])
            out[f"lvl{lvl}_test4"] = float(vals[1])
    return out

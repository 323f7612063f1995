"""Krylov accelerators: MG-preconditioned flexible GMRES.

The reference's outer iteration is a stationary MG cycle (f_perform_MG).
For near-critical / indefinite Wilson systems a stationary cycle can
stagnate or diverge even when the MG preconditioner is good; wrapping the
V-cycle in flexible GMRES (right preconditioning, Arnoldi over the
preconditioned directions) is the standard production pattern in lattice
multigrid (cf. the adaptive-MG literature in PAPERS.md). This extends the
reference's capability envelope toward its own near-critical target
regime.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MGConfig
from ..ops.stencil import apply_D
from ..utils.xfer import host_complex
from .cycles import cycle
from .hierarchy import Hierarchy, zero_fields


def _mg_precond(hier, v, cfg, n_cycles: int):
    """Approximate D^{-1} v by n_cycles MG cycles from zero."""
    phis = list(zero_fields(cfg))
    for _ in range(n_cycles):
        phis, _ = cycle(hier, tuple(phis), v, cfg)
        phis = list(phis)
    return phis[0]


def fgmres_solve(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
                 tol: Optional[float] = None, restart: int = 10,
                 max_restarts: int = 50, precond_cycles: int = 1):
    """Flexible GMRES(restart) right-preconditioned by MG cycles.

    Returns (phi, outer_iterations, rel_residual). Host-driven Arnoldi
    (restart <= ~20) with jitted operator/preconditioner applications —
    the small Hessenberg solves run on host in f64.
    """
    tol = tol or cfg.res_threshold
    apply = jax.jit(lambda h, v: apply_D(h.levels[0].D, v))
    prec = jax.jit(lambda h, v: _mg_precond(h, v, cfg, precond_cycles))

    from ..utils.xfer import device_zeros_like
    bnorm = float(jnp.linalg.norm(b.ravel()))
    x = device_zeros_like(b)
    total_iters = 0

    for outer in range(max_restarts):
        r = b - apply(hier, x)
        beta = float(jnp.linalg.norm(r.ravel()))
        if beta / bnorm < tol:
            return host_complex(x), total_iters, beta / bnorm
        V = [r / beta]
        Z = []
        H = np.zeros((restart + 1, restart), dtype=np.complex128)
        g = np.zeros(restart + 1, dtype=np.complex128)
        g[0] = beta
        k_done = 0
        for k in range(restart):
            z = prec(hier, V[k])
            w = apply(hier, z)
            Z.append(z)
            # modified Gram-Schmidt
            for i in range(k + 1):
                hik = complex(jnp.vdot(V[i].ravel(), w.ravel()))
                H[i, k] = hik
                w = w - hik * V[i]
            hk1 = float(jnp.linalg.norm(w.ravel()))
            H[k + 1, k] = hk1
            k_done = k + 1
            total_iters += 1
            if hk1 < 1e-14 * bnorm:
                break
            V.append(w / hk1)
            # cheap residual estimate via least squares
            y, res_ls, *_ = np.linalg.lstsq(H[:k + 2, :k + 1], g[:k + 2],
                                            rcond=None)
            est = np.linalg.norm(H[:k + 2, :k + 1] @ y - g[:k + 2])
            if est / bnorm < tol:
                break
        y, *_ = np.linalg.lstsq(H[:k_done + 1, :k_done], g[:k_done + 1],
                                rcond=None)
        dx = sum(complex(y[i]) * Z[i] for i in range(k_done))
        x = x + dx

    r = b - apply(hier, x)
    rel = float(jnp.linalg.norm(r.ravel())) / bnorm
    return host_complex(x), total_iters, rel


def cgnr_solve(D, b, tol: float = 1e-8, max_iters: int = 50000,
               chunk: int = 500, Ddag=None, x0=None):
    """CG on the normal equations D^H D x = D^H b (CGNR).

    The indefinite-regime workhorse: D^H D is Hermitian positive
    definite for ANY invertible D, so CGNR converges where stationary
    MG, restarted (F)GMRES and (EO-)MR all stall — measured on the
    reference's literal near-critical config (wilson m=-0.07 on a
    beta=32 ensemble, where min Re lambda ~ -0.05: fgmres(20)+MG and
    eo_mr plateau at ~0.2 rel residual; CGNR reaches 4e-15). The price
    is the squared condition number — two stencil applies per
    iteration, ~1e3 iterations at 64^2. Reference context: mgrid_ntl.cpp:51's example mass is
    exactly this regime on weak-coupling ensembles (PARITY.md "Known
    deviations").

    Returns (x, iters, rel_true_residual). Chunked fori_loop programs
    via utils.compile.aot_call; f64 norm accumulation in x64 mode.
    Ddag: optional precomputed adjoint stencil (ops.stencil.
    adjoint_stencil(D) otherwise).
    """
    from ..ops.stencil import adjoint_stencil, _sumsq
    from ..utils.compile import aot_call
    from ..utils.xfer import device_zeros_like

    if Ddag is None:
        Ddag = adjoint_stencil(D)

    def A(Dl, Dd, v):
        return apply_D(Dd, apply_D(Dl, v))

    def init(Dl, Dd, b, x):
        r = apply_D(Dd, b - apply_D(Dl, x))
        rs = _sumsq(r)
        return r, r, rs

    def run_chunk(Dl, Dd, b, x, r, p, rs):
        def body(_, s):
            x, r, p, rs = s
            Ap = A(Dl, Dd, p)
            pAp = jnp.real(jnp.sum(jnp.conj(p) * Ap, dtype=Ap.dtype))
            # alpha cast to the field's real dtype BEFORE multiplying:
            # under x64 the f64 accumulator would otherwise promote the
            # c64 field math to complex128 (twice the bytes)
            alpha = (rs / jnp.maximum(pAp, 1e-300)).astype(x.real.dtype)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = _sumsq(r)
            beta = (rs_new / jnp.maximum(rs, 1e-300)).astype(x.real.dtype)
            p = r + beta.astype(p.dtype) * p
            return x, r, p, rs_new
        x, r, p, rs = jax.lax.fori_loop(0, chunk, body, (x, r, p, rs))
        true_rn = jnp.sqrt(_sumsq(b - apply_D(Dl, x)))
        return x, r, p, rs, true_rn.astype(jnp.float32)

    bn = float(jnp.sqrt(float(aot_call(
        lambda bb: _sumsq(bb).astype(jnp.float32), b,
        key=("cgnr_bn", b.shape, str(b.dtype))))))
    x = x0 if x0 is not None else device_zeros_like(b)
    r, p, rs = aot_call(init, D, Ddag, b, x,
                        key=("cgnr_init", D.shape, str(D.dtype)))
    it = 0
    rel = float("inf")
    while it < max_iters:
        x, r, p, rs, rn = aot_call(
            run_chunk, D, Ddag, b, x, r, p, rs,
            key=("cgnr", D.shape, str(D.dtype), chunk))
        it += chunk
        rel = float(rn) / bn
        if rel < tol or not np.isfinite(rel):
            break
    return x, it, rel


def cgnr_solve_ir(D64, D_host, b_host, tol: float = 1e-8,
                  inner_tol: float = 1e-5, inner_max: int = 6000,
                  max_outer: int = 10, chunk: int = 500):
    """CGNR with f64-plane defect correction — reach true-f64 residuals
    (1e-8 and below) with the iterations in complex64: inner CGNR runs
    in complex64, the outer residual r = b - D x is computed on separate
    F64 real/imag planes (ops.stencil.apply_D_planes), identical math to
    a complex128 outer loop.

    D64: device complex64 stencil. D_host/b_host: complex128 numpy
    (host) exact operator and rhs. Returns dict(rel=..., outer=...,
    inner_iters=...).
    """
    from ..ops.stencil import adjoint_stencil, apply_D_planes
    from ..utils.compile import aot_call
    from ..utils.xfer import device_complex

    rdt = jnp.float64
    Dre = jnp.asarray(np.real(D_host), rdt)
    Dim = jnp.asarray(np.imag(D_host), rdt)
    bre = jnp.asarray(np.real(b_host), rdt)
    bim = jnp.asarray(np.imag(b_host), rdt)
    bn = float(np.sqrt(np.sum(np.abs(b_host) ** 2)))
    Ddag64 = adjoint_stencil(D64)

    pre = jnp.zeros_like(bre)
    pim = jnp.zeros_like(bim)
    rre, rim = bre, bim
    total_inner = 0
    rel = float("inf")
    outer = 0

    def to_c64(rre, rim, inv_s):
        return ((rre * inv_s).astype(jnp.float32)
                + 1j * (rim * inv_s).astype(jnp.float32)
                ).astype(jnp.complex64)

    def outer_step(Dre, Dim, pre, pim, bre, bim, ere, eim, s):
        pre2 = pre + s * ere.astype(rdt)
        pim2 = pim + s * eim.astype(rdt)
        dre, dim = apply_D_planes(Dre, Dim, pre2, pim2)
        rre2, rim2 = bre - dre, bim - dim
        rn = jnp.sqrt(jnp.sum(rre2 * rre2 + rim2 * rim2))
        return pre2, pim2, rre2, rim2, rn

    for outer in range(1, max_outer + 1):
        rn = float(aot_call(
            lambda a, bb: jnp.sqrt(jnp.sum(a * a + bb * bb)
                                   ).astype(jnp.float32),
            rre, rim, key=("cgnr_ir_rn", rre.shape)))
        if rn == 0.0:
            break
        inv = jnp.asarray(1.0 / rn, rdt)
        r64 = aot_call(lambda a, bb, s: to_c64(a, bb, s), rre, rim, inv,
                       key=("cgnr_ir_cast", rre.shape))
        e, it, _ = cgnr_solve(D64, r64, tol=inner_tol,
                              max_iters=inner_max, chunk=chunk,
                              Ddag=Ddag64)
        total_inner += it
        ere = aot_call(lambda z: jnp.real(z), e,
                       key=("cgnr_ir_re", e.shape))
        eim = aot_call(lambda z: jnp.imag(z), e,
                       key=("cgnr_ir_im", e.shape))
        pre, pim, rre, rim, rn2 = aot_call(
            outer_step, Dre, Dim, pre, pim, bre, bim, ere, eim,
            jnp.asarray(rn, rdt),
            key=("cgnr_ir_outer", Dre.shape))
        rel = float(rn2) / bn
        if rel < tol or not np.isfinite(rel):
            break
    return {"rel": rel, "outer": outer, "inner_iters": total_inner,
            "phi_planes": (np.asarray(pre), np.asarray(pim))}

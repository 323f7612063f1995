"""Stationary smoothers: Jacobi, red-black Gauss-Seidel, lexicographic GS,
Chebyshev polynomial.

Update rule (reference Level::f_relax, level.h:100-128):
    phi(x) <- -D0(x)^{-1} ( sum_{mu != 0} D_mu(x) phi(x+mu) - r(x) )

- ``jacobi``  : buffered update; bit-matches the reference gs_flag=0 path.
- ``rbgs``    : red/black-ordered Gauss-Seidel — the data-parallel GS with
  the same asymptotic smoothing factor as the reference's lexicographic GS
  (gs_flag=1) but a parallel iteration order.
- ``gs_lex``  : exact lexicographic GS via a wavefront scan over diagonals —
  slow, for trajectory-matching validation against the reference only.
- ``chebyshev``: degree-k Chebyshev polynomial in the Jacobi-preconditioned
  operator A = D0^{-1} D, optimal high-mode damping on a known spectral
  interval (beyond the reference; intervals from solver/eigs.py). For
  Hermitian-definite systems (laplace); per-application cost equals Jacobi.

D0^{-1} is precomputed per level (see ops/stencil.site_inverse).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .stencil import apply_hop, _site_matvec


def _local_solve(D0inv, hop, r):
    return -_site_matvec(D0inv, hop - r)


def jacobi_sweep(D, D0inv, phi, r, omega: float = 1.0):
    new = _local_solve(D0inv, apply_hop(D, phi), r)
    if omega == 1.0:
        return new
    return phi + omega * (new - phi)


def _parity_mask(L: int, dtype):
    x = jnp.arange(L)[:, None]
    y = jnp.arange(L)[None, :]
    return ((x + y) % 2).astype(dtype)  # 0 = red, 1 = black


def rbgs_sweep(D, D0inv, phi, r, omega: float = 1.0):
    L = phi.shape[-1]
    par = _parity_mask(L, phi.real.dtype)
    red = (1.0 - par)[None]
    black = par[None]
    upd = _local_solve(D0inv, apply_hop(D, phi), r)
    phi = phi + omega * red * (upd - phi)
    upd = _local_solve(D0inv, apply_hop(D, phi), r)
    phi = phi + omega * black * (upd - phi)
    return phi


def gs_lex_sweep(D, D0inv, phi, r, omega: float = 1.0):
    """Exact lexicographic Gauss-Seidel matching the reference's in-place
    site order — `for x { for y { update } }` (level.h:114-123).

    Data-parallel wavefront formulation: for the 5-point stencil, a site
    (x, y)'s same-sweep dependencies (already-updated neighbors it reads:
    (x-1,y), (x,y-1), and the periodic wraps (0,y)<-(L-1,y),
    (x,0)<-(x,L-1)) all lie on anti-diagonals d' = x+y strictly smaller
    than its own d = x + y, while its not-yet-updated neighbors lie on
    larger d'. Sweeping d = 0..2L-2 and updating each full anti-diagonal
    in parallel therefore reproduces the lexicographic trajectory EXACTLY
    (bitwise: each site update is a single expression of the same inputs)
    in 2L-1 steps instead of L^2.
    """
    L = phi.shape[-1]
    x = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
    y = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
    diag = x + y

    def body(d, phi):
        upd = _local_solve(D0inv, apply_hop(D, phi), r)
        if omega != 1.0:
            upd = phi + omega * (upd - phi)
        return jnp.where((diag == d)[None], upd, phi)

    return jax.lax.fori_loop(0, 2 * L - 1, body, phi)


def chebyshev_smooth(D, D0inv, phi, r, degree: int, lmin: float,
                     lmax: float):
    """Degree-`degree` Chebyshev iteration on A e = f with A = D0^{-1} D,
    f = D0^{-1} r, eigenvalues of A assumed in [lmin, lmax] (positive).

    Classic three-term recurrence (Saad, Iterative Methods §12.2): the
    error is multiplied by the scaled-and-shifted Chebyshev polynomial
    that is minimal on [lmin, lmax] — the optimal degree-k stationary
    smoother for that interval. Each step costs one stencil apply, same
    as a Jacobi sweep.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def A(v):
        return _site_matvec(D0inv, _apply_full(D, v))

    f = _site_matvec(D0inv, r)
    d = (f - A(phi)) / theta
    x = phi + d
    rho0 = jnp.asarray(1.0 / sigma1, phi.real.dtype)

    def body(_, s):
        x, d, rho_prev = s
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        d = (rho * rho_prev).astype(x.dtype) * d \
            + (2.0 * rho / delta).astype(x.dtype) * (f - A(x))
        return x + d, d, rho

    x, _, _ = jax.lax.fori_loop(0, degree - 1, body, (x, d, rho0))
    return x


def _apply_full(D, v):
    return _site_matvec(D[0], v) + apply_hop(D, v)


_SWEEPS = {"jacobi": jacobi_sweep, "rbgs": rbgs_sweep, "gs_lex": gs_lex_sweep}


def smooth(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
           omega: float = 1.0, cheby_interval=None):
    """Run n_sweeps smoother sweeps (reference f_relax's num_iter loop).

    kind='chebyshev' runs ONE degree-n_sweeps Chebyshev polynomial (same
    stencil-apply count as n_sweeps Jacobi sweeps); `cheby_interval` is
    its (lmin, lmax) spectral interval.
    """
    if kind == "chebyshev":
        if cheby_interval is None:
            raise ValueError("chebyshev smoother needs cheby_interval="
                             "(lmin, lmax); see solver.eigs")
        return chebyshev_smooth(D, D0inv, phi, r, n_sweeps,
                                *cheby_interval)
    sweep = _SWEEPS[kind]

    def body(_, phi):
        return sweep(D, D0inv, phi, r, omega)

    return jax.lax.fori_loop(0, n_sweeps, body, phi)

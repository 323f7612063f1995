"""Even-odd (red/black Schur-complement) preconditioned solves.

A capability beyond the reference (which always iterates on the full
lattice): for any 5-point stencil operator the hopping terms connect only
sites of opposite checkerboard parity, so in the (even, odd) site ordering

    D = [[ Dee, Deo ],        Dee/Doo = site-diagonal blocks (D[SAME]),
         [ Doe, Doo ]]        Deo/Doe = the hopping terms,

and the solve reduces to the even-site Schur system

    S x_e = b_e - Deo Doo^{-1} b_o,   S = Dee - Deo Doo^{-1} Doe,
    x_o  = Doo^{-1} (b_o - Doe x_e).

This is the standard lattice-QCD "even-odd preconditioning": S acts on
half the sites, and for Wilson-like operators spec(S) = {d - h^2/d}
squares the hopping contribution — roughly squaring the convergence rate
of relaxation/Krylov methods while halving the work per application.

Formulation: fields stay full [n, L, L] arrays with parity
*support* instead of packed half-lattices — `apply_hop` maps an
even-supported field to an odd-supported one by construction (every
neighbor of an even site is odd), so no masking is needed inside the
iteration and every application remains the same fused XLA/Pallas
stencil kernel as the full solve. (Packing to [n, L, L/2] would halve
bandwidth but break the (8,128) tile alignment and the shared kernels;
the measured iteration-count gain dominates.)

Reference parity anchor: the checkerboard split is the same red/black
coloring as ops/smoothers.rbgs (reference gs ordering, level.h:114-123);
the Schur algebra itself has no reference counterpart.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SAME
from ..ops.stencil import apply_D, apply_hop, _site_matvec, site_inverse


def parity_mask(L: int, dtype) -> jnp.ndarray:
    """[1, L, L] mask: 1.0 on EVEN sites ((x+y) % 2 == 0), else 0."""
    x = jnp.arange(L)[:, None]
    y = jnp.arange(L)[None, :]
    return (((x + y) % 2) == 0).astype(dtype)[None]


def schur_apply(D: jnp.ndarray, D0inv: jnp.ndarray,
                xe: jnp.ndarray) -> jnp.ndarray:
    """S xe for an even-supported field xe (odd sites zero).

    hop(xe) is odd-supported, D0inv * that stays odd-supported, hop again
    lands back on even sites — so the result is even-supported with no
    explicit masking.
    """
    t = _site_matvec(D0inv, apply_hop(D, xe))
    return _site_matvec(D[SAME], xe) - apply_hop(D, t)


def eo_reduce(D: jnp.ndarray, D0inv: jnp.ndarray, b: jnp.ndarray):
    """Split b and form the even-site Schur RHS.

    Returns (be_hat, bo) with be_hat = b_e - Deo Doo^{-1} b_o.
    """
    even = parity_mask(b.shape[-1], b.real.dtype)
    bo = b * (1.0 - even)
    be = b * even
    be_hat = be - even * apply_hop(D, _site_matvec(D0inv, bo))
    return be_hat, bo


def eo_reconstruct(D: jnp.ndarray, D0inv: jnp.ndarray, xe: jnp.ndarray,
                   bo: jnp.ndarray) -> jnp.ndarray:
    """Back-substitute the odd sites: x = xe + Doo^{-1}(b_o - Doe xe)."""
    even = parity_mask(xe.shape[-1], xe.real.dtype)
    xo = _site_matvec(D0inv, bo - (1.0 - even) * apply_hop(D, xe))
    return xe + (1.0 - even) * xo


def eo_mr_solve(D: jnp.ndarray, b: jnp.ndarray, tol: float = 1e-8,
                max_iters: int = 100000, chunk: int = 1000):
    """Minimal-residual iteration on the even-odd Schur system.

    Same update rule as driver.mr_solve but on S (half the active sites,
    ~squared spectral contraction); convergence is declared on the FULL
    system's relative residual ||b - D x|| / ||b||. Returns
    (x, schur_iters, full_relres).
    """
    from ..utils.compile import aot_call

    D0inv = site_inverse(D[SAME])
    be_hat, bo = eo_reduce(D, D0inv, b)

    def run_chunk(D, D0inv, x, r):
        def body(i, s):
            x, r = s
            Sr = schur_apply(D, D0inv, r)
            alpha = (jnp.sum(jnp.conj(Sr) * r)
                     / jnp.sum(jnp.conj(Sr) * Sr))
            return x + alpha * r, r - alpha * Sr

        x, r = jax.lax.fori_loop(0, chunk, body, (x, r))
        return x, r, jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))

    def full_rel(D, D0inv, xe, bo, b):
        x = eo_reconstruct(D, D0inv, xe, bo)
        res = b - apply_D(D, x)
        return x, jnp.sqrt(jnp.sum(jnp.abs(res) ** 2)
                           / jnp.sum(jnp.abs(b) ** 2))

    # With x_o back-substituted exactly, the odd rows of b - D x vanish
    # identically and the even rows equal the Schur residual — so the
    # Schur residual norm IS the full residual norm; divide by ||b||.
    from ..utils.xfer import device_zeros_like
    bn = float(jnp.sqrt(jnp.sum(jnp.abs(b) ** 2)))
    xe, r = device_zeros_like(b), be_hat
    key = ("eo_mr", D.shape, str(D.dtype), chunk)
    it = 0
    while it < max_iters:
        xe, r, rn = aot_call(run_chunk, D, D0inv, xe, r, key=key)
        it += chunk
        rel = float(rn) / bn
        if rel < tol or not np.isfinite(rel):
            break
    x, rel = aot_call(full_rel, D, D0inv, xe, bo, b,
                      key=key + ("reconstruct",))
    return x, it, float(rel)

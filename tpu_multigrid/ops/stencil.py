"""Gauge-covariant 5-point stencil application (SpMV) and residuals.

This is the hot kernel of the whole library (reference Level::f_apply_D /
f_residue, level.h:61-77, 251-265). Fields are dof-major, lattice-last:
``v[n, L, L]``; the stencil is ``D[5, n, n, L, L]``.

The SpMV is 5 shifted (n x n)·(n) site-local contractions — each an
elementwise multiply-add over L x L planes, which XLA fuses into
bandwidth-bound loops. At level 0 of a Wilson hierarchy the cycle uses the
links-only form in ops/gauge_stencil.py instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SAME, XP, XM, YP, YM

# Precision of every contraction on the cycle path. On the GPU an f32 or
# c64 contraction handed to cuBLAS may otherwise run in TF32 (~3 decimal
# digits); these contractions are bandwidth-bound, so full precision costs
# nothing measurable and keeps the c64 residual plateau where it belongs.
HIGHEST = jax.lax.Precision.HIGHEST

# Lattice axes: x = -2, y = -1. Site (x+1, y) of field v is roll(v, -1, -2).
_SHIFTS = {XP: (-1, -2), XM: (1, -2), YP: (-1, -1), YM: (1, -1)}


def shift(v: jnp.ndarray, d: int) -> jnp.ndarray:
    """Return the field of neighbor values in direction d (d in {1..4})."""
    s, ax = _SHIFTS[d]
    return jnp.roll(v, s, axis=ax)


def _site_matvec(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Per-site (n x n) @ (n): M[n,n,L,L] v[n,L,L] -> [n,L,L]."""
    return jnp.einsum("ijxy,jxy->ixy", M, v, precision=HIGHEST)


def apply_hop(D: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Off-diagonal part: sum_{mu != 0} D_mu(x) v(x + mu)."""
    out = _site_matvec(D[XP], shift(v, XP))
    out += _site_matvec(D[XM], shift(v, XM))
    out += _site_matvec(D[YP], shift(v, YP))
    out += _site_matvec(D[YM], shift(v, YM))
    return out


def apply_D(D: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Full SpMV: (D v)(x) = D0(x) v(x) + sum_mu D_mu(x) v(x+mu).

    Matches reference Level::f_apply_D (level.h:251-265).
    """
    return _site_matvec(D[SAME], v) + apply_hop(D, v)


def apply_D_unrolled(D: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """apply_D with the (tiny) dof contractions unrolled into a pure
    elementwise graph over [L, L] planes.

    The einsum form lowers to per-direction dot_generals whose results
    XLA may materialize. Here every operation is an elementwise
    multiply-add over lattice planes, which XLA can fuse into one
    bandwidth-bound pass that reads each D plane once. Identical math
    (n is 1/2/4)."""
    n = v.shape[0]
    vs = (v, shift(v, XP), shift(v, XM), shift(v, YP), shift(v, YM))
    rows = []
    for i in range(n):
        acc = None
        for d in range(5):
            for j in range(n):
                t = D[d, i, j] * vs[d][j]
                acc = t if acc is None else acc + t
        rows.append(acc)
    return jnp.stack(rows)


def residual(D: jnp.ndarray, phi: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """b - D phi (reference Level::f_residue, level.h:61-77)."""
    return r - apply_D(D, phi)


def apply_D_planes(Dre, Dim, vre, vim):
    """apply_D with complex held as separate real/imag planes.

    Used by solve_ir(planes=True), whose outer step holds complex128 state
    as F64 plane pairs. Identical math to apply_D on Dre+1j*Dim.
    Returns (out_re, out_im)."""
    def mv(d, vr, vi):
        return (_site_matvec(Dre[d], vr) - _site_matvec(Dim[d], vi),
                _site_matvec(Dre[d], vi) + _site_matvec(Dim[d], vr))

    out_r, out_i = mv(SAME, vre, vim)
    for d in (XP, XM, YP, YM):
        orr, oii = mv(d, shift(vre, d), shift(vim, d))
        out_r += orr
        out_i += oii
    return out_r, out_i


def _sumsq(x) -> jnp.ndarray:
    """Sum of |x|^2 with f64 accumulation when x64 is enabled — keeps the
    convergence check meaningful in complex64 roofline mode (SURVEY §7.3:
    'dot-product accumulations in f64')."""
    import jax
    acc = jnp.float64 if jax.config.jax_enable_x64 else None
    return jnp.sum(jnp.abs(x) ** 2, dtype=acc)


def residual_norm_ratio(D, phi, r) -> jnp.ndarray:
    """||r - D phi|| / ||r|| (reference f_get_residue_mag, level.h:79-98)."""
    res = residual(D, phi, r)
    num = jnp.sqrt(_sumsq(res))
    den = jnp.sqrt(_sumsq(r))
    return (num / den).astype(r.real.dtype)


def adjoint_stencil(D: jnp.ndarray) -> jnp.ndarray:
    """Stencil of the adjoint operator: apply_D(adjoint_stencil(D), v)
    == (D^H v) for any v.

    (D^H v)(x) = sum_y D(y, x)^H v(y): the same-site block conjugate-
    transposes in place; the +mu plane of D^H at site x is the
    -mu block stored at x+mu, i.e. shift(D[-mu], +mu)^H (and vice
    versa). For the reference's operators this reproduces hermiticity
    (laplace: D^H = D) and gamma5-hermiticity (wilson: D^H = g5 D g5),
    pinned by tests/test_krylov.py; it is valid for ANY 5-point block
    stencil, including Galerkin coarse operators.
    """
    def ct(M):
        return jnp.conj(jnp.swapaxes(M, 0, 1))

    return jnp.stack([
        ct(D[SAME]),
        ct(shift(D[XM], XP)),
        ct(shift(D[XP], XM)),
        ct(shift(D[YM], YP)),
        ct(shift(D[YP], YM)),
    ])


def site_inverse(M: jnp.ndarray) -> jnp.ndarray:
    """Per-site inverse of the diagonal block D0: [n,n,L,L] -> [n,n,L,L].

    Precomputed once per level — the reference recomputes D0.inverse() per
    site per sweep (level.h:116), a known inefficiency we do not replicate.
    """
    n = M.shape[0]
    if n == 1:
        return 1.0 / M
    if n == 2:
        # closed form: elementwise over [L,L] planes, no batched LU of
        # 2x2 blocks
        a, b = M[0, 0], M[0, 1]
        c, d = M[1, 0], M[1, 1]
        det = a * d - b * c
        return jnp.stack([jnp.stack([d, -b]),
                          jnp.stack([-c, a])]) / det
    # Move dof axes last for batched linalg: [L,L,n,n]
    Mm = jnp.moveaxis(M, (0, 1), (-2, -1))
    inv = jnp.linalg.inv(Mm)
    return jnp.moveaxis(inv, (-2, -1), (0, 1))


def nnz_per_site(n: int) -> int:
    """Nonzeros of the 5-point block stencil per lattice site."""
    return 5 * n * n

"""Galerkin coarse-operator construction: D_c = Phi D_f Phi^dagger.

The coarse operator keeps the same 5-point block-stencil format as the fine
operator — the key invariant that makes the MG hierarchy recursive
(reference f_compute_coarse_matrix, modules_main.h:81-185).

Data-parallel formulation: instead of looping blocks and testing face
membership per site (the reference's `if (xf == base.x + block_x-1)`
branches), we compute, for each stencil direction mu, the per-fine-site
triple product  M_mu(x) = Phi(x) D_mu(x) Phi(x+mu)^dagger  as one batched
einsum over the lattice, reshape to the block frame, and split the block
axis by slicing: interior positions accumulate into the coarse diagonal,
face positions into the corresponding coarse off-diagonal. No gathers, no
data-dependent control flow.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import SAME, XP, XM, YP, YM
from .stencil import shift
from .transfer import to_block_frame, _blocked


def coarse_operator(D: jnp.ndarray, phi_null: jnp.ndarray, quad: int,
                    bx: int, by: int) -> jnp.ndarray:
    """Build D_c[5, nc, nc, Lc, Lc] from D[5, nf, nf, L, L] and
    phi_null[nc, nf, L, L] for blocking quadrant `quad`."""
    P = to_block_frame(phi_null, quad)          # [nc, nf, L, L]
    Db = to_block_frame(D, quad)                # [5, nf, nf, L, L]
    Pc = jnp.conj(P)

    def triple(d: int) -> jnp.ndarray:
        """M_d[a, b, L, L] = sum_{f,g} P[a,f] Dd[f,g] conj(P_shifted[b,g])."""
        if d == SAME:
            Pn = Pc
        else:
            Pn = shift(Pc, d)                  # neighbor site's Phi^*, in block frame
        half = jnp.einsum("afxy,fgxy->agxy", P, Db[d])
        return jnp.einsum("agxy,bgxy->abxy", half, Pn)

    nc = phi_null.shape[0]
    L = D.shape[-1]
    Lc = L // bx

    # Blocked triple products: [nc, nc, Lc, bx, Lc, by]
    M0 = _blocked(triple(SAME), bx, by)
    M1 = _blocked(triple(XP), bx, by)
    M2 = _blocked(triple(XM), bx, by)
    M3 = _blocked(triple(YP), bx, by)
    M4 = _blocked(triple(YM), bx, by)

    bsum = lambda m: jnp.sum(m, axis=(3, 5))   # sum over block positions

    # Diagonal: same-site terms + intra-block neighbor terms
    # (reference modules_main.h:128-144: +x allowed unless on the +x face, etc.)
    dc0 = (bsum(M0)
           + bsum(M1[:, :, :, :bx - 1])        # x-position a < bx-1
           + bsum(M2[:, :, :, 1:])             # a > 0
           + bsum(M3[:, :, :, :, :, :by - 1])  # y-position b < by-1
           + bsum(M4[:, :, :, :, :, 1:]))

    # Off-diagonals: cross-block face terms only (modules_main.h:148-155).
    dc1 = jnp.sum(M1[:, :, :, bx - 1], axis=4)   # +x face -> coarse +x
    dc2 = jnp.sum(M2[:, :, :, 0], axis=4)        # -x face -> coarse -x
    dc3 = jnp.sum(M3[:, :, :, :, :, by - 1], axis=3)
    dc4 = jnp.sum(M4[:, :, :, :, :, 0], axis=3)

    return jnp.stack([dc0, dc1, dc2, dc3, dc4])

"""Aggregation-based transfer operators: restriction / prolongation with
near-null vectors, block normalization, and quadrant blocking geometry.

Near-null vectors are stored as ``phi_null[nc, nf, L, L]`` — for each fine
site, an (nc x nf) matrix whose rows are the (conjugated) near-null vectors;
restriction is vec_c(X) = sum_{x in block(X)} Phi(x) vec_f(x) and
prolongation its adjoint (reference near_null.h:217-264).

Quadrant blocking (the key non-telescoping ingredient): quadrant q offsets
the block origin by (0,0), (-1,0), (-1,-1), (0,-1) for q=1..4 (reference
f_get_base_site, modules_indiv.h:6-14). Here this is a pair of `jnp.roll`s
into the "block frame" where blocks are axis-aligned, followed by a reshape
to [.., Lc, bx, Lc, by] — no gather/scatter needed.
"""
from __future__ import annotations

import jax.numpy as jnp

from .stencil import HIGHEST

# quad -> block-origin offset (ox, oy); base = block * Xc + offset.
QUAD_OFFSETS = {1: (0, 0), 2: (-1, 0), 3: (-1, -1), 4: (0, -1)}


def to_block_frame(v: jnp.ndarray, quad: int) -> jnp.ndarray:
    """Roll so fine site (base + (a,b)) lands at block position (a,b)."""
    ox, oy = QUAD_OFFSETS[quad]
    if ox:
        v = jnp.roll(v, -ox, axis=-2)
    if oy:
        v = jnp.roll(v, -oy, axis=-1)
    return v


def from_block_frame(v: jnp.ndarray, quad: int) -> jnp.ndarray:
    ox, oy = QUAD_OFFSETS[quad]
    if ox:
        v = jnp.roll(v, ox, axis=-2)
    if oy:
        v = jnp.roll(v, oy, axis=-1)
    return v


def _blocked(v: jnp.ndarray, bx: int, by: int) -> jnp.ndarray:
    """[..., Lx, Ly] -> [..., Lx/bx, bx, Ly/by, by].

    Handles rectangular extents — local shard tiles of a sharded lattice
    are (L/mesh_x, L/mesh_y)."""
    Lx, Ly = v.shape[-2], v.shape[-1]
    lead = v.shape[:-2]
    return v.reshape(*lead, Lx // bx, bx, Ly // by, by)


def restrict(phi_null: jnp.ndarray, vf: jnp.ndarray, quad: int,
             bx: int, by: int) -> jnp.ndarray:
    """vec_c[nc, Lc, Lc] = sum_block Phi vf (reference near_null.h:217-240)."""
    pb = _blocked(to_block_frame(phi_null, quad), bx, by)  # [nc,nf,Lc,bx,Lc,by]
    vb = _blocked(to_block_frame(vf, quad), bx, by)        # [nf,Lc,bx,Lc,by]
    return jnp.einsum("cfXaYb,fXaYb->cXY", pb, vb,
                      precision=HIGHEST)


def prolong(phi_null: jnp.ndarray, vc: jnp.ndarray, quad: int,
            bx: int, by: int) -> jnp.ndarray:
    """vec_f[nf, L, L] = Phi^dagger vec_c (reference near_null.h:242-264)."""
    pb = _blocked(to_block_frame(phi_null, quad), bx, by)
    vfb = jnp.einsum("cfXaYb,cXY->fXaYb", jnp.conj(pb), vc,
                     precision=HIGHEST)
    nf = vfb.shape[0]
    Lx, Ly = vfb.shape[1] * vfb.shape[2], vfb.shape[3] * vfb.shape[4]
    return from_block_frame(vfb.reshape(nf, Lx, Ly), quad)


def block_norms(v: jnp.ndarray, quad: int, bx: int, by: int) -> jnp.ndarray:
    """Per-block 2-norm over (dof, block sites): [Lc, Lc] real."""
    vb = _blocked(to_block_frame(v, quad), bx, by)
    return jnp.sqrt(jnp.sum(jnp.abs(vb) ** 2, axis=(0, 2, 4)))


def block_normalize(v: jnp.ndarray, quad: int, bx: int, by: int) -> jnp.ndarray:
    """Divide each block by its norm (reference f_block_norm,
    modules_indiv.h:94-135). NaN/tiny-norm guarding is done by the caller
    (solver.setup) on the host, mirroring the reference's exit(1) guards."""
    vb = _blocked(to_block_frame(v, quad), bx, by)
    norms = jnp.sqrt(jnp.sum(jnp.abs(vb) ** 2, axis=(0, 2, 4)))
    vb = vb / norms[None, :, None, :, None]
    return from_block_frame(vb.reshape(v.shape), quad)


def block_dot(u: jnp.ndarray, v: jnp.ndarray, quad: int, bx: int, by: int):
    """Per-block complex dot <u, v> = sum_block conj(u)·v : [Lc, Lc]."""
    ub = _blocked(to_block_frame(u, quad), bx, by)
    vb = _blocked(to_block_frame(v, quad), bx, by)
    return jnp.einsum("fXaYb,fXaYb->XY", jnp.conj(ub), vb,
                      precision=HIGHEST)


def ortho_pass(phi_null: jnp.ndarray, quad: int, bx: int, by: int):
    """One block-Gram-Schmidt pass over the near-null rows.

    Row d1 is orthogonalized against rows d2 < d1 per block, then
    block-normalized (reference Near_null::f_ortho, near_null.h:97-173).
    nc is tiny (<= 4) so the row loops unroll in Python; each step is a
    fully vectorized per-block reduction over the lattice.
    """
    nc = phi_null.shape[0]
    rows = [phi_null[d] for d in range(nc)]
    for d1 in range(nc):
        cur = rows[d1]
        for d2 in range(d1):
            prev = rows[d2]
            dot = block_dot(prev, cur, quad, bx, by)       # [Lc, Lc]
            nrm = block_norms(prev, quad, bx, by)          # == 1 after norm,
            coef = dot / nrm                               # kept for parity
            # broadcast coef over the block
            cb = _blocked(to_block_frame(cur, quad), bx, by)
            pb = _blocked(to_block_frame(prev, quad), bx, by)
            cb = cb - coef[None, :, None, :, None] * pb
            cur = from_block_frame(cb.reshape(cur.shape), quad)
        rows[d1] = block_normalize(cur, quad, bx, by)
    return jnp.stack(rows)


def normalize_rows(phi_null: jnp.ndarray, quad: int, bx: int, by: int):
    """Block-normalize every near-null row (reference f_norm_nn,
    near_null.h:24-48)."""
    return jnp.stack([block_normalize(phi_null[d], quad, bx, by)
                      for d in range(phi_null.shape[0])])


def check_ortho(phi_null: jnp.ndarray, quad: int, bx: int, by: int):
    """Max pairwise block-dot magnitude between distinct rows (reference
    f_check_ortho tolerance 1e-12, near_null.h:175-214). Returns a scalar."""
    nc = phi_null.shape[0]
    worst = jnp.zeros((), dtype=phi_null.real.dtype)
    for d1 in range(nc):
        for d2 in range(d1):
            dots = block_dot(phi_null[d1], phi_null[d2], quad, bx, by)
            worst = jnp.maximum(worst, jnp.max(jnp.abs(dots)))
    return worst

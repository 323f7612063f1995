"""Halo exchange for lattice fields sharded over a 2D device mesh.

The L x L torus is block-partitioned over mesh axes ('x', 'y'); the 5-point
stencil needs a width-1 halo of neighbor sites, exchanged with
`jax.lax.ppermute`, which XLA hands to NCCL on the GPU. The lattice's
periodic boundary wraps the mesh axes cyclically (SURVEY.md §5.7-5.8; the
reference is single-process, modules_main.h has no comms, so this whole
module is new capability).

All functions here are meant to run INSIDE `jax.shard_map` with the lattice
axes of every field sharded as P(..., 'x', 'y').
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SAME, XP, XM, YP, YM
from ..ops.stencil import _site_matvec

AXIS_X = "x"   # mesh axis partitioning the lattice x (array axis -2)
AXIS_Y = "y"   # mesh axis partitioning the lattice y (array axis -1)


def _perm(axis_name: str, up: bool):
    """Cyclic permutation along a mesh axis; up=True sends shard i -> i-1
    (so every shard receives data from its +1 neighbor)."""
    n = lax.axis_size(axis_name)
    if up:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def shift_halo(v: jnp.ndarray, d: int) -> jnp.ndarray:
    """Sharded analog of ops.stencil.shift: field of neighbor values in
    direction d, with the shard-boundary column/row fetched by ppermute.

    v: local block [..., lx, ly].
    """
    if d == XP:      # value at (x+1): need my +x neighbor's first column
        edge = lax.ppermute(v[..., :1, :], AXIS_X, _perm(AXIS_X, up=True))
        return jnp.concatenate([v[..., 1:, :], edge], axis=-2)
    if d == XM:      # value at (x-1): need my -x neighbor's last column
        edge = lax.ppermute(v[..., -1:, :], AXIS_X, _perm(AXIS_X, up=False))
        return jnp.concatenate([edge, v[..., :-1, :]], axis=-2)
    if d == YP:
        edge = lax.ppermute(v[..., :, :1], AXIS_Y, _perm(AXIS_Y, up=True))
        return jnp.concatenate([v[..., :, 1:], edge], axis=-1)
    if d == YM:
        edge = lax.ppermute(v[..., :, -1:], AXIS_Y, _perm(AXIS_Y, up=False))
        return jnp.concatenate([edge, v[..., :, :-1]], axis=-1)
    raise ValueError(f"bad direction {d}")


def roll_halo(v: jnp.ndarray, shift: int, axis: int) -> jnp.ndarray:
    """Sharded jnp.roll for |shift| == 1 on lattice axes (-2, -1).

    roll(v, +1, ax)[i] = v[i-1]  => equals shift_halo 'minus' direction.
    """
    if shift == 0:
        return v
    assert shift in (1, -1) and axis in (-2, -1)
    if axis == -2:
        return shift_halo(v, XM if shift == 1 else XP)
    return shift_halo(v, YM if shift == 1 else YP)


# --- sharded versions of the core stencil ops -----------------------------

def apply_hop_sharded_concat(D, v):
    """Baseline hop: ppermute each edge, concatenate, then contract —
    the boundary columns serialize behind the permutes."""
    out = _site_matvec(D[XP], shift_halo(v, XP))
    out += _site_matvec(D[XM], shift_halo(v, XM))
    out += _site_matvec(D[YP], shift_halo(v, YP))
    out += _site_matvec(D[YM], shift_halo(v, YM))
    return out


def halo_edges(v):
    """Issue all four width-1 edge ppermutes up front. Returns
    (ex_p, ex_m, ey_p, ey_m): the neighbor rows/columns this shard needs
    — from the +x neighbor (its first row), the -x neighbor (last row),
    and likewise in y."""
    ex_p = lax.ppermute(v[..., :1, :], AXIS_X, _perm(AXIS_X, up=True))
    ex_m = lax.ppermute(v[..., -1:, :], AXIS_X, _perm(AXIS_X, up=False))
    ey_p = lax.ppermute(v[..., :, :1], AXIS_Y, _perm(AXIS_Y, up=True))
    ey_m = lax.ppermute(v[..., :, -1:], AXIS_Y, _perm(AXIS_Y, up=False))
    return ex_p, ex_m, ey_p, ey_m


def apply_hop_sharded_overlap(D, v):
    """Hop with the interior/boundary split (SURVEY §5.8, §7.1): the four
    edge ppermutes are issued FIRST, then the interior hop-sum — which
    depends only on local data — is computed, and finally the boundary
    row/column contributions are patched in as the edges land. The
    interior einsum has no data dependence on the permutes, so XLA's
    latency-hiding scheduler can run the transfers concurrently with
    the interior stencil compute. Identical math to the concat path
    (same per-site contractions; only the association of the boundary
    terms differs) — pinned by tests/test_parallel.py."""
    ex_p, ex_m, ey_p, ey_m = halo_edges(v)

    # interior: neighbor fields with zero-filled shard boundaries
    zrow = jnp.zeros_like(v[..., :1, :])
    zcol = jnp.zeros_like(v[..., :, :1])
    xp_i = jnp.concatenate([v[..., 1:, :], zrow], axis=-2)
    xm_i = jnp.concatenate([zrow, v[..., :-1, :]], axis=-2)
    yp_i = jnp.concatenate([v[..., :, 1:], zcol], axis=-1)
    ym_i = jnp.concatenate([zcol, v[..., :, :-1]], axis=-1)
    out = _site_matvec(D[XP], xp_i)
    out += _site_matvec(D[XM], xm_i)
    out += _site_matvec(D[YP], yp_i)
    out += _site_matvec(D[YM], ym_i)

    # boundary patch: the one row/column each direction missed
    out = out.at[..., -1:, :].add(
        _site_matvec(D[XP][..., -1:, :], ex_p))
    out = out.at[..., :1, :].add(
        _site_matvec(D[XM][..., :1, :], ex_m))
    out = out.at[..., :, -1:].add(
        _site_matvec(D[YP][..., :, -1:], ey_p))
    out = out.at[..., :, :1].add(
        _site_matvec(D[YM][..., :, :1], ey_m))
    return out


def apply_hop_sharded(D, v, overlap: bool = True):
    """Sharded hop-sum; overlap=True (default) uses the
    interior/boundary-split schedule, False the concat baseline."""
    if overlap:
        return apply_hop_sharded_overlap(D, v)
    return apply_hop_sharded_concat(D, v)


def apply_D_sharded(D, v, overlap: bool = True):
    return (_site_matvec(D[SAME], v)
            + apply_hop_sharded(D, v, overlap))


def residual_sharded(D, phi, r, overlap: bool = True):
    return r - apply_D_sharded(D, phi, overlap)


def global_norm_sharded(v):
    s = jnp.sum(jnp.abs(v) ** 2)
    return jnp.sqrt(lax.psum(s, (AXIS_X, AXIS_Y)))


def residual_norm_ratio_sharded(D, phi, r, overlap: bool = True):
    res = residual_sharded(D, phi, r, overlap)
    num = jnp.sum(jnp.abs(res) ** 2)
    den = jnp.sum(jnp.abs(r) ** 2)
    num, den = lax.psum(jnp.stack([num, den]), (AXIS_X, AXIS_Y))
    return jnp.sqrt(num) / jnp.sqrt(den)


def _global_parity_offset(dtype):
    """(x+y) parity offset of this shard's origin. Requires even local
    extents (asserted by the sharded smoother) so the offset is 0 — kept
    explicit for clarity and future odd-tile support."""
    return jnp.zeros((), dtype=dtype)


def jacobi_sweep_sharded(D, D0inv, phi, r, omega: float = 1.0,
                         overlap: bool = True):
    new = -_site_matvec(D0inv, apply_hop_sharded(D, phi, overlap) - r)
    if omega == 1.0:
        return new
    return phi + omega * (new - phi)


def rbgs_sweep_sharded(D, D0inv, phi, r, omega: float = 1.0,
                       overlap: bool = True):
    lx, ly = phi.shape[-2], phi.shape[-1]
    assert lx % 2 == 0 and ly % 2 == 0, (
        "sharded red-black GS requires even local tiles")
    x = jnp.arange(lx)[:, None]
    y = jnp.arange(ly)[None, :]
    par = ((x + y) % 2).astype(phi.real.dtype)
    red, black = (1.0 - par)[None], par[None]
    upd = -_site_matvec(D0inv, apply_hop_sharded(D, phi, overlap) - r)
    phi = phi + omega * red * (upd - phi)
    upd = -_site_matvec(D0inv, apply_hop_sharded(D, phi, overlap) - r)
    phi = phi + omega * black * (upd - phi)
    return phi


def chebyshev_smooth_sharded(D, D0inv, phi, r, degree: int, lmin: float,
                             lmax: float, overlap: bool = True):
    """Sharded Chebyshev smoother: identical three-term recurrence to
    ops.smoothers.chebyshev_smooth with the halo-exchange stencil apply —
    the spectral interval is a static per-level config constant
    (cfg.cheby_intervals, filled by solver.eigs.chebyshev_config), so no
    extra collectives are needed beyond the apply's ppermute halos."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def A(v):
        return _site_matvec(D0inv, apply_D_sharded(D, v, overlap))

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

    x, _, _ = lax.fori_loop(0, degree - 1, body, (x, d, rho0))
    return x


def smooth_sharded(D, D0inv, phi, r, n_sweeps: int, kind: str,
                   omega: float = 1.0, cheby_interval=None,
                   overlap: bool = True):
    if kind == "chebyshev":
        if cheby_interval is None:
            raise ValueError("chebyshev smoother needs cheby_interval="
                             "(lmin, lmax); see solver.eigs")
        return chebyshev_smooth_sharded(D, D0inv, phi, r, n_sweeps,
                                        *cheby_interval, overlap=overlap)
    sweep = {"jacobi": jacobi_sweep_sharded,
             "rbgs": rbgs_sweep_sharded}[kind]

    def body(_, phi):
        return sweep(D, D0inv, phi, r, omega, overlap)

    return lax.fori_loop(0, n_sweeps, body, phi)

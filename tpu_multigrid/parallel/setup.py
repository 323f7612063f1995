"""Distributed adaptive setup: near-null generation, block
orthogonalization and Galerkin coarsening under shard_map.

The single-device setup (solver/hierarchy.py) is one jitted program per
level; this module provides the same pipeline with the fine lattice
block-partitioned over the ('x','y') mesh, so setup scales to lattices
that don't fit one chip:

- near-null relaxation: halo-exchange smoother sweeps + psum global norms
- block normalization / Gram-Schmidt: blocks are tile-local (local tiles
  are block-aligned), so per-block reductions need no collectives; only
  the quadrant roll costs a halo exchange
- Galerkin: per-direction triple products with halo-shifted Phi*,
  face/interior splits remain static local slices

Coarse levels below the shardability threshold gather to replicated and
reuse the single-device ops, mirroring parallel/sharded.py's solve-side
strategy.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MGConfig, SAME, XP, XM, YP, YM
from ..ops import transfer
from ..ops.stencil import site_inverse
from ..ops.nearnull import candidates_to_phi_null, random_starts
from ..ops.transfer import _blocked
from ..solver.hierarchy import Hierarchy, LevelOps, build_ntl
from . import halo
from .halo import AXIS_X, AXIS_Y, shift_halo, smooth_sharded
from .sharded import (_gather_lattice, _quad_roll_sharded, shardable_levels,
                      _lat_spec)


def _block_normalize_sharded(v, quad, bx, by):
    vb = _blocked(_quad_roll_sharded(v, quad, True), bx, by)
    norms = jnp.sqrt(jnp.sum(jnp.abs(vb) ** 2, axis=(0, 2, 4)))
    vb = vb / norms[None, :, None, :, None]
    return _quad_roll_sharded(vb.reshape(v.shape), quad, False)


def _block_dot_sharded(u, v, quad, bx, by):
    ub = _blocked(_quad_roll_sharded(u, quad, True), bx, by)
    vb = _blocked(_quad_roll_sharded(v, quad, True), bx, by)
    return jnp.einsum("fXaYb,fXaYb->XY", jnp.conj(ub), vb)


def _ortho_pass_sharded(phi_null, quad, bx, by):
    nc = phi_null.shape[0]
    rows = [phi_null[d] for d in range(nc)]
    for d1 in range(nc):
        cur = rows[d1]
        for d2 in range(d1):
            prev = rows[d2]
            dot = _block_dot_sharded(prev, cur, quad, bx, by)
            nrm = jnp.sqrt(jnp.sum(jnp.abs(_blocked(
                _quad_roll_sharded(prev, quad, True), bx, by)) ** 2,
                axis=(0, 2, 4)))
            coef = dot / nrm
            cb = _blocked(_quad_roll_sharded(cur, quad, True), bx, by)
            pb = _blocked(_quad_roll_sharded(prev, quad, True), bx, by)
            cb = cb - coef[None, :, None, :, None] * pb
            cur = _quad_roll_sharded(cb.reshape(cur.shape), quad, False)
        rows[d1] = _block_normalize_sharded(cur, quad, bx, by)
    return jnp.stack(rows)


def _coarse_operator_sharded(D, phi_null, quad, bx, by):
    """Galerkin with halo-shifted neighbor Phi* (cf. ops/galerkin.py)."""
    Pn = _quad_roll_sharded(phi_null, quad, True)
    Db = _quad_roll_sharded(D, quad, True)
    Pc = jnp.conj(Pn)

    def triple(d):
        Pngb = Pc if d == SAME else shift_halo(Pc, d)
        half = jnp.einsum("afxy,fgxy->agxy", Pn, Db[d])
        return jnp.einsum("agxy,bgxy->abxy", half, Pngb)

    M0 = _blocked(triple(SAME), bx, by)
    M1 = _blocked(triple(XP), bx, by)
    M2 = _blocked(triple(XM), bx, by)
    M3 = _blocked(triple(YP), bx, by)
    M4 = _blocked(triple(YM), bx, by)
    bsum = lambda m: jnp.sum(m, axis=(3, 5))
    dc0 = (bsum(M0) + bsum(M1[:, :, :, :bx - 1]) + bsum(M2[:, :, :, 1:])
           + bsum(M3[:, :, :, :, :, :by - 1]) + bsum(M4[:, :, :, :, :, 1:]))
    dc1 = jnp.sum(M1[:, :, :, bx - 1], axis=4)
    dc2 = jnp.sum(M2[:, :, :, 0], axis=4)
    dc3 = jnp.sum(M3[:, :, :, :, :, by - 1], axis=3)
    dc4 = jnp.sum(M4[:, :, :, :, :, 0], axis=3)
    return jnp.stack([dc0, dc1, dc2, dc3, dc4])


def _relax_null_sharded(D, D0inv, starts, cfg: MGConfig):
    """Near-null relaxation with halo smoother + psum global renorm.
    Candidates looped in Python (<= 2) — vmap over collectives is avoided."""
    zero = jnp.zeros_like(starts[0])
    blocks = max(cfg.null_iters // cfg.iters_per_norm, 1)
    kind = cfg.smoother if cfg.smoother != "gs_lex" else "rbgs"

    def one(v):
        def body(_, v):
            v = smooth_sharded(D, D0inv, v, zero, cfg.iters_per_norm,
                               kind, cfg.omega, overlap=cfg.halo_overlap)
            n = jnp.sqrt(lax.psum(jnp.sum(jnp.abs(v) ** 2),
                                  (AXIS_X, AXIS_Y)))
            return v / n
        return lax.fori_loop(0, blocks, body, v)

    if not cfg.null_joint_qr:
        return jnp.stack([one(starts[k]) for k in range(starts.shape[0])])

    # joint variant (MGConfig.null_joint_qr): psum-reduced global MGS of
    # the candidate set at every renorm point (see ops/nearnull)
    nk = starts.shape[0]

    def mgs(vs):
        out = []
        for i in range(nk):
            v = vs[i]
            for u in out:
                d = lax.psum(jnp.sum(jnp.conj(u) * v), (AXIS_X, AXIS_Y))
                v = v - u * d
            n = jnp.sqrt(lax.psum(jnp.sum(jnp.abs(v) ** 2),
                                  (AXIS_X, AXIS_Y)))
            out.append(v / jnp.where(n > 0, n, 1.0))
        return jnp.stack(out)

    def body(_, vs):
        vs = jnp.stack([
            smooth_sharded(D, D0inv, vs[i], zero, cfg.iters_per_norm,
                           kind, cfg.omega, overlap=cfg.halo_overlap)
            for i in range(nk)])
        return mgs(vs)

    return lax.fori_loop(0, blocks, body, mgs(starts))


def build_hierarchy_sharded(D0: jnp.ndarray, cfg: MGConfig, mesh: Mesh,
                            key=None) -> Hierarchy:
    """Distributed analog of solver.hierarchy.build_hierarchy: fine-level
    setup runs sharded over the mesh; sub-threshold levels run replicated
    on the gathered fields. Returns a Hierarchy of GLOBAL arrays
    (device-sharded per hierarchy_specs)."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    sh = shardable_levels(cfg, mesh)
    bx, by = cfg.block_x, cfg.block_y
    levels = []
    D = D0

    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        nf, nc = cfg.n_dof[lvl], cfg.n_dof[lvl + 1]
        S = cfg.sizes[lvl]
        k = nc // 2 if cfg.stencil == "wilson" else nc
        starts = random_starts(sub, k, nf, S, cfg.cdtype)

        if sh[lvl]:
            def level_prog(D, starts):
                D0inv = site_inverse(D[0])
                vecs = _relax_null_sharded(D, D0inv, starts, cfg)
                pn = candidates_to_phi_null(vecs, cfg.stencil, nc)
                # HIGHEST matmul precision for ortho + Galerkin: TF32
                # on the GPU is too coarse for them, as in the
                # single-device setup (hierarchy._setup_level_core)
                with jax.default_matmul_precision("highest"):
                    pn = jnp.stack([
                        _block_normalize_sharded(pn[d], cfg.quad, bx, by)
                        for d in range(nc)])
                    for _ in range(cfg.ortho_passes):
                        pn = _ortho_pass_sharded(pn, cfg.quad, bx, by)
                    Dc = _coarse_operator_sharded(D, pn, cfg.quad, bx, by)
                if not sh[lvl + 1]:
                    Dc = _gather_lattice(Dc)
                return D0inv, pn, Dc

            lat = (AXIS_X, AXIS_Y)
            in_specs = (P(None, None, None, *lat), P(None, None, *lat))
            out_specs = (P(None, None, *lat), P(None, None, *lat),
                         P(None, None, None, *lat) if sh[lvl + 1] else P())
            prog = jax.jit(jax.shard_map(level_prog, mesh=mesh,
                                         in_specs=in_specs,
                                         out_specs=out_specs,
                                         check_vma=False))
            D0inv, pn, Dc = prog(D, starts)
        else:
            from ..solver.hierarchy import _setup_level_jit
            D0inv, pn, Dc, _ = _setup_level_jit(D, starts, cfg, lvl,
                                                cfg.quad, True)
        levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=pn))
        D = Dc

    levels.append(LevelOps(D=D, D0inv=site_inverse(D[0]), phi_null=None))
    ntl = build_ntl(levels, cfg, check=False) if cfg.ntl else None
    return Hierarchy(levels=tuple(levels), ntl=ntl)

"""Distributed multigrid: the full (NTL-)V-cycle solver as one
`shard_map` program over a 2D device mesh.

Design (SURVEY.md §5.7-5.8, §7.1):
- Fine levels are block-partitioned over mesh axes ('x','y'); every stencil
  op uses width-1 halo exchange via `ppermute` (parallel.halo).
- Coarse levels below a shardability threshold are REPLICATED: restriction
  output is `all_gather`ed once per transition (coarse fields are tiny) and
  every device redundantly runs the identical coarse solve — no further
  comms until prolongation slices the local tile back out.
- The 4 NTL quadrant copies run at the replicated coarsest level (vmapped
  per device); minimal-residual Gram matrices use `psum` reductions.
- Restriction/prolongation are comm-free where block tiles align with
  shards; the quadrant offsets (q=2..4) cost one halo roll each.

The reference has no distribution at all (§2.3); this module is the
multi-device scaling layer.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import MGConfig
from ..ops import transfer
from ..ops.smoothers import smooth
from ..ops.stencil import HIGHEST, apply_D, residual
from ..solver.hierarchy import Hierarchy, LevelOps, NTLOps
from ..solver.cycles import min_res_weights
from . import halo
from .halo import (AXIS_X, AXIS_Y, apply_D_sharded, residual_sharded,
                   residual_norm_ratio_sharded, smooth_sharded, roll_halo)


def make_mesh(shape: Tuple[int, int], devices=None) -> Mesh:
    """2D device mesh with axes ('x','y') partitioning the lattice."""
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    n = shape[0] * shape[1]
    return Mesh(np.asarray(devices[:n]).reshape(shape), (AXIS_X, AXIS_Y))


def shardable_levels(cfg: MGConfig, mesh: Mesh) -> Tuple[bool, ...]:
    """Level l is sharded iff the local tile is block-aligned and even.
    Once a level is replicated all coarser levels are too."""
    mx, my = mesh.shape[AXIS_X], mesh.shape[AXIS_Y]
    out = []
    ok = True
    for l in range(cfg.nlevels + 1):
        S = cfg.sizes[l]
        lx, ly = S // mx, S // my
        ok = (ok and S % mx == 0 and S % my == 0
              and lx % 2 == 0 and ly % 2 == 0
              and lx % cfg.block_x == 0 and ly % cfg.block_y == 0
              and l < cfg.nlevels)       # coarsest level always replicated
        out.append(ok)
    return tuple(out)


def _lat_spec(n_lead: int, sharded: bool) -> P:
    """PartitionSpec for an array with n_lead leading dims then (x, y)."""
    if sharded:
        return P(*([None] * n_lead), AXIS_X, AXIS_Y)
    return P()


def hierarchy_specs(hier: Hierarchy, cfg: MGConfig, mesh: Mesh) -> Hierarchy:
    """Pytree of PartitionSpecs mirroring a Hierarchy."""
    sh = shardable_levels(cfg, mesh)
    levels = []
    for l, lev in enumerate(hier.levels):
        levels.append(LevelOps(
            D=_lat_spec(3, sh[l]),
            D0inv=_lat_spec(2, sh[l]),
            phi_null=None if lev.phi_null is None else _lat_spec(2, sh[l]),
        ))
    ntl = None
    if hier.ntl is not None:
        lvl = cfg.nlevels - 1
        ntl = NTLOps(phi_null=_lat_spec(3, sh[lvl]),
                     D=P(), D0inv=P())   # NTL coarse data replicated
    gauge = None if hier.gauge is None else _lat_spec(1, sh[0])
    return Hierarchy(levels=tuple(levels), ntl=ntl, gauge=gauge)


def field_specs(cfg: MGConfig, mesh: Mesh) -> Tuple[P, ...]:
    sh = shardable_levels(cfg, mesh)
    return tuple(_lat_spec(1, sh[l]) for l in range(cfg.nlevels + 1))


# --- sharded <-> replicated transitions -----------------------------------

def _gather_lattice(v):
    """Local tile [.., lx, ly] -> full lattice (replicated value)."""
    v = lax.all_gather(v, AXIS_X, axis=-2, tiled=True)
    v = lax.all_gather(v, AXIS_Y, axis=-1, tiled=True)
    return v


def _my_tile(v, mesh: Mesh):
    """Slice this device's tile out of a replicated lattice array."""
    mx, my = mesh.shape[AXIS_X], mesh.shape[AXIS_Y]
    lx, ly = v.shape[-2] // mx, v.shape[-1] // my
    ix = lax.axis_index(AXIS_X)
    iy = lax.axis_index(AXIS_Y)
    v = lax.dynamic_slice_in_dim(v, ix * lx, lx, axis=-2)
    return lax.dynamic_slice_in_dim(v, iy * ly, ly, axis=-1)


# --- transfers on sharded levels ------------------------------------------

def _restrict_sharded(phi_null, vf, quad, bx, by):
    """Both fields are local tiles; quadrant roll crosses shard
    boundaries via halo exchange, blocking is then tile-local."""
    pn = _quad_roll_sharded(phi_null, quad, fwd=True)
    vb = _quad_roll_sharded(vf, quad, fwd=True)
    pb = transfer._blocked(pn, bx, by)
    vbb = transfer._blocked(vb, bx, by)
    return jnp.einsum("cfXaYb,fXaYb->cXY", pb, vbb, precision=HIGHEST)


def _prolong_sharded(phi_null, vc, quad, bx, by):
    pn = _quad_roll_sharded(phi_null, quad, fwd=True)
    pb = transfer._blocked(pn, bx, by)
    vfb = jnp.einsum("cfXaYb,cXY->fXaYb", jnp.conj(pb), vc,
                     precision=HIGHEST)
    nf = vfb.shape[0]
    lx, ly = vfb.shape[1] * vfb.shape[2], vfb.shape[3] * vfb.shape[4]
    vf = vfb.reshape(nf, lx, ly)
    return _quad_roll_sharded(vf, quad, fwd=False)


def _quad_roll_sharded(v, quad, fwd: bool):
    ox, oy = transfer.QUAD_OFFSETS[quad]
    sx, sy = (-ox, -oy) if fwd else (ox, oy)
    if sx:
        v = roll_halo(v, sx, -2)
    if sy:
        v = roll_halo(v, sy, -1)
    return v


# --- the sharded cycle -----------------------------------------------------

def effective_smoother(cfg, warn: bool = False) -> str:
    """The smoother the distributed cycle actually runs.

    gs_lex (host-sequential wavefront ordering) is inherently
    single-device: the distributed cycle maps it to rbgs, the
    same-smoothing-factor parallel ordering — the iteration trajectory
    therefore differs from the single-device run. jacobi/rbgs/chebyshev
    run natively sharded (chebyshev's spectral intervals are static
    config constants, so only the apply's halos communicate)."""
    if cfg.smoother in ("jacobi", "rbgs", "chebyshev"):
        return cfg.smoother
    if warn:
        import warnings
        warnings.warn(
            f"sharded cycle downgrades smoother '{cfg.smoother}' to 'rbgs' "
            f"(same smoothing factor, different iteration trajectory)",
            stacklevel=3)
    return "rbgs"


def _cheby_interval(cfg, lvl: int):
    return (cfg.cheby_intervals[lvl]
            if effective_smoother(cfg) == "chebyshev" else None)


def _relax(lev, phi, r, cfg, sharded: bool, lvl: int):
    kind = effective_smoother(cfg)
    ci = _cheby_interval(cfg, lvl)
    if sharded:
        return smooth_sharded(lev.D, lev.D0inv, phi, r, cfg.num_iters,
                              kind, cfg.omega, cheby_interval=ci,
                              overlap=cfg.halo_overlap)
    return smooth(lev.D, lev.D0inv, phi, r, cfg.num_iters, kind, cfg.omega,
                  cheby_interval=ci)


def _min_res_weights_sharded(D_f, r_f, xs_list, cfg):
    """Gram matrix + source with psum-reduced inner products; xs are local
    tiles at a sharded level. Mirrors cycles.min_res_weights."""
    nq = len(xs_list)
    Dx = [apply_D_sharded(D_f, x, cfg.halo_overlap) for x in xs_list]
    A = jnp.stack([jnp.stack([jnp.sum(jnp.conj(xs_list[p]) * Dx[q])
                              for q in range(nq)]) for p in range(nq)])
    mode = cfg.minres_src
    if mode == "auto":
        mode = "r_dot_dx" if cfg.stencil == "wilson" else "x_dot_r"
    if mode == "x_dot_r":
        src = jnp.stack([jnp.sum(jnp.conj(x) * r_f) for x in xs_list])
    else:
        src = jnp.stack([jnp.sum(jnp.conj(r_f) * d) for d in Dx])
    A = lax.psum(A, (AXIS_X, AXIS_Y))
    src = lax.psum(src, (AXIS_X, AXIS_Y))
    return jnp.linalg.solve(A, src)


def _ntl_coarse_solves_submesh(ntl, r_q, phi_shape, cfg: MGConfig,
                               mesh: Mesh):
    """Distribute the n_copies independent coarse solves across device
    sub-groups (the north star's 'all coarse levels run concurrently
    across sub-meshes'): device (ix, iy) relaxes only the copy
    q = (ix*my + iy) mod n_copies, and the full copy stack is
    reassembled with a one-hot psum. With >= n_copies devices each device
    does one coarse relax instead of n_copies."""
    nq = cfg.n_copies
    my = mesh.shape[AXIS_Y]
    dev = lax.axis_index(AXIS_X) * my + lax.axis_index(AXIS_Y)
    n_dev = mesh.shape[AXIS_X] * my
    my_copy = dev % nq

    D_me = jnp.take(ntl.D[:nq], my_copy, axis=0)
    Dinv_me = jnp.take(ntl.D0inv[:nq], my_copy, axis=0)
    r_me = jnp.take(jnp.stack(r_q), my_copy, axis=0)
    kind = effective_smoother(cfg)
    phi_me = smooth(D_me, Dinv_me, jnp.zeros(phi_shape, r_me.dtype), r_me,
                    cfg.num_iters, kind, cfg.omega,
                    cheby_interval=_cheby_interval(cfg, cfg.nlevels))

    # number of devices assigned to each copy (static)
    counts = jnp.asarray([max(1, len([d for d in range(n_dev)
                                      if d % nq == q]))
                          for q in range(nq)], dtype=phi_me.real.dtype)
    onehot = (jnp.arange(nq) == my_copy).astype(phi_me.dtype)
    contrib = onehot[:, None, None, None] * phi_me[None]
    phi_q = lax.psum(contrib, (AXIS_X, AXIS_Y))
    return phi_q / counts[:, None, None, None].astype(phi_q.dtype)


def make_sharded_cycle(cfg: MGConfig, mesh: Mesh,
                       ntl_submesh: bool = True):
    """Build cycle_fn(hier, phis, b) -> (phis, resmag) to be used inside
    shard_map (all args already local tiles / replicated per the specs)."""
    effective_smoother(cfg, warn=True)   # surface any smoother downgrade once
    sh = shardable_levels(cfg, mesh)
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y

    def residual_of(lev, phi, r, l):
        return (residual_sharded(lev.D, phi, r, cfg.halo_overlap) if sh[l]
                else residual(lev.D, phi, r))

    def restrict_step(pn, res, quad, l):
        """Restrict level-l residual to level l+1, handling the
        sharded->replicated transition."""
        if sh[l]:
            rc = _restrict_sharded(pn, res, quad, bx, by)
            if not sh[l + 1]:
                rc = _gather_lattice(rc)
            return rc
        return transfer.restrict(pn, res, quad, bx, by)

    def prolong_step(pn, vc, quad, l):
        """Prolongate level-(l+1) correction to level l."""
        if sh[l]:
            if not sh[l + 1]:
                vc = _my_tile(vc, mesh)
            return _prolong_sharded(pn, vc, quad, bx, by)
        return transfer.prolong(pn, vc, quad, bx, by)

    def cycle_fn(hier: Hierarchy, phis, b):
        L = hier.levels
        phis = list(phis)
        rs = [b] + [None] * n
        ntl_on = cfg.ntl and n > 0
        down_end = (n - 1) if ntl_on else n

        for l in range(down_end):
            phis[l] = _relax(L[l], phis[l], rs[l], cfg, sh[l], l)
            res = residual_of(L[l], phis[l], rs[l], l)
            rs[l + 1] = restrict_step(L[l].phi_null, res, cfg.quad, l)
            phis[l + 1] = jnp.zeros_like(phis[l + 1])

        if ntl_on:
            l = n - 1
            phis[l] = _relax(L[l], phis[l], rs[l], cfg, sh[l], l)
            res = residual_of(L[l], phis[l], rs[l], l)
            nq = cfg.n_copies
            r_q = [restrict_step(hier.ntl.phi_null[q], res, q + 1, l)
                   for q in range(nq)]
            n_dev = mesh.shape[AXIS_X] * mesh.shape[AXIS_Y]
            if ntl_submesh and n_dev >= nq:
                # Concurrent coarse copies across device sub-groups.
                phi_q = _ntl_coarse_solves_submesh(
                    hier.ntl, r_q, phis[n].shape, cfg, mesh)
            else:
                # Replicated coarse solves, all copies on every device.
                phi_q0 = jnp.zeros((nq,) + phis[n].shape, phis[n].dtype)
                relax_q = jax.vmap(
                    lambda D, Dinv, p, r: smooth(
                        D, Dinv, p, r, cfg.num_iters,
                        effective_smoother(cfg), cfg.omega,
                        cheby_interval=_cheby_interval(cfg, cfg.nlevels)))
                phi_q = relax_q(hier.ntl.D[:nq], hier.ntl.D0inv[:nq],
                                phi_q0, jnp.stack(r_q))
            combine = cfg.ntl_combine
            if combine == "auto":
                combine = "minres" if cfg.min_res else "avg_prolong"
            if combine == "avg_coarse":
                # gen-2 single-interpolation variant (see solver.cycles).
                phi_avg = jnp.mean(phi_q, axis=0)
                corr = prolong_step(hier.ntl.phi_null[cfg.quad - 1],
                                    phi_avg, cfg.quad, l)
            else:
                xs = [prolong_step(hier.ntl.phi_null[q], phi_q[q], q + 1, l)
                      for q in range(nq)]
                if combine == "minres":
                    if sh[l]:
                        a = _min_res_weights_sharded(L[l].D, rs[l], xs, cfg)
                    else:
                        a = min_res_weights(L[l].D, rs[l], jnp.stack(xs),
                                            cfg)
                else:
                    a = jnp.full((nq,), 1.0 / nq, dtype=b.dtype)
                corr = sum(a[q] * xs[q] for q in range(nq))
            phis[l] = phis[l] + corr
            up_start = n - 1
        else:
            up_start = n

        for l in range(up_start, -1, -1):
            phis[l] = _relax(L[l], phis[l], rs[l], cfg, sh[l], l)
            if l > 0:
                corr = prolong_step(L[l - 1].phi_null, phis[l], cfg.quad,
                                    l - 1)
                phis[l - 1] = phis[l - 1] + corr
                phis[l] = jnp.zeros_like(phis[l])

        if sh[0]:
            resmag = residual_norm_ratio_sharded(L[0].D, phis[0], b,
                                                 cfg.halo_overlap)
        else:
            from ..ops.stencil import residual_norm_ratio
            resmag = residual_norm_ratio(L[0].D, phis[0], b)
        return tuple(phis), resmag

    return cycle_fn


def make_sharded_solver(cfg: MGConfig, mesh: Mesh, max_iters: int,
                        ntl_submesh: bool = True):
    """jit(shard_map(while_loop(cycle)))  — the full distributed solve as
    one SPMD program. Returns solver(hier, phis, b) -> (phis, iters, res)."""
    cycle_fn = make_sharded_cycle(cfg, mesh, ntl_submesh)

    def run(hier, phis, b):
        def cond(state):
            _, it, res = state
            return (it < max_iters) & (res > cfg.res_threshold) \
                & (res < cfg.div_threshold)

        def body(state):
            phis, it, _ = state
            phis, res = cycle_fn(hier, phis, b)
            return phis, it + 1, res

        res0 = jnp.ones((), dtype=b.real.dtype)
        return lax.while_loop(cond, body, (phis, jnp.zeros((), jnp.int32),
                                           res0))

    def dummy_hier_specs(hier):
        return hierarchy_specs(hier, cfg, mesh)

    def build(hier):
        h_specs = dummy_hier_specs(hier)
        f_specs = field_specs(cfg, mesh)
        in_specs = (h_specs, f_specs, f_specs[0])
        out_specs = (f_specs, P(), P())
        mapped = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
        return jax.jit(mapped)

    return build


def shard_hierarchy(hier: Hierarchy, cfg: MGConfig, mesh: Mesh) -> Hierarchy:
    """device_put the hierarchy according to its specs."""
    specs = hierarchy_specs(hier, cfg, mesh)
    from jax.sharding import NamedSharding

    def put(x, spec):
        if x is None:
            return None
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, hier, specs,
                                  is_leaf=lambda x: x is None)

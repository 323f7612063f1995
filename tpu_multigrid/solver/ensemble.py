"""Ensemble workflows: batched setup + solve over many gauge
configurations at once.

Lattice-QCD production runs solve the same system on O(100s) of gauge
configurations; the reference loops shell jobs (code/0_submit notebook).
Here the whole pipeline — operator assembly, adaptive near-null setup,
Galerkin coarsening, MG solve — is vmapped over a leading configuration
axis, so one XLA program processes the batch (and the batch axis can be
sharded over a 'config' mesh axis for data-parallel ensembles).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MGConfig
from ..models.operators import assemble
from ..ops.nearnull import random_starts
from ..ops.stencil import residual_norm_ratio
from .cycles import cycle
from .hierarchy import (Hierarchy, LevelOps, _setup_level_jit, zero_fields,
                        _build_ntl_jit)
from ..ops.stencil import site_inverse


def _batched_setup_traced(Ds, starts_per_level, cfg: MGConfig):
    """vmapped per-level setup over the leading config axis."""
    levels = []
    D = Ds
    for lvl in range(cfg.nlevels):
        f = lambda d, s: _setup_level_jit(d, s, cfg, lvl, cfg.quad, True)
        D0inv, pn, Dc, _ = jax.vmap(f)(D, starts_per_level[lvl])
        levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=pn))
        D = Dc
    levels.append(LevelOps(D=D, D0inv=jax.vmap(lambda d: site_inverse(d[0]))(D),
                           phi_null=None))
    ntl = None
    if cfg.ntl:
        lvl = cfg.nlevels - 1
        ntl, _ = jax.vmap(lambda pn, d: _build_ntl_jit(pn, d, cfg))(
            levels[lvl].phi_null, levels[lvl].D)
    return Hierarchy(levels=tuple(levels), ntl=ntl)


def build_hierarchies_batched(Us: jnp.ndarray, cfg: MGConfig,
                              key=None) -> Hierarchy:
    """Batched adaptive setup: Us [batch, 2, L, L] -> Hierarchy whose
    arrays carry a leading batch axis."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    batch = Us.shape[0]
    Ds = jax.vmap(lambda U: assemble(cfg.stencil, U, cfg.m))(Us)
    starts = []
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        nf, nc = cfg.n_dof[lvl], cfg.n_dof[lvl + 1]
        k = nc // 2 if cfg.stencil == "wilson" else nc
        subs = jax.random.split(sub, batch)
        starts.append(jax.vmap(
            lambda kk: random_starts(kk, k, nf, cfg.sizes[lvl],
                                     cfg.cdtype))(subs))
    from ..utils.compile import aot_call
    return aot_call(lambda d, s: _batched_setup_traced(d, s, cfg),
                    Ds, tuple(starts),
                    key=("ensemble_setup", cfg, batch))


def solve_ensemble(hier_b: Hierarchy, bs: jnp.ndarray, cfg: MGConfig,
                   n_cycles: int, mesh=None):
    """Fixed-cycle MG solve vmapped over the batch axis of hierarchies
    and right-hand sides. Returns (phi [batch,n,L,L], rel_res [batch]).

    mesh: optional 1-axis `jax.sharding.Mesh` — the batch axis is then
    sharded over its devices (pure data parallelism: each device solves
    its own configurations, no collectives in the program; the SPMD
    analog of the reference's per-config shell jobs). batch must divide
    by the device count."""
    from ..utils.compile import aot_call

    if mesh is not None:
        if bs.shape[0] % mesh.devices.size:
            raise ValueError(
                f"mesh device count {mesh.devices.size} must evenly "
                f"divide ensemble batch {bs.shape[0]} (shard_ensemble "
                "would silently replicate the whole ensemble otherwise)")
        hier_b, bs = shard_ensemble((hier_b, bs), mesh,
                                    batch=bs.shape[0])

    def one(h, b):
        phis = zero_fields(cfg)

        def body(_, phis):
            phis, _ = cycle(h, phis, b, cfg)
            return phis

        phis = jax.lax.fori_loop(0, n_cycles, body, phis)
        return phis[0], residual_norm_ratio(h.levels[0].D, phis[0], b)

    phi, res = aot_call(lambda h, bb: jax.vmap(one)(h, bb), hier_b, bs,
                        key=("ensemble", cfg, n_cycles, bs.shape[0],
                             None if mesh is None else tuple(mesh.shape.items())))
    from ..utils.xfer import host_complex
    return host_complex(phi), np.asarray(res)


def shard_ensemble(tree, mesh, batch=None):
    """Shard every array leaf's leading (configuration) axis over the
    single mesh axis; scalars/short leaves are replicated.

    batch: when given, only leaves whose leading dim EQUALS the batch
    size are sharded (a non-batch leading axis that merely divides the
    device count must not be split across configurations)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    def put(x):
        lead = getattr(x, "shape", (0,))[0] if getattr(x, "ndim", 0) >= 1 \
            else 0
        is_batch = (lead == batch) if batch is not None \
            else (lead and lead % ndev == 0)
        if is_batch and lead % ndev == 0:
            return jax.device_put(x, NamedSharding(mesh, P(axis)))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, tree)

"""Multigrid hierarchy: per-level operator data as JAX pytrees, and the
adaptive setup pipeline that builds it.

A level is arrays, not objects (SURVEY.md §7.1): the reference's
`class Level` (level.h) becomes `LevelOps` — a registered-dataclass pytree
holding the stencil D, its precomputed diagonal inverse, and the near-null
vectors used for restriction to the next level. Solution/rhs vectors are
carried separately by the cycle functions (pure-functional state).

Setup pipeline (reference f_compute_near_null, modules_main.h:187-222):
per level: generate near-null vectors (relax Dx=0) -> block-normalize ->
double Gram-Schmidt -> verify orthogonality -> Galerkin coarse operator.
NTL: re-orthogonalize a copy of the next-to-coarsest level's near-nulls in
each blocking quadrant and build 4 independent coarse operators.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MGConfig
from ..ops.stencil import site_inverse
from ..ops.transfer import normalize_rows, ortho_pass, check_ortho, block_norms
from ..ops.galerkin import coarse_operator
from ..ops.nearnull import relax_null_vectors, candidates_to_phi_null, random_starts


@partial(jax.tree_util.register_dataclass,
         data_fields=["D", "D0inv", "phi_null"], meta_fields=[])
@dataclasses.dataclass
class LevelOps:
    D: jnp.ndarray                      # [5, n, n, S, S]
    D0inv: jnp.ndarray                  # [n, n, S, S]
    phi_null: Optional[jnp.ndarray]     # [nc, n, S, S] or None at coarsest


@partial(jax.tree_util.register_dataclass,
         data_fields=["phi_null", "D", "D0inv"], meta_fields=[])
@dataclasses.dataclass
class NTLOps:
    """Per-quadrant-copy coarse-level data, stacked on a leading copy axis."""
    phi_null: jnp.ndarray               # [n_copies, nc, nf, Sf, Sf]
    D: jnp.ndarray                      # [n_copies, 5, nc, nc, Sc, Sc]
    D0inv: jnp.ndarray                  # [n_copies, nc, nc, Sc, Sc]


@partial(jax.tree_util.register_dataclass,
         data_fields=["levels", "ntl", "gauge"], meta_fields=[])
@dataclasses.dataclass
class Hierarchy:
    levels: Tuple[LevelOps, ...]        # nlevels + 1 entries
    ntl: Optional[NTLOps]
    # Optional U(1) links [2, L, L] for the level-0 links-only fast path
    # (the reference's closed-form level-0 operator, level.h:131-175):
    # when present and cfg.links allows, wilson level-0 smoother/residual
    # stream the links instead of the assembled dense D
    # (ops/gauge_stencil.py).
    gauge: Optional[jnp.ndarray] = None


def _check_block_norms_host(phi_null, quad, bx, by, where: str):
    """Host-side NaN / tiny-norm guards (reference f_block_norm exit(1)
    guards, modules_indiv.h:119-126; f_check_null_norm, near_null.h:50-94)."""
    for d in range(phi_null.shape[0]):
        n = np.asarray(block_norms(phi_null[d], quad, bx, by))
        if np.isnan(n).any():
            raise FloatingPointError(f"NaN block norm in {where}, row {d}")
        if (n < 1e-40).any():
            raise FloatingPointError(
                f"Tiny block norm ({n.min():.3e}) in {where}, row {d}")


def _setup_level_core(D, start_or_null, cfg: MGConfig, lvl: int, quad: int,
                      generate: bool):
    """One fused XLA program: near-null generation (optional) +
    block-normalize + double Gram-Schmidt + Galerkin coarse operator.

    Keeping the whole per-level setup in a single XLA program matters: the
    eager version dispatches hundreds of small ops, the jitted version is
    one executable per level. Compiled via utils.compile.aot_call, like
    the solver drivers.
    """
    nc = cfg.n_dof[lvl + 1]
    bx, by = cfg.block_x, cfg.block_y
    D0inv = site_inverse(D[0])

    if generate:
        # near-null relaxation is a fixed-sweep Dx=0 relaxation; the
        # chebyshev solve-smoother has no interval yet at setup -> rbgs
        kind = "rbgs" if cfg.smoother == "chebyshev" else cfg.smoother
        vecs = relax_null_vectors(D, D0inv, start_or_null, cfg.null_iters,
                                  cfg.iters_per_norm, kind, cfg.omega,
                                  cfg.null_joint_qr)
        phi_null = candidates_to_phi_null(vecs, cfg.stencil, nc)
    else:
        phi_null = start_or_null

    # Ortho + Galerkin pin HIGHEST matmul precision: on the GPU an f32
    # or c64 contraction may otherwise run in TF32 (~3 decimal digits),
    # far short of the orthonormality the self-tests check (the
    # reference's f_check_ortho bar is 1e-12). These contractions are
    # bandwidth-bound, so the cost is noise; the cycle-path contractions
    # pin it too (ops/stencil.HIGHEST).
    with jax.default_matmul_precision("highest"):
        phi_null = normalize_rows(phi_null, quad, bx, by)
        for _ in range(cfg.ortho_passes):
            phi_null = ortho_pass(phi_null, quad, bx, by)
        worst = check_ortho(phi_null, quad, bx, by)
        Dc = coarse_operator(D, phi_null, quad, bx, by)
    return D0inv, phi_null, Dc, worst


# Jitted aliases for callers that embed the setup program inside a larger
# traced context (vmapped ensemble setup, sharded per-device setup) —
# there the aot_call wrapper is applied by the OUTER program.
_setup_level_jit = partial(jax.jit,
                           static_argnames=("cfg", "lvl", "quad",
                                            "generate"))(_setup_level_core)


def _setup_level(D, cfg: MGConfig, lvl: int, quad: int, key,
                 phi_null_init=None, check: bool = True):
    """Build phi_null and the coarse operator for one level."""
    nf, nc = cfg.n_dof[lvl], cfg.n_dof[lvl + 1]
    S = cfg.sizes[lvl]
    bx, by = cfg.block_x, cfg.block_y

    if phi_null_init is None:
        k = nc // 2 if cfg.stencil == "wilson" else nc
        arg = random_starts(key, k, nf, S, cfg.cdtype)
        generate = True
    else:
        arg = phi_null_init
        generate = False

    from ..utils.compile import aot_call
    D0inv, phi_null, Dc, worst = aot_call(
        lambda d, a: _setup_level_core(d, a, cfg, lvl, quad, generate),
        D, arg, key=("setup_level", cfg, lvl, quad, generate,
                     D.shape, str(D.dtype), arg.shape))
    if check:
        _check_block_norms_host(phi_null, quad, bx, by, f"level {lvl} norm")
        worst = float(worst)
        if worst > _ortho_tol(cfg):
            raise FloatingPointError(
                f"near-null rows not orthogonal at level {lvl}: {worst:.3e}")
    return D0inv, phi_null, Dc


def _ortho_tol(cfg: MGConfig) -> float:
    """Orthogonality-check bar, dtype-aware: the reference's 1e-12 class
    guard (f_check_ortho, near_null.h:175-214) presumes double; a
    healthy complex64 double-Gram-Schmidt lands at ~1e-7 (f32 eps *
    block size), so c64 setups get a correspondingly scaled bar."""
    return 1e-10 if cfg.dtype == "complex128" else 1e-5


def build_hierarchy(D0: jnp.ndarray, cfg: MGConfig, key=None,
                    phi_null_init: Optional[Tuple] = None,
                    check: bool = True, U=None) -> Hierarchy:
    """Construct the full MG hierarchy from the level-0 operator.

    phi_null_init: optional per-level tuple of near-null stacks (e.g. read
    from a reference checkpoint file) — skips generation like gen_null=0.
    U: optional gauge links [2, L, L] — stored on the hierarchy so the
    solve can use the level-0 links-only fast path (cfg.links).
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    levels = []
    D = D0
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        init = None if phi_null_init is None else phi_null_init[lvl]
        D0inv, phi_null, Dc = _setup_level(D, cfg, lvl, cfg.quad, sub,
                                           init, check)
        levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=phi_null))
        D = Dc
    levels.append(LevelOps(D=D, D0inv=site_inverse(D[0]), phi_null=None))

    ntl = None
    if cfg.ntl:
        ntl = build_ntl(levels, cfg, check)
    if U is not None:
        if isinstance(U, np.ndarray):
            from ..utils.xfer import device_complex
            U = device_complex(U, cfg.cdtype)
        else:
            U = U.astype(cfg.cdtype)
    return Hierarchy(levels=tuple(levels), ntl=ntl, gauge=U)


def _build_ntl_core(phi_null0, D, cfg: MGConfig):
    bx, by = cfg.block_x, cfg.block_y
    pns, Ds, Dinvs, worsts = [], [], [], []
    # HIGHEST matmul precision, for the TF32 reason in _setup_level_core:
    # the per-quadrant transfer rows must be orthonormal to the self-test
    # tolerance, and the NTL Galerkin operators inherit their error
    with jax.default_matmul_precision("highest"):
        for q in range(cfg.n_copies):
            quad = q + 1
            pn = normalize_rows(phi_null0, cfg.quad, bx, by)
            for _ in range(cfg.ortho_passes):
                pn = ortho_pass(pn, quad, bx, by)
            worsts.append(check_ortho(pn, quad, bx, by))
            Dc = coarse_operator(D, pn, quad, bx, by)
            pns.append(pn)
            Ds.append(Dc)
            Dinvs.append(site_inverse(Dc[0]))
    ntl = NTLOps(phi_null=jnp.stack(pns), D=jnp.stack(Ds),
                 D0inv=jnp.stack(Dinvs))
    return ntl, jnp.stack(worsts)


_build_ntl_jit = partial(jax.jit, static_argnames=("cfg",))(_build_ntl_core)


def build_ntl(levels, cfg: MGConfig, check: bool = True) -> NTLOps:
    """Per-quadrant re-setup of the coarsest transfer + operator
    (reference modules_main.h:208-221)."""
    lvl = cfg.nlevels - 1
    base = levels[lvl]
    from ..utils.compile import aot_call
    ntl, worsts = aot_call(
        lambda pn, d: _build_ntl_core(pn, d, cfg),
        base.phi_null, base.D,
        key=("build_ntl", cfg, base.phi_null.shape, str(base.D.dtype)))
    if check:
        import numpy as _np
        w = _np.asarray(worsts)
        if (w > _ortho_tol(cfg)).any():
            raise FloatingPointError(f"NTL copies not orthogonal: {w}")
    return ntl


def cast_hierarchy(hier: Hierarchy, cdtype) -> Hierarchy:
    """Cast every operator tensor (D, D0inv, phi_null, NTL copies) to
    `cdtype`. Used by the mixed-precision iterative-refinement solver:
    the hierarchy is built once in complex128 and a complex64 view runs
    the inner cycles."""
    return jax.tree.map(lambda x: x.astype(cdtype), hier)


def zero_fields(cfg: MGConfig) -> Tuple[jnp.ndarray, ...]:
    """Zero solution vectors, one per level."""
    from ..utils.xfer import device_full
    return tuple(
        device_full((cfg.n_dof[l], cfg.sizes[l], cfg.sizes[l]), 0.0,
                    cfg.cdtype)
        for l in range(cfg.nlevels + 1))


def point_source(cfg: MGConfig, value: complex = 5.0,
                 site: Tuple[int, int] = (2, 2)) -> jnp.ndarray:
    """Reference source: r(2 + 2L)(0) = 5.0 => site (x=2, y=2)? The
    reference indexes x + y*L with x=2, y=2 for L>=... actually 2+2*p.L
    means x=2, y=2 (level.h:55-59). dof component 0."""
    from ..utils.xfer import device_full
    r = device_full((cfg.n_dof[0], cfg.L, cfg.L), 0.0, cfg.cdtype)
    return r.at[0, site[0], site[1]].set(value)

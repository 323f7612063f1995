"""Multigrid cycles: telescoping V-cycle and the non-telescoping (NTL)
cycle with minimal-residual recombination of quadrant copies.

Pure functions of (hierarchy, phis, b) -> (phis, aux); the level loop is
unrolled in Python (nlevels <= ~7) so every level's shapes stay static
under jit.

Cycle shape (reference f_MG_simple / f_MG_ntl, modules_main.h:255-280,
386-439): sawtooth V — relax `num_iters` sweeps at each level on the way
down (after which the residual is restricted), and again on the way up
(after which the error is prolongated and added).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import MGConfig
from ..ops import gauge_stencil as gs
from ..ops.stencil import HIGHEST, apply_D, residual, _sumsq
from ..ops.smoothers import smooth
from ..ops.transfer import restrict, prolong
from .hierarchy import Hierarchy


def links_active(cfg: MGConfig, gauge, lvl: int) -> bool:
    """Whether the level-0 links-only (spin-projected) fast path applies:
    gauge links present, wilson stencil, and cfg.links allows (see
    MGConfig.links — 'auto' restricts to complex64 so c128 validation
    trajectories stay bit-stable)."""
    if gauge is None or lvl != 0 or cfg.stencil != "wilson":
        return False
    if cfg.links == "off":
        return False
    if cfg.links == "on":
        return True
    return cfg.dtype == "complex64"


def _relax(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    if cfg.smoother == "chebyshev":
        return smooth(lev.D, lev.D0inv, phi, r, cfg.num_iters, "chebyshev",
                      cheby_interval=cfg.cheby_intervals[lvl])
    if links_active(cfg, gauge, lvl) and cfg.smoother in ("jacobi", "rbgs"):
        return gs.smooth_u(cfg.stencil, gauge, cfg.m, phi, r,
                           cfg.num_iters, cfg.smoother, cfg.omega)
    return smooth(lev.D, lev.D0inv, phi, r, cfg.num_iters, cfg.smoother,
                  cfg.omega)


def _residual0(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    """Level residual with the links-only fast path at level 0."""
    if links_active(cfg, gauge, lvl):
        return gs.residual_u(cfg.stencil, gauge, cfg.m, phi, r)
    return residual(lev.D, phi, r)


def residual_norm_ratio0(hier: Hierarchy, phi, b, cfg: MGConfig):
    """||b - D phi|| / ||b|| at level 0, via the links-only apply when
    active (reference f_get_residue_mag, level.h:79-98)."""
    res = _residual0(hier.levels[0], phi, b, cfg, 0, hier.gauge)
    num = jnp.sqrt(_sumsq(res))
    den = jnp.sqrt(_sumsq(b))
    return (num / den).astype(b.real.dtype)


def v_cycle(hier: Hierarchy, phis: Tuple, b: jnp.ndarray, cfg: MGConfig):
    """One telescoping V-cycle (reference f_MG_simple).

    phis: per-level solution tuple; phis[0] is the running fine solution,
    coarse entries are error corrections (zeroed after each prolongation).
    Returns updated phis. nlevels=0 degenerates to pure relaxation.
    """
    L = hier.levels
    g = hier.gauge
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n

    if n == 0:
        phis[0] = _relax(L[0], phis[0], b, cfg, 0, g)
        return tuple(phis)

    bx, by = cfg.block_x, cfg.block_y
    for l in range(n):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
        rs[l + 1] = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = jnp.zeros_like(phis[l + 1])

    for l in range(n, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            corr = prolong(L[l - 1].phi_null, phis[l], cfg.quad, bx, by)
            phis[l - 1] = phis[l - 1] + corr
            phis[l] = jnp.zeros_like(phis[l])

    return tuple(phis)


def gamma_cycle(hier: Hierarchy, phis: Tuple, b: jnp.ndarray,
                cfg: MGConfig):
    """Recursive gamma-cycle: gamma=1 reproduces the reference's sawtooth
    V-cycle step sequence exactly; gamma=2 is the W-cycle (each coarse
    problem approximately solved by two child cycles) — more robust on
    hard operators at ~1.5x fine-level cost in 2D."""
    L = hier.levels
    g = hier.gauge
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y
    phis = list(phis)
    gamma = cfg.cycle_gamma

    def at(l, rhs):
        phis[l] = _relax(L[l], phis[l], rhs, cfg, l, g)
        if l == n:
            return
        res = _residual0(L[l], phis[l], rhs, cfg, l, g)
        rc = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = jnp.zeros_like(phis[l + 1])
        for _ in range(gamma if l + 1 < n else 1):
            at(l + 1, rc)
        corr = prolong(L[l].phi_null, phis[l + 1], cfg.quad, bx, by)
        phis[l] = phis[l] + corr
        phis[l + 1] = jnp.zeros_like(phis[l + 1])
        phis[l] = _relax(L[l], phis[l], rhs, cfg, l, g)

    if n == 0:
        phis[0] = _relax(L[0], phis[0], b, cfg, 0, g)
    else:
        at(0, b)
    return tuple(phis)


def min_res_weights(D_f, r_f, xs: jnp.ndarray, cfg: MGConfig):
    """Minimal-residual recombination weights for the NTL copies.

    xs: [n_copies, nf, S, S] prolongated candidate corrections at the
    next-to-coarsest level. Builds A_pq = <x_p, D x_q> and the source
    src_p = <x_p, r> (laplace) or <r, D x_p> (wilson) — the reference's
    deliberate asymmetry (modules_main.h:336-340 vs :358-366), selectable
    via cfg.minres_src — then solves the n_copies x n_copies system
    (reference uses colPivHouseholderQr, modules_main.h:371).
    """
    Dx = jax.vmap(lambda x: apply_D(D_f, x))(xs)          # [q, nf, S, S]
    A = jnp.einsum("pnxy,qnxy->pq", jnp.conj(xs), Dx, precision=HIGHEST)
    mode = cfg.minres_src
    if mode == "auto":
        mode = "r_dot_dx" if cfg.stencil == "wilson" else "x_dot_r"
    if mode == "x_dot_r":
        src = jnp.einsum("pnxy,nxy->p", jnp.conj(xs), r_f,
                         precision=HIGHEST)
    elif mode == "r_dot_dx":
        src = jnp.einsum("nxy,pnxy->p", jnp.conj(r_f), Dx,
                         precision=HIGHEST)
    else:
        raise ValueError(f"bad minres_src {mode!r}")
    return jnp.linalg.solve(A, src)


def ntl_cycle(hier: Hierarchy, phis: Tuple, b: jnp.ndarray, cfg: MGConfig):
    """One non-telescoping cycle (reference f_MG_ntl, modules_main.h:386-439).

    At the coarsest transition the residual is restricted 4 independent
    ways (one per blocking quadrant); the 4 coarse problems are solved
    concurrently (vmap over the copy axis — they are independent by
    construction) and their prolongated corrections recombined with
    minimal-residual weights.

    Returns (phis, a_weights).
    """
    L = hier.levels
    g = hier.gauge
    ntl = hier.ntl
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    bx, by = cfg.block_x, cfg.block_y
    nq = cfg.n_copies

    # Down sweep.
    for l in range(n - 1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
        rs[l + 1] = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = jnp.zeros_like(phis[l + 1])

    # Transition level: restrict 4 independent ways.
    l = n - 1
    phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
    res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
    r_q = jnp.stack([
        restrict(ntl.phi_null[q], res, q + 1, bx, by) for q in range(nq)])

    # Coarse solves, all copies concurrently.
    phi_q0 = jnp.zeros((nq,) + phis[n].shape, phis[n].dtype)
    cheby_n = (cfg.cheby_intervals[n] if cfg.smoother == "chebyshev"
               else None)
    relax_q = jax.vmap(
        lambda D, Dinv, p, r: smooth(D, Dinv, p, r, cfg.num_iters,
                                     cfg.smoother, cfg.omega,
                                     cheby_interval=cheby_n))
    phi_q = relax_q(ntl.D[:nq], ntl.D0inv[:nq], phi_q0, r_q)

    combine = cfg.ntl_combine
    if combine == "auto":
        combine = "minres" if cfg.min_res else "avg_prolong"

    if combine == "avg_coarse":
        # gen-2 single-interpolation variant: average the coarse fields,
        # prolongate once with the telescoping quadrant
        # (telescoping_2d_laplace_Mgrid_singleinterpolation.cpp:306-315).
        a = jnp.full((nq,), 1.0 / nq, dtype=phi_q.dtype)
        phi_avg = jnp.mean(phi_q, axis=0)
        # null basis must match the blocking quadrant: phi_null[q] is
        # orthonormalized in the quad=q+1 frame (hierarchy._build_ntl_jit)
        corr = prolong(ntl.phi_null[cfg.quad - 1], phi_avg, cfg.quad, bx, by)
        phis[l] = phis[l] + corr
    else:
        # Prolongate each copy to the next-to-coarsest level.
        xs = jnp.stack([
            prolong(ntl.phi_null[q], phi_q[q], q + 1, bx, by)
            for q in range(nq)])
        if combine == "minres":
            a = min_res_weights(L[l].D, rs[l], xs, cfg)
        else:   # 'avg_prolong'
            a = jnp.full((nq,), 1.0 / nq, dtype=xs.dtype)
        phis[l] = phis[l] + jnp.einsum("q,qnxy->nxy", a, xs,
                                       precision=HIGHEST)

    # Up sweep from the next-to-coarsest level.
    for l in range(n - 1, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            corr = prolong(L[l - 1].phi_null, phis[l], cfg.quad, bx, by)
            phis[l - 1] = phis[l - 1] + corr
            phis[l] = jnp.zeros_like(phis[l])

    return tuple(phis), a


def fmg_init(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
             n_vcycles: int = 1, coarsest_iters: Optional[int] = None):
    """Full-multigrid (FMG / nested-iteration) initial guess — an
    extension beyond the reference (which always starts cycles from zero,
    modules_main.h:442): restrict the rhs down the hierarchy, relax the
    coarsest problem hard, then prolongate upward refining with
    `n_vcycles` V-cycles per level. Returns a per-level phis tuple whose
    entry 0 is an O(one-cycle-cost) initial guess that typically saves
    several outer cycles.

    The coarse problems use the Galerkin operators, so the level-l rhs is
    the plain restriction P b (consistent with D_c = P D P†).
    """
    import dataclasses as _dc

    L = hier.levels
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y
    if n == 0:
        phi = _relax(L[0], jnp.zeros_like(b), b, cfg, 0, hier.gauge)
        return (phi,)

    bs = [b]
    for l in range(n):
        bs.append(restrict(L[l].phi_null, bs[l], cfg.quad, bx, by))

    ci = coarsest_iters or 4 * cfg.num_iters
    cheby_n = (cfg.cheby_intervals[n] if cfg.smoother == "chebyshev"
               else None)
    phi = smooth(L[n].D, L[n].D0inv, jnp.zeros_like(bs[n]), bs[n], ci,
                 cfg.smoother, cfg.omega, cheby_interval=cheby_n)
    for l in range(n - 1, -1, -1):
        phi = prolong(L[l].phi_null, phi, cfg.quad, bx, by)
        sub_h = Hierarchy(levels=L[l:], ntl=None,
                          gauge=hier.gauge if l == 0 else None)
        sub_c = _dc.replace(
            cfg, nlevels=n - l, ntl=False,
            cheby_lmax=(cfg.cheby_lmax[l:] if cfg.cheby_lmax else None))
        phis = (phi,) + tuple(
            jnp.zeros((lev.D.shape[1], lev.D.shape[-1], lev.D.shape[-1]),
                      b.dtype) for lev in L[l + 1:])
        for _ in range(n_vcycles):
            phis = v_cycle(sub_h, phis, bs[l], sub_c)
        phi = phis[0]

    return (phi,) + tuple(
        jnp.zeros((lev.D.shape[1], lev.D.shape[-1], lev.D.shape[-1]),
                  b.dtype) for lev in L[1:])


def cycle(hier: Hierarchy, phis: Tuple, b: jnp.ndarray, cfg: MGConfig):
    """Dispatch: NTL if configured, else plain V/W-cycle.
    Returns (phis, a)."""
    if cfg.ntl and cfg.nlevels > 0:
        return ntl_cycle(hier, phis, b, cfg)
    if cfg.cycle_gamma > 1:
        phis = gamma_cycle(hier, phis, b, cfg)
    else:
        phis = v_cycle(hier, phis, b, cfg)
    return phis, jnp.zeros((cfg.n_copies,), dtype=b.dtype)

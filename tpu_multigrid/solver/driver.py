"""Outer solve drivers.

`solve` = the reference's f_perform_MG (modules_main.h:442-481): iterate MG
cycles until the relative residual at level 0 drops below res_threshold
(1e-13 default), aborting on divergence (> 1e6). Two modes:

- fast mode: the whole outer loop is one jitted `lax.while_loop` — no host
  round-trips; used for benchmarking.
- history mode: Python loop, one jitted cycle per iteration, recording the
  residual history (and per-level residuals + NTL weights) for the
  analysis-notebook output surface.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MGConfig
from ..utils.xfer import host_complex
from ..ops.stencil import residual, residual_norm_ratio
from .cycles import cycle
from .hierarchy import Hierarchy, zero_fields


@dataclasses.dataclass
class SolveResult:
    phi: np.ndarray
    iters: int
    resmag: float
    converged: bool
    # residual per recorded step; one entry per `history_stride` cycles
    # (stride 1 except solve_ir, which records once per OUTER step of
    # `inner_cycles` cycles: len(history) * history_stride == iters)
    history: Optional[np.ndarray] = None
    history_stride: int = 1
    ntl_weights: Optional[np.ndarray] = None      # [iters, n_copies]
    level_residuals: Optional[list] = None


def _cycle_and_res(hier, phis, b, cfg):
    from .cycles import residual_norm_ratio0
    phis, a = cycle(hier, phis, b, cfg)
    resmag = residual_norm_ratio0(hier, phis[0], b, cfg)
    return phis, a, resmag


def solve(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
          phis0=None, max_iters: Optional[int] = None) -> SolveResult:
    """Fast-mode solve: jitted while_loop over cycles."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg)

    def run(hier, phis, b):
        def cond(state):
            phis, it, res = state
            return (it < max_iters) & (res > cfg.res_threshold) \
                & (res < cfg.div_threshold)

        def body(state):
            phis, it, _ = state
            phis, _, res = _cycle_and_res(hier, phis, b, cfg)
            return phis, it + 1, res

        res0 = jnp.asarray(1.0, dtype=b.real.dtype)
        return jax.lax.while_loop(cond, body, (phis, 0, res0))

    from ..utils.compile import aot_call
    phis, iters, resmag = aot_call(run, hier, phis, b,
                                   key=("solve", cfg, max_iters))
    resmag = float(resmag)
    return SolveResult(phi=host_complex(phis[0]), iters=int(iters),
                       resmag=resmag,
                       converged=resmag < cfg.res_threshold)


def solve_chunked(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
                  phis0=None, max_iters: Optional[int] = None,
                  chunk: int = 10) -> SolveResult:
    """Chunked solve: one jitted program runs `chunk` cycles (fori_loop),
    the host checks convergence between chunks.

    The chunk amortizes dispatch latency without building one program
    per possible cycle count.
    """
    from ..utils.compile import aot_call
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg)

    def run_chunk(hier, phis, b):
        from .cycles import residual_norm_ratio0

        def body(i, phis):
            phis, _, _ = _cycle_and_res(hier, phis, b, cfg)
            return phis
        phis = jax.lax.fori_loop(0, chunk, body, phis)
        return phis, residual_norm_ratio0(hier, phis[0], b, cfg)

    it = 0
    resmag = float("inf")
    while it < max_iters:
        phis, res = aot_call(run_chunk, hier, phis, b,
                             key=("chunk", cfg, chunk))
        it += chunk
        resmag = float(res)
        if resmag < cfg.res_threshold or resmag > cfg.div_threshold \
                or not np.isfinite(resmag):
            break
    return SolveResult(phi=host_complex(phis[0]), iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)


def solve_fmg(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
              n_vcycles: int = 1, max_iters: Optional[int] = None,
              chunk: int = 10) -> SolveResult:
    """Full-multigrid solve: FMG initial guess (cycles.fmg_init), then
    chunked outer cycles. The FMG sweep costs about one extra V-cycle and
    typically saves several outer cycles (beyond-reference extension).
    The reported `iters` counts the FMG sweep as one cycle."""
    from ..utils.compile import aot_call
    from .cycles import fmg_init

    phis0 = aot_call(lambda h, bb: fmg_init(h, bb, cfg, n_vcycles),
                     hier, b, key=("fmg", cfg, n_vcycles))
    out = solve_chunked(hier, b, cfg, phis0=phis0, max_iters=max_iters,
                        chunk=chunk)
    return dataclasses.replace(out, iters=out.iters + 1)


def solve_ir(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
             inner_cycles: int = 2, max_iters: Optional[int] = None,
             inner_dtype: str = "complex64",
             D_outer: Optional[jnp.ndarray] = None,
             planes: bool = False,
             outer_chunk: int = 1) -> SolveResult:
    """Mixed-precision iterative refinement (defect correction).

    Outer loop in cfg.dtype (complex128 for the reference's 1e-13
    criterion, level.h:96-97): r = b - D phi and the update are exact;
    inner loop runs `inner_cycles` MG cycles in `inner_dtype` (complex64:
    half the bytes of every bandwidth-bound cycle kernel, plus the
    links-only level 0) on the normalized defect D e = r/|r|. Each outer
    step contracts the true f64 residual by the inner cycles' contraction
    factor, so full f64 accuracy is reached with only one f64 stencil
    apply per outer step.

    The hierarchy may be built in cfg.dtype (the inner-precision view is
    then a cast, cast_hierarchy) — or built directly in
    `inner_dtype` with the EXACT level-0 operator passed as `D_outer`
    (cfg.cdtype): the coarse levels are preconditioner-only, so their
    precision never bounds the final accuracy, while setup runs entirely
    on the f32 fast path. No reference analog (the reference is
    uniformly double, templates.h ColorMatrix = complex<double>).

    planes: run the f64 outer step on separate real/imag F64 planes
    instead of C128 arrays (stencil.apply_D_planes); identical math.
    """
    from ..utils.compile import aot_call
    from .hierarchy import cast_hierarchy

    max_iters = max_iters or cfg.max_iters
    cfg_in = cfg.replace(dtype=inner_dtype)
    hier_in = cast_hierarchy(hier, cfg_in.cdtype)
    if D_outer is None:
        D_outer = hier.levels[0].D

    if planes:
        return _solve_ir_planes(hier_in, D_outer, b, cfg, cfg_in,
                                inner_cycles, max_iters, outer_chunk)

    D_outer = D_outer.astype(cfg.cdtype)
    from ..utils.xfer import device_full
    phi = device_full((cfg.n_dof[0], cfg.L, cfg.L), 0.0, cfg.cdtype)
    r = b

    def step(D_outer, hier_in, phi, r, b):
        rn = jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))
        safe = jnp.where(rn > 0, rn, 1.0)
        r_in = (r / safe).astype(cfg_in.cdtype)
        es = zero_fields(cfg_in)

        def body(_, es):
            es, _ = cycle(hier_in, es, r_in, cfg_in)
            return es

        es = jax.lax.fori_loop(0, inner_cycles, body, es)
        phi = phi + safe * es[0].astype(phi.dtype)
        r = residual(D_outer, phi, b)
        rel = (jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))
               / jnp.sqrt(jnp.sum(jnp.abs(b) ** 2)))
        return phi, r, rel

    history = []
    resmag = float("inf")
    outer = 0
    while outer * inner_cycles < max_iters:
        # threshold-independent key: the step program never reads
        # res_threshold (the host loop checks it), so 1e-8 and 1e-13
        # solves share one executable
        phi, r, rel = aot_call(step, D_outer, hier_in, phi, r, b,
                               key=("ir", cfg.replace(res_threshold=0.0),
                                    inner_dtype, inner_cycles))
        outer += 1
        resmag = float(rel)
        history.append(resmag)
        if resmag < cfg.res_threshold or resmag > cfg.div_threshold \
                or not np.isfinite(resmag):
            break
    return SolveResult(phi=host_complex(phi), iters=outer * inner_cycles,
                       resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       history_stride=inner_cycles)


def _solve_ir_planes(hier_in, D_outer, b, cfg: MGConfig, cfg_in: MGConfig,
                     inner_cycles: int, max_iters: int,
                     outer_chunk: int = 1) -> SolveResult:
    """solve_ir outer loop with complex128 state held as F64 real/imag
    plane pairs (C128-free programs; see solve_ir docstring). The inner
    MG cycles still run natively in complex64 — the c64 value is built
    INSIDE the program from f32 planes (C64 is supported; only C128 is
    not)."""
    from ..utils.compile import aot_call
    from ..ops.stencil import apply_D_planes

    rdt = jnp.float64
    # b and D_outer as host numpy -> f64 plane pairs
    b_h = b if isinstance(b, np.ndarray) else host_complex(b)
    D_h = D_outer if isinstance(D_outer, np.ndarray) else host_complex(D_outer)
    Dre = jnp.asarray(np.real(D_h), rdt)
    Dim = jnp.asarray(np.imag(D_h), rdt)
    bre = jnp.asarray(np.real(b_h), rdt)
    bim = jnp.asarray(np.imag(b_h), rdt)
    pre = jnp.zeros_like(bre)
    pim = jnp.zeros_like(bim)
    rre, rim = bre, bim
    bn = float(np.sqrt(np.sum(np.abs(b_h) ** 2)))

    def step(Dre, Dim, hier_in, pre, pim, rre, rim, bre, bim):
        rn = jnp.sqrt(jnp.sum(rre * rre + rim * rim))
        safe = jnp.where(rn > 0, rn, 1.0)
        r_in = ((rre / safe).astype(jnp.float32)
                + 1j * (rim / safe).astype(jnp.float32)
                ).astype(cfg_in.cdtype)
        es = zero_fields(cfg_in)

        def body(_, es):
            es, _ = cycle(hier_in, es, r_in, cfg_in)
            return es

        es = jax.lax.fori_loop(0, inner_cycles, body, es)
        e0 = es[0]
        pre2 = pre + safe * jnp.real(e0).astype(rdt)
        pim2 = pim + safe * jnp.imag(e0).astype(rdt)
        dre, dim = apply_D_planes(Dre, Dim, pre2, pim2)
        rre2, rim2 = bre - dre, bim - dim
        rn2 = jnp.sqrt(jnp.sum(rre2 * rre2 + rim2 * rim2))
        return pre2, pim2, rre2, rim2, rn2

    # outer_chunk > 1: run several defect-correction steps in ONE
    # program, saving a dispatch and a host check per step. The host
    # checks convergence between chunks; cycle counts are reported at
    # chunk granularity, so the default stays 1 for reference-comparable
    # counts.

    def steps(Dre, Dim, hier_in, pre, pim, rre, rim, bre, bim):
        st = (pre, pim, rre, rim)
        for _ in range(outer_chunk):   # unrolled: tiny fixed count
            pre2, pim2, rre2, rim2, _ = step(Dre, Dim, hier_in, *st,
                                             bre, bim)
            st = (pre2, pim2, rre2, rim2)
        rn2 = jnp.sqrt(jnp.sum(st[2] * st[2] + st[3] * st[3]))
        return st + (rn2,)

    history = []
    resmag = float("inf")
    outer = 0
    while outer * inner_cycles < max_iters:
        pre, pim, rre, rim, rn2 = aot_call(
            steps, Dre, Dim, hier_in, pre, pim, rre, rim, bre, bim,
            key=("ir_planes", cfg.replace(res_threshold=0.0),
                 cfg_in.dtype, inner_cycles, outer_chunk))
        outer += outer_chunk
        resmag = float(rn2) / bn
        history.append(resmag)
        if resmag < cfg.res_threshold or resmag > cfg.div_threshold \
                or not np.isfinite(resmag):
            break
    phi = np.asarray(pre) + 1j * np.asarray(pim)
    return SolveResult(phi=phi, iters=outer * inner_cycles,
                       resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       history_stride=inner_cycles * outer_chunk)


def solve_with_history(hier: Hierarchy, b: jnp.ndarray, cfg: MGConfig,
                       phis0=None, max_iters: Optional[int] = None,
                       writer=None) -> SolveResult:
    """History-mode solve: records the relative-residual trajectory (and,
    via `writer`, the reference's per-iteration output surface)."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg)
    from ..utils.compile import aot_call
    step = lambda h, p, bb: aot_call(
        lambda h, p, bb: _cycle_and_res(h, p, bb, cfg), h, p, bb,
        key=("cycle", cfg))

    history, weights = [], []
    converged = False
    resmag = float("inf")
    it = 0
    for it in range(1, max_iters + 1):
        phis, a, res = step(hier, phis, b)
        resmag = float(res)
        history.append(resmag)
        weights.append(host_complex(a))
        if writer is not None and (it - 1) % cfg.write_interval == 0:
            writer.record(it, hier, phis, b, host_complex(a))
        if resmag < cfg.res_threshold:
            converged = True
            break
        if resmag > cfg.div_threshold or not np.isfinite(resmag):
            break

    return SolveResult(phi=host_complex(phis[0]), iters=it, resmag=resmag,
                       converged=converged,
                       history=np.asarray(history),
                       ntl_weights=np.asarray(weights))


def solve_batched(hier: Hierarchy, bs: jnp.ndarray, cfg: MGConfig,
                  n_cycles: int) -> np.ndarray:
    """Batched multi-RHS solve — the data-parallel axis the reference
    lacks (SURVEY.md §2.3 DP row): vmap the whole fixed-cycle-count MG
    solve over a leading RHS batch axis. bs: [batch, n, L, L].

    Runs a fixed number of cycles (per-RHS early exit would break batch
    uniformity); returns solutions [batch, n, L, L] and the per-RHS
    relative residuals.
    """
    from ..utils.compile import aot_call

    def one(h, b):
        from .cycles import residual_norm_ratio0
        phis = zero_fields(cfg)

        def body(_, phis):
            phis, _, _ = _cycle_and_res(h, phis, b, cfg)
            return phis

        phis = jax.lax.fori_loop(0, n_cycles, body, phis)
        return phis[0], residual_norm_ratio0(h, phis[0], b, cfg)

    phi, res = aot_call(lambda h, bb: jax.vmap(lambda b: one(h, b))(bb),
                        hier, bs, key=("batched", cfg, n_cycles,
                                       bs.shape[0]))
    return host_complex(phi), np.asarray(res)


def mr_solve(D, b, tol: float = 1e-8, max_iters: int = 100000,
             chunk: int = 1000):
    """Unpreconditioned minimal-residual iteration — the baseline the MG
    solve must beat by >= 5x in cycle count (BASELINE.json north star).

    x_{k+1} = x_k + alpha r_k with alpha = <D r, r> / <D r, D r>.
    Chunked (fori_loop of `chunk` steps per program + host convergence
    check). Returns (x, iters, relres).
    """
    from ..ops.stencil import apply_D
    from ..utils.compile import aot_call

    def run_chunk(D, x, r):
        def body(i, s):
            x, r = s
            Dr = apply_D(D, r)
            alpha = (jnp.sum(jnp.conj(Dr) * r)
                     / jnp.sum(jnp.conj(Dr) * Dr))
            return x + alpha * r, r - alpha * Dr

        x, r = jax.lax.fori_loop(0, chunk, body, (x, r))
        return x, r, jnp.sqrt(jnp.sum(jnp.abs(r) ** 2))

    from ..utils.xfer import device_zeros_like
    bn = float(jnp.sqrt(jnp.sum(jnp.abs(b) ** 2)))
    x, r = device_zeros_like(b), b
    it = 0
    rel = 1.0
    while it < max_iters:
        x, r, rn = aot_call(run_chunk, D, x, r,
                            key=("mr", D.shape, str(D.dtype), chunk))
        it += chunk
        rel = float(rn) / bn
        if rel < tol or not np.isfinite(rel):
            break
    return x, it, rel

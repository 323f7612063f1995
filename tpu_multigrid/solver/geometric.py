"""Generation-1 capability: geometric multigrid for the free 2D Laplace
equation (real scalar field), reproducing the reference's
code/1_laplace_scalar/2D_laplace_Mgrid.cpp behaviors:

- operator:  (A phi)(x) = (1/a^2) [ sum_ngb phi - (4 + m^2 a^2) phi ]
  (2D_laplace_Mgrid.cpp:31-33; note m enters squared, unlike adaptive gens)
- lattice spacing doubles per level: a[l] = 2 a[l-1]  (:143)
- restriction: 4-point block average of the residual (:84-86)
- prolongation: piecewise-constant injection, additive (:96-101)
- smoother: phi <- scale (sum_ngb phi - r a^2), scale = 1/(4 + m^2 a^2) (:62-64)
- convergence: SUM of |r| (absolute L1, not relative) < threshold (:44-48)
- the coarsest level's residual is computed but never smoothed (gen-1
  quirk: down loop stops at nlevels-1, up loop starts there; :174-184)

Default config = the reference's hardcoded run: L=2048, m=0.002, 9 levels,
20 sweeps, threshold 1e-14 (:118-123) — BASELINE config 1 uses a 64^2
2-level variant with Jacobi.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    L: int = 2048
    m: float = 0.002
    nlevels: int = 9
    num_iters: int = 20
    max_iters: int = 10000
    res_threshold: float = 1.0e-14
    smoother: str = "rbgs"        # 'jacobi' | 'rbgs' | 'gs_lex'
    # Jacobi damping. Undamped Jacobi does not smooth the near-(pi,pi)
    # checkerboard modes of the 2D Laplacian (amplification 4/(4+m^2 a^2)
    # ~ 1 for small m), so an MG cycle with omega=1 Jacobi stalls for
    # small m; 0.8 is the classic 2D choice. Default 1.0 matches the
    # reference's own (undamped) Jacobi trajectory (gs_flag=0 path);
    # rbgs/gs_lex ignore omega.
    omega: float = 1.0
    dtype: str = "float64"

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.L // (2 ** l) for l in range(self.nlevels + 1))

    @property
    def spacings(self) -> Tuple[float, ...]:
        return tuple(float(2 ** l) for l in range(self.nlevels + 1))

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(1.0 / (4.0 + self.m ** 2 * a * a) for a in self.spacings)

    @property
    def rdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def _ngb_sum(phi):
    return (jnp.roll(phi, -1, 0) + jnp.roll(phi, 1, 0)
            + jnp.roll(phi, -1, 1) + jnp.roll(phi, 1, 1))


def geo_residual(phi, b, level: int, cfg: GeoConfig):
    a = cfg.spacings[level]
    return b - (1.0 / (a * a)) * (_ngb_sum(phi) - phi / cfg.scales[level])


def geo_residue_l1(phi, b, cfg: GeoConfig):
    """Reference norm: sum |r| at level 0 (2D_laplace_Mgrid.cpp:44-48)."""
    return jnp.sum(jnp.abs(geo_residual(phi, b, 0, cfg)))


def geo_residual_floor(phi, b, cfg: GeoConfig) -> float:
    """First-order rounding floor of the computed sum|r| for THIS phi in
    its own dtype: each site's residual expression carries fp error
    ~ eps * (sum of its terms' magnitudes), and the L1 norm adds the
    |errors| coherently over L^2 sites. Any solver storing phi at this
    precision has true residual >= this once converged (phi's own
    representation error alone produces A*delta of the same size), so
    sub-floor thresholds are unreachable no matter how many cycles run —
    the reference's own sub-floor 'converged' values at 2048^2 come from
    its in-place-GS bitwise-cancellation artifact (computed residual, not
    true residual; PARITY.md 'Known deviations')."""
    a = cfg.spacings[0]
    mag = (jnp.abs(b) + (1.0 / (a * a))
           * (_ngb_sum(jnp.abs(phi)) + jnp.abs(phi) / cfg.scales[0]))
    return float(jnp.finfo(phi.dtype).eps * jnp.sum(mag))


def _geo_sweep(phi, r, level, cfg, parity=None, omega=1.0):
    a = cfg.spacings[level]
    upd = cfg.scales[level] * (_ngb_sum(phi) - r * a * a)
    if omega != 1.0:
        upd = phi + omega * (upd - phi)
    if parity is None:
        return upd
    return jnp.where(parity, upd, phi)


def geo_smooth(phi, r, level: int, n_sweeps: int, cfg: GeoConfig):
    L = phi.shape[-1]
    if cfg.smoother == "jacobi":
        def body(_, phi):
            return _geo_sweep(phi, r, level, cfg, omega=cfg.omega)
    elif cfg.smoother == "gs_lex":
        # Exact in-place lexicographic GS (the reference's relax,
        # 2D_laplace_Mgrid.cpp:59-64, order for x { for y }) via the
        # anti-diagonal wavefront identity (see ops.smoothers.gs_lex_sweep).
        x = jnp.arange(L)[:, None]
        y = jnp.arange(L)[None, :]
        diag = x + y

        def body(_, phi):
            def wave(d, phi):
                return jnp.where(diag == d,
                                 _geo_sweep(phi, r, level, cfg), phi)
            return jax.lax.fori_loop(0, 2 * L - 1, wave, phi)
    else:  # red-black GS
        x = jnp.arange(L)[:, None]
        y = jnp.arange(L)[None, :]
        red = ((x + y) % 2) == 0

        def body(_, phi):
            phi = _geo_sweep(phi, r, level, cfg, red)
            return _geo_sweep(phi, r, level, cfg, ~red)

    return jax.lax.fori_loop(0, n_sweeps, body, phi)


def geo_restrict(res):
    """4-point average: [L, L] -> [L/2, L/2]."""
    L = res.shape[-1]
    return 0.25 * res.reshape(L // 2, 2, L // 2, 2).sum(axis=(1, 3))


def geo_prolong(coarse):
    """Constant injection: [Lc, Lc] -> [2Lc, 2Lc]."""
    Lc = coarse.shape[-1]
    out = jnp.broadcast_to(coarse[:, None, :, None], (Lc, 2, Lc, 2))
    return out.reshape(2 * Lc, 2 * Lc)


def geo_vcycle(phis: Tuple, b, cfg: GeoConfig) -> Tuple:
    """One gen-1 V-cycle (2D_laplace_Mgrid.cpp:171-184)."""
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    for l in range(n):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        rs[l + 1] = geo_restrict(geo_residual(phis[l], rs[l], l, cfg))
        phis[l + 1] = jnp.zeros_like(phis[l + 1])
    # reference quirk: coarsest level is never smoothed (up loop starts
    # at nlevels-1)
    for l in range(n - 1, -1, -1):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        if l > 0:
            phis[l - 1] = phis[l - 1] + geo_prolong(phis[l])
            phis[l] = jnp.zeros_like(phis[l])
    return tuple(phis)


# --- Generation 2: geometric NON-TELESCOPING prototype ---------------------
#
# code/2_scalar_2d_nontelescoping/telescoping_2d_laplace_Mgrid.cpp — the
# reference's first NTL program: same geometric Laplace operator as gen 1
# (m enters squared; a doubles per level) but with quadrant-offset
# restriction/interpolation (f_projection/f_interpolate, :74-143) and, at
# the coarsest transition, 4 independent quadrant projections whose relaxed
# copies are recombined by plain averaging (:296-313) — the precursor of
# the final generation's min-res NTL recombination.


@dataclasses.dataclass(frozen=True)
class Geo2Config(GeoConfig):
    """Gen-2 program parameters; defaults = its hardcoded values
    (telescoping_2d_laplace_Mgrid.cpp:186-276 — argv: L m nlevels
    num_iters t_flag; gs_flag=1, n_copies=2, quad=1, threshold 1e-13,
    max_iters 5000)."""
    L: int = 256
    m: float = 0.002
    nlevels: int = 6
    num_iters: int = 20
    max_iters: int = 5000
    res_threshold: float = 1.0e-13
    smoother: str = "gs_lex"   # reference gs_flag=1; 'rbgs' = parallel
    t_flag: bool = True        # non-telescoping bottom level
    n_copies: int = 2          # hardcoded at :266
    quad: int = 1              # telescoping-path quadrant (:269)
    # 'divide': main program — interpolate each copy with its own
    #   quadrant, then divide the WHOLE fine field by n_copies (:305-313).
    # 'single': the _singleinterpolation variant — average the relaxed
    #   copies (committed nn=1: copy 0 only) into the coarse phi and
    #   interpolate ONCE with the telescoping quadrant (:299-320 there).
    combine: str = "divide"
    n_single: int = 1          # 'single' variant's nn (:311 there)


def quad_restrict(rt, quad: int):
    """Quadrant-offset 4-point average (f_projection, :74-110): coarse
    (x,y) averages fine sites {2x,2x+sx} x {2y,2y+sy} — i.e. the plain 2x2
    block average in that quadrant's block frame (same QUAD_OFFSETS
    geometry as the adaptive path; blocking is always a roll, never index
    math)."""
    from ..ops.transfer import to_block_frame
    return geo_restrict(to_block_frame(rt, quad))


def quad_prolong(coarse, quad: int):
    """Adjoint quadrant-offset constant injection (f_interpolate, :112-143)."""
    from ..ops.transfer import from_block_frame
    return from_block_frame(geo_prolong(coarse), quad)


def geo2_vcycle(phis: Tuple, b, cfg: Geo2Config) -> Tuple:
    """One gen-2 cycle (telescoping_2d_laplace_Mgrid.cpp:277-316).

    Differences from the gen-1 cycle: quadrant-aware transfers; the
    coarsest level IS relaxed on the way up (gen-1 never smooths it); with
    t_flag, the coarsest residual is projected 4 independent ways and the
    relaxed copies are recombined by averaging."""
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    r_tel = None
    for l in range(n):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        rt = geo_residual(phis[l], rs[l], l, cfg)
        if l == n - 1 and cfg.t_flag:
            # project 4 independent ways (:283-285; always all 4, even
            # when only n_copies are used on the way up)
            r_tel = [quad_restrict(rt, q) for q in (1, 2, 3, 4)]
        else:
            rs[l + 1] = quad_restrict(rt, cfg.quad)
            phis[l + 1] = jnp.zeros_like(phis[l + 1])
    if cfg.t_flag and n > 0:
        zc = jnp.zeros_like(phis[n])   # phi_tel reset every cycle (:301)
        if cfg.combine == "divide":
            for i in range(cfg.n_copies):
                pt = geo_smooth(zc, r_tel[i], n, cfg.num_iters, cfg)
                phis[n - 1] = phis[n - 1] + quad_prolong(pt, i + 1)
            # reference quirk preserved: the division by n_copies hits the
            # ENTIRE fine field, including its pre-interpolation content
            # (:311-313) — not phi += mean(corrections)
            phis[n - 1] = phis[n - 1] / cfg.n_copies
        else:   # 'single'
            acc = jnp.zeros_like(phis[n])
            for i in range(cfg.n_single):
                pt = geo_smooth(zc, r_tel[i], n, cfg.num_iters, cfg)
                acc = acc + pt / cfg.n_single
            phis[n - 1] = phis[n - 1] + quad_prolong(acc, cfg.quad)
    elif n > 0:
        phis[n] = geo_smooth(phis[n], rs[n], n, cfg.num_iters, cfg)
        phis[n - 1] = phis[n - 1] + quad_prolong(phis[n], cfg.quad)
        phis[n] = jnp.zeros_like(phis[n])
    for l in range(n - 1, -1, -1):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        if l > 0:
            phis[l - 1] = phis[l - 1] + quad_prolong(phis[l], cfg.quad)
            phis[l] = jnp.zeros_like(phis[l])
    return tuple(phis)


def geo2_source(cfg: Geo2Config):
    """Center point source r[L/2 + (L/2)L] = 1.0 * scale[0] (:263)."""
    b = jnp.zeros((cfg.L, cfg.L), cfg.rdtype)
    return b.at[cfg.L // 2, cfg.L // 2].set(cfg.scales[0])


def geo2_solve(b, cfg: Geo2Config, max_iters: Optional[int] = None,
               chunk: int = 5):
    """Chunked outer loop (:271-329); returns (phi, iters, resmag, history).
    history[k] = sum|r| after k+1 cycles."""
    from ..utils.compile import aot_call
    max_iters = max_iters or cfg.max_iters
    phis = tuple(jnp.zeros((s, s), cfg.rdtype) for s in cfg.sizes)

    def run_chunk(phis, b):
        def body(_, phis):
            return geo2_vcycle(phis, b, cfg)
        phis = jax.lax.fori_loop(0, chunk, body, phis)
        return phis, geo_residue_l1(phis[0], b, cfg)

    it = 0
    hist = []
    resmag = float("inf")
    while it < max_iters:
        phis, res = aot_call(run_chunk, phis, b, key=("geo2", cfg, chunk))
        it += chunk
        resmag = float(res)
        hist.append(resmag)
        if resmag < cfg.res_threshold or resmag > 1e6 \
                or not np.isfinite(resmag):
            break
    return np.asarray(phis[0]), it, resmag, np.asarray(hist)


def geo_solve_ir(b, cfg: GeoConfig, max_iters: Optional[int] = None,
                 chunk: int = 2, inner_cycles: int = 1):
    """Mixed-precision geometric solve: f32 V-cycles as the error solver
    inside an f64 defect-correction (iterative-refinement) outer loop.

    Rationale: the reference's gen-1 thresholds (sum|r| at 2048^2) sit
    near the f64 rounding floor. Defect correction reaches f64-level
    residuals while doing ~all the work (num_iters smoother sweeps x
    nlevels per cycle) in f32, half the bytes of f64: per outer iteration only ONE f64 residual + one f64 axpy
    runs at level 0. Same contraction per cycle as geo_solve once above
    the f32 floor; the f64 outer loop then keeps contracting below it.

    Returns (phi[f64], iters, resmag, history) like geo_solve.
    """
    import dataclasses as _dc
    from ..utils.compile import aot_call
    max_iters = max_iters or cfg.max_iters
    cfg32 = _dc.replace(cfg, dtype="float32")
    b64 = jnp.asarray(b, jnp.float64)
    phi0 = jnp.zeros((cfg.L, cfg.L), jnp.float64)

    def run_chunk(phi, b64):
        def outer(_, phi):
            r64 = geo_residual(phi, b64, 0, cfg)
            e_phis = tuple(jnp.zeros((s, s), jnp.float32)
                           for s in cfg.sizes)
            r32 = r64.astype(jnp.float32)

            def inner(_, e_phis):
                return geo_vcycle(e_phis, r32, cfg32)

            e_phis = jax.lax.fori_loop(0, inner_cycles, inner, e_phis)
            return phi + e_phis[0].astype(jnp.float64)

        phi = jax.lax.fori_loop(0, chunk, outer, phi)
        return phi, geo_residue_l1(phi, b64, cfg)

    it = 0
    hist = []
    resmag = float("inf")
    phi = phi0
    while it < max_iters:
        phi, res = aot_call(run_chunk, phi, b64,
                            key=("geo_ir", cfg, chunk, inner_cycles))
        it += chunk * inner_cycles
        resmag = float(res)
        hist.append(resmag)
        if resmag < cfg.res_threshold or resmag > 1e6 \
                or not np.isfinite(resmag):
            break
    return np.asarray(phi), it, resmag, np.asarray(hist)


def geo_source(cfg: GeoConfig):
    """Reference sources (2D_laplace_Mgrid.cpp:163)."""
    b = jnp.zeros((cfg.L, cfg.L), cfg.rdtype)
    return b.at[0, 0].set(1.0).at[1, 0].set(2.0) \
            .at[2, 2].set(5.0).at[3, 3].set(7.5)


def geo_solve(b, cfg: GeoConfig, max_iters: Optional[int] = None,
              chunk: int = 5):
    """Chunked outer loop; returns (phi, iters, resmag, history)."""
    from ..utils.compile import aot_call
    max_iters = max_iters or cfg.max_iters
    phis = tuple(jnp.zeros((s, s), cfg.rdtype) for s in cfg.sizes)

    def run_chunk(phis, b):
        def body(_, phis):
            return geo_vcycle(phis, b, cfg)
        phis = jax.lax.fori_loop(0, chunk, body, phis)
        return phis, geo_residue_l1(phis[0], b, cfg)

    it = 0
    hist = []
    resmag = float("inf")
    while it < max_iters:
        phis, res = aot_call(run_chunk, phis, b, key=("geo", cfg, chunk))
        it += chunk
        resmag = float(res)
        hist.append(resmag)
        if resmag < cfg.res_threshold or resmag > 1e6 \
                or not np.isfinite(resmag):
            break
    return np.asarray(phis[0]), it, resmag, np.asarray(hist)

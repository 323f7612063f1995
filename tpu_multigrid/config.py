"""Configuration for the 2D adaptive multigrid solver library.

Covers every knob of the reference code's parameter surface — both the 8
positional CLI arguments and all compile-time constants (reference:
code/6_ntl-mg_new_code/3_combining_laplace_and_wilson/params.h:42-69) — as a
single frozen dataclass, plus derived per-level geometry (params.h:114-121).

Unlike the reference (which hardcodes stencil/quad/beta/thresholds in source),
everything is configurable here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp

STENCILS = ("laplace", "wilson")
SMOOTHERS = ("jacobi", "rbgs", "gs_lex", "chebyshev")

# Stencil direction index convention (matches reference D(X, idx), level.h:8):
#   0 = same site, 1 = +x, 2 = -x, 3 = +y, 4 = -y
SAME, XP, XM, YP, YM = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Static configuration of an adaptive-MG solve.

    CLI-equivalent knobs (reference params.h:42-50):
      L, num_iters, block_x/block_y, gen_null, m, nlevels, t_flag(ntl), n_copies
    Promoted compile-time constants (params.h:61-69):
      gs_flag->smoother, total_copies, quad, max_iters, write_interval, beta,
      res_threshold, stencil.
    """

    L: int = 64
    stencil: str = "laplace"
    m: float = 0.1
    nlevels: int = 2
    block_x: int = 2
    block_y: int = 2
    # Smoother sweeps per level per half V-cycle (argv[2] in the reference).
    num_iters: int = 20
    # 'jacobi' matches the reference gs_flag=0 trajectory exactly;
    # 'rbgs' is the data-parallel Gauss-Seidel (red/black ordering);
    # 'gs_lex' is exact lexicographic GS via wavefront scan (validation mode).
    smoother: str = "rbgs"
    omega: float = 1.0  # damping for Jacobi/RBGS (1.0 = reference behavior)
    # Chebyshev smoother (beyond-reference): per-level lambda_max of the
    # Jacobi-preconditioned operator D0^{-1} D (length nlevels+1), usually
    # filled by solver.eigs.chebyshev_config(cfg, hier). The smoothing
    # interval per level is [cheby_lmin_frac * lmax, 1.02 * lmax].
    cheby_lmax: Optional[Tuple[float, ...]] = None
    cheby_lmin_frac: float = 0.25

    # Non-telescoping (NTL) options.
    ntl: bool = False            # reference t_flag
    n_copies: int = 4            # quadrant copies, 1..4
    min_res: bool = True         # minimal-residual recombination vs plain average
    # NTL recombination of the coarse quadrant copies:
    #   'auto'        -> 'minres' if min_res else 'avg_prolong'
    #   'minres'      -> final-gen minimal-residual weights (f_min_res)
    #   'avg_prolong' -> prolong each copy, average the corrections
    #                    (gen-2 main, telescoping_2d_laplace_Mgrid.cpp:296-305)
    #   'avg_coarse'  -> average the COARSE fields, prolong ONCE with
    #                    cfg.quad (gen-2 "_singleinterpolation" variant;
    #                    its committed nn=1 actually used copy 0 only —
    #                    we average all n_copies, the variant's intent)
    ntl_combine: str = "auto"
    # Reference quirk: the min-res RHS differs between stencils
    # (modules_main.h:336-340 vs :358-366). "auto" follows the reference.
    minres_src: str = "auto"     # 'auto' | 'x_dot_r' | 'r_dot_dx'

    # Near-null setup (modules_main.h:193; level.h:190).
    gen_null: bool = True
    null_iters: int = 500
    iters_per_norm: int = 4
    ortho_passes: int = 2        # deliberate double Gram-Schmidt
    # Jointly orthonormalize the candidate set at every renormalization
    # (block power iteration). False = reference behavior (independent
    # candidates), which degenerates on <= ~4^2 setup levels — see
    # ops/nearnull.relax_null_vectors.
    null_joint_qr: bool = False

    # Outer iteration (params.h:64-67).
    max_iters: int = 50000
    res_threshold: float = 1.0e-13
    div_threshold: float = 1.0e6
    write_interval: int = 1

    quad: int = 1                # blocking quadrant for the telescoping path
    # Cycle index: 1 = V-cycle (reference behavior), 2 = W-cycle (each
    # coarse problem visited twice) — an extension beyond the reference.
    cycle_gamma: int = 1
    beta: float = 32.0           # U(1) heat-bath coupling
    seed: int = 4302529          # reference RNG seed (mgrid_ntl.cpp:35)

    n_color: int = 1             # U(1): 1x1 link matrices
    # Coarse dof per site; None = stencil default (2 laplace / 4 wilson).
    # The reference's early gens scan this (e.g. the single-null-vector
    # variant 2_U1_..._single_null.cpp has ndof_coarse=1).
    ndof_coarse: Optional[int] = None
    dtype: str = "complex128"    # 'complex64' for the fast cycle path
    # Level-0 links-only (spin-projected) fast path: when the hierarchy
    # carries the gauge links (build_hierarchy(..., U=U)), wilson level-0
    # smoother sweeps and residuals stream 4 link planes instead of the
    # 20 dense-D planes — identical math (ops/gauge_stencil.py, pinned by
    # tests/test_gauge_stencil.py), ~4x less device-memory traffic.
    #   'auto' -> use it in complex64 (the production mode);
    #             complex128 validation runs keep the dense path so
    #             committed golden trajectories stay bit-stable.
    #   'on'   -> use whenever links are available (any dtype).
    #   'off'  -> always dense.
    links: str = "auto"
    # Sharded halo exchange schedule (parallel/halo.py): True issues the
    # four edge ppermutes first, computes the interior hop on local data,
    # and patches boundary rows/columns as edges land — XLA can overlap
    # the device-to-device transfers with the interior stencil compute
    # (SURVEY §5.8, §7.1). False is the permute-then-concatenate baseline.
    halo_overlap: bool = True

    def __post_init__(self):
        if self.stencil not in STENCILS:
            raise ValueError(f"stencil must be one of {STENCILS}, got {self.stencil!r}")
        if self.smoother not in SMOOTHERS:
            raise ValueError(f"smoother must be one of {SMOOTHERS}, got {self.smoother!r}")
        if self.ntl and self.nlevels < 2:
            # Reference params.h:52-55.
            raise ValueError("non-telescoping needs nlevels >= 2")
        if not (1 <= self.n_copies <= 4):
            raise ValueError("n_copies must be in 1..4")
        if not (1 <= self.quad <= 4):
            raise ValueError("quad must be in 1..4")
        if self.ntl_combine not in ("auto", "minres", "avg_prolong",
                                    "avg_coarse"):
            raise ValueError(f"bad ntl_combine {self.ntl_combine!r}")
        if self.links not in ("auto", "on", "off"):
            raise ValueError(f"bad links {self.links!r}")
        if self.smoother == "chebyshev":
            if (self.cheby_lmax is None
                    or len(self.cheby_lmax) != self.nlevels + 1):
                raise ValueError(
                    "chebyshev smoother needs cheby_lmax with one entry "
                    "per level (nlevels+1); build the hierarchy with "
                    "another smoother, then use "
                    "solver.eigs.chebyshev_config(cfg, hier)")
        if self.ndof_coarse is not None:
            if self.stencil == "wilson" and self.ndof_coarse % 2:
                raise ValueError("wilson coarse dof must be even "
                                 "(chirality-split rows)")
            if self.ndof_coarse < 1:
                raise ValueError("ndof_coarse must be >= 1")
        max_levels = self.max_levels
        if self.nlevels > max_levels:
            raise ValueError(
                f"too many levels {self.nlevels}: L={self.L} with block "
                f"{self.block_x} supports at most {max_levels}")
        if self.L % (self.block_x ** self.nlevels) != 0:
            raise ValueError("L must be divisible by block^nlevels")

    # ---- derived geometry (reference params.h:72-83, 114-121) ----

    @property
    def max_levels(self) -> int:
        return int(math.ceil(math.log2(self.L) / math.log2(self.block_x)))

    @property
    def spinor_dim(self) -> int:
        return 2 if self.stencil == "wilson" else 1

    @property
    def n_dof_scale(self) -> int:
        # Coarse-level dof: wilson doubles by chirality (params.h:76/82).
        if self.ndof_coarse is not None:
            return self.ndof_coarse
        return 4 if self.stencil == "wilson" else 2

    @property
    def sizes(self) -> Tuple[int, ...]:
        s = [self.L]
        for _ in range(self.nlevels):
            s.append(s[-1] // self.block_x)
        return tuple(s)

    @property
    def n_dof(self) -> Tuple[int, ...]:
        n0 = 2 if self.stencil == "wilson" else 1
        return (n0,) + (self.n_dof_scale,) * self.nlevels

    @property
    def scale0(self) -> float:
        # 1/(2+m) wilson, 1/(4+m) laplace, a=1 (params.h:76,82).
        return 1.0 / ((2.0 if self.stencil == "wilson" else 4.0) + self.m)

    @property
    def cheby_intervals(self) -> Tuple[Tuple[float, float], ...]:
        """Per-level (lmin, lmax) Chebyshev smoothing intervals; the 2%
        headroom above the estimated lmax guards against power-iteration
        underestimation."""
        return tuple((self.cheby_lmin_frac * l, 1.02 * l)
                     for l in self.cheby_lmax)

    @property
    def cdtype(self):
        return jnp.complex128 if self.dtype == "complex128" else jnp.complex64

    @property
    def rdtype(self):
        return jnp.float64 if self.dtype == "complex128" else jnp.float32

    def replace(self, **kw) -> "MGConfig":
        return dataclasses.replace(self, **kw)


def from_reference_argv(argv) -> MGConfig:
    """Build a config from the reference's 8 positional CLI args.

    ``L num_iters block gen_null m nlevels t_flag n_copies``
    (reference params.h:42-50; stencil defaults to the reference's
    compiled-in 'wilson', params.h:69).
    """
    L, num_iters, block, gen_null, m, nlevels, t_flag, n_copies = argv[:8]
    return MGConfig(
        L=int(L), num_iters=int(num_iters), block_x=int(block),
        block_y=int(block), gen_null=bool(int(gen_null)), m=float(m),
        nlevels=int(nlevels), ntl=bool(int(t_flag)), n_copies=int(n_copies),
        stencil="wilson",
    )

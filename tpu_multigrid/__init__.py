"""tpu_multigrid — an adaptive multigrid solver library for 2D lattice
operators (gauged Laplace and Wilson-Dirac), built from scratch in JAX/XLA
with the capabilities of the reference research code
`vmos1/2d_multigrid` (see SURVEY.md).

Quick start::

    import jax, tpu_multigrid as mg
    mg.enable_f64()
    cfg = mg.MGConfig(L=64, stencil="laplace", m=0.01, nlevels=3, ntl=True)
    U = mg.models.gauge.identity_gauge(cfg.L, cfg.cdtype)
    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)
    hier = mg.build_hierarchy(D, cfg)
    b = mg.point_source(cfg)
    out = mg.solve(hier, b, cfg)
"""
from . import config, testing
from .config import MGConfig, from_reference_argv
from . import models, ops, solver, parallel, utils
from .solver.hierarchy import (Hierarchy, LevelOps, NTLOps, build_hierarchy,
                               build_ntl, zero_fields, point_source,
                               cast_hierarchy)
from .solver.cycles import v_cycle, ntl_cycle, cycle, min_res_weights
from .solver.driver import (solve, solve_chunked, solve_with_history,
                            solve_ir, solve_fmg, mr_solve, SolveResult)
from .solver.eo import eo_mr_solve
from .solver.krylov import fgmres_solve, cgnr_solve, cgnr_solve_ir
from .solver import eigs

__version__ = "0.5.0"


def enable_f64():
    """Turn on float64/complex128 (needed for the reference's 1e-13
    residual threshold; SURVEY.md §7.3)."""
    import jax
    jax.config.update("jax_enable_x64", True)

"""Command-line driver, mirroring the reference program phases
(mgrid_ntl.cpp:29-73): config -> fields -> gauge -> operator assembly ->
near-null setup -> self-tests -> outer MG solve -> results files.

Two invocation styles:
  python -m tpu_multigrid.cli 64 20 2 1 0.002 2 1 4          (reference argv:
      L num_iters block gen_null m nlevels t_flag n_copies)
  python -m tpu_multigrid.cli --L 64 --stencil laplace --m 0.002 ...  (full)

Unlike the reference, every compile-time constant (stencil, quad, beta,
thresholds, smoother) is a flag.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_multigrid",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["adaptive", "geo", "geo2"],
                   default="adaptive",
                   help="adaptive: final-generation program (default); "
                        "geo: gen-1 geometric MG (2D_laplace_Mgrid.cpp); "
                        "geo2: gen-2 geometric non-telescoping prototype "
                        "(--ntl sets its t_flag, --ntl-combine avg_coarse "
                        "selects the single-interpolation variant)")
    p.add_argument("--geo-ir", action="store_true", dest="geo_ir",
                   help="geo mode: mixed-precision solve (f32 V-cycles "
                        "inside an f64 defect-correction loop)")
    p.add_argument("--L", type=int, default=64)
    p.add_argument("--stencil", choices=["laplace", "wilson"],
                   default="wilson")
    p.add_argument("--m", type=float, default=-0.07)
    p.add_argument("--nlevels", type=int, default=2)
    p.add_argument("--block", type=int, default=2)
    p.add_argument("--num-iters", type=int, default=20)
    p.add_argument("--smoother", choices=["jacobi", "rbgs", "gs_lex"],
                   default="rbgs")
    p.add_argument("--ntl", action="store_true")
    p.add_argument("--n-copies", type=int, default=4)
    p.add_argument("--no-min-res", action="store_true")
    p.add_argument("--ntl-combine", default="auto",
                   choices=["auto", "minres", "avg_prolong", "avg_coarse"])
    p.add_argument("--gen-null", type=int, default=1,
                   help="1: generate near-null; 0: read from checkpoint")
    p.add_argument("--null-iters", type=int, default=500)
    p.add_argument("--res-threshold", type=float, default=1e-13)
    p.add_argument("--max-iters", type=int, default=50000)
    p.add_argument("--quad", type=int, default=1)
    p.add_argument("--beta", type=float, default=32.0)
    p.add_argument("--seed", type=int, default=4302529)
    p.add_argument("--dtype", choices=["complex64", "complex128"],
                   default="complex128")
    p.add_argument("--gauge", choices=["identity", "random", "heatbath",
                                       "file"], default="identity")
    p.add_argument("--gauge-file", type=str, default=None,
                   help="phase file (heat-bath format) to read links from")
    p.add_argument("--heatbath-sweeps", type=int, default=100)
    p.add_argument("--out-dir", type=str, default=".")
    p.add_argument("--skip-tests", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="near-null checkpoint path (.npz or reference .txt)")
    p.add_argument("--platform", type=str, default=None,
                   help="force jax platform (e.g. cpu)")
    p.add_argument("--solver", choices=["stationary", "fgmres", "ir",
                                        "fmg", "eo_mr", "cgnr"],
                   default="stationary",
                   help="outer iteration: stationary MG cycles (reference "
                        "behavior), MG-preconditioned flexible GMRES, "
                        "mixed-precision iterative refinement (f64 defect, "
                        "complex64 inner cycles), "
                        "full multigrid (FMG nested-iteration start), or "
                        "even-odd Schur-preconditioned minimal residual "
                        "(no MG hierarchy)")
    p.add_argument("--ir-inner-cycles", type=int, default=2,
                   help="MG cycles per iterative-refinement outer step")
    p.add_argument("--ndof-coarse", type=int, default=None,
                   help="coarse dof per site (default: 2 laplace/4 wilson)")
    p.add_argument("--roofline", action="store_true",
                   help="print the per-kernel roofline table before solving")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (the reference's NaN-guard "
                        "analog, SURVEY §5.2)")
    p.add_argument("--resume", type=str, default=None, metavar="STATE.npz",
                   help="checkpoint the solver state here every "
                        "--checkpoint-every cycles and resume from it if "
                        "present (utils.checkpoint.solve_resumable)")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--mesh", type=str, default=None, metavar="MX,MY",
                   help="run the distributed solve on an MX x MY device "
                        "mesh (shard_map + ppermute halos; requires "
                        "MX*MY <= len(jax.devices()))")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent on-disk XLA compilation "
                        "cache used on the GPU (directory: "
                        "$JAX_COMPILATION_CACHE_DIR, else .jax_cache in "
                        "the checkout)")
    p.add_argument("--links", choices=["auto", "on", "off"], default="auto",
                   help="level-0 links-only (spin-projected) fast path: "
                        "auto = complex64 only (default), on = any dtype, "
                        "off = dense stencil everywhere")
    p.add_argument("--no-halo-overlap", action="store_true",
                   help="distributed solves: use the permute-then-concat "
                        "halo baseline instead of the interior/boundary "
                        "overlap schedule (parallel/halo.py)")
    p.add_argument("--null-joint-qr", action="store_true",
                   help="jointly orthonormalize near-null candidates "
                        "during generation (robust on <=4^2 setup "
                        "levels; see ops/nearnull.relax_null_vectors)")
    return p


def parse_args(argv):
    # Reference positional style: 8 bare numbers.
    if len(argv) >= 8 and all(not a.startswith("-") for a in argv[:8]):
        from .config import from_reference_argv
        cfg = from_reference_argv(argv[:8])
        ns = build_parser().parse_args(argv[8:])
        return cfg, ns
    ns = build_parser().parse_args(argv)
    from .config import MGConfig
    cfg = MGConfig(
        L=ns.L, stencil=ns.stencil, m=ns.m, nlevels=ns.nlevels,
        block_x=ns.block, block_y=ns.block, num_iters=ns.num_iters,
        smoother=ns.smoother, ntl=ns.ntl, n_copies=ns.n_copies,
        min_res=not ns.no_min_res, ntl_combine=ns.ntl_combine,
        gen_null=bool(ns.gen_null),
        null_iters=ns.null_iters, res_threshold=ns.res_threshold,
        max_iters=ns.max_iters, quad=ns.quad, beta=ns.beta, seed=ns.seed,
        dtype=ns.dtype, ndof_coarse=ns.ndof_coarse,
        links=getattr(ns, "links", "auto"),
        halo_overlap=not getattr(ns, "no_halo_overlap", False),
        null_joint_qr=getattr(ns, "null_joint_qr", False))
    return cfg, ns


def _run_geometric(ns) -> int:
    """gen-1 / gen-2 geometric program path (real scalar, no gauge, no
    hierarchy; sum|r| norm)."""
    import jax
    if ns.platform:
        jax.config.update("jax_platforms", ns.platform)
    jax.config.update("jax_enable_x64", True)  # sum|r| thresholds need f64
    from .solver import geometric as geo

    if ns.mode == "geo":
        cfg = geo.GeoConfig(L=ns.L, m=ns.m, nlevels=ns.nlevels,
                            num_iters=ns.num_iters,
                            res_threshold=ns.res_threshold,
                            smoother=ns.smoother)
        b = geo.geo_source(cfg)
        # mixed-precision defect correction: f32 V-cycles, f64 outer loop
        solve = geo.geo_solve_ir if ns.geo_ir else geo.geo_solve
    else:
        combine = "single" if ns.ntl_combine == "avg_coarse" else "divide"
        cfg = geo.Geo2Config(L=ns.L, m=ns.m, nlevels=ns.nlevels,
                             num_iters=ns.num_iters,
                             res_threshold=ns.res_threshold,
                             smoother=ns.smoother, t_flag=ns.ntl,
                             n_copies=min(ns.n_copies, 4), quad=ns.quad,
                             combine=combine)
        b = geo.geo2_source(cfg)
        solve = geo.geo2_solve
    print(f"mode={ns.mode} L={cfg.L} m={cfg.m} nlevels={cfg.nlevels} "
          f"num_iters={cfg.num_iters} smoother={cfg.smoother}")
    t0 = time.time()
    phi, iters, res, hist = solve(b, cfg, max_iters=ns.max_iters)
    dt = time.time() - t0
    converged = res < cfg.res_threshold
    status = "converged" if converged else "NOT converged"
    print(f"{status} in {iters} cycles, sum|r| = {res:.3e}, {dt:.1f}s")
    os.makedirs(ns.out_dir, exist_ok=True)
    with open(f"{ns.out_dir}/solve_summary.json", "w") as f:
        json.dump({"mode": ns.mode, "L": cfg.L, "m": cfg.m,
                   "nlevels": cfg.nlevels, "iters": iters,
                   "res_l1": res, "converged": bool(converged),
                   "seconds": dt, "history": list(map(float, hist))}, f)
    return 0 if converged else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg, ns = parse_args(argv)
    if getattr(ns, "mode", "adaptive") != "adaptive":
        return _run_geometric(ns)

    import jax
    if ns.platform:
        jax.config.update("jax_platforms", ns.platform)
    if cfg.dtype == "complex128":
        jax.config.update("jax_enable_x64", True)
    if getattr(ns, "debug_nans", False):
        jax.config.update("jax_debug_nans", True)
    if not getattr(ns, "no_compile_cache", False):
        # a second run with the same shapes loads its setup programs
        # from disk instead of compiling them
        from .utils.compile import enable_persistent_cache
        enable_persistent_cache()

    import tpu_multigrid as mg
    from .models import gauge as G
    from .utils import io as mio

    print(f"stencil={cfg.stencil} L={cfg.L} m={cfg.m} nlevels={cfg.nlevels} "
          f"ntl={cfg.ntl} smoother={cfg.smoother} dtype={cfg.dtype}")
    print("level sizes:", cfg.sizes, "n_dof:", cfg.n_dof)

    # Gauge field.
    if ns.gauge == "identity":
        U = G.identity_gauge(cfg.L, cfg.cdtype)
    elif ns.gauge == "random":
        U = G.random_gauge(cfg.L, jax.random.PRNGKey(cfg.seed), 0.2,
                           cfg.cdtype)
    elif ns.gauge == "heatbath":
        th = G.heatbath_ensemble(cfg.L, cfg.beta, ns.heatbath_sweeps,
                                 cfg.seed)
        U = G.gauge_from_phases(th, cfg.cdtype)
    else:
        U = G.read_heatbath_file(ns.gauge_file, cfg.L, cfg.cdtype)
    plaq = complex(G.plaquette(U))
    print(f"plaquette: {plaq.real:.6f} + {plaq.imag:.2e}i")

    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)

    # Near-null setup (optionally from checkpoint, like gen_null=0).
    phi_null_init = None
    if not cfg.gen_null:
        path = ns.checkpoint or mio.near_null_filename(cfg)
        print(f"reading near-null checkpoint {path}")
        loader = (mio.load_near_null_npz if path.endswith(".npz")
                  else mio.load_near_null_text)
        arrs = loader(path) if path.endswith(".npz") else loader(path, cfg)
        import jax.numpy as jnp
        from .utils.xfer import device_complex
        phi_null_init = tuple(device_complex(a, cfg.cdtype) for a in arrs)

    t0 = time.time()
    # U= -> level-0 links-only fast path in complex64 solves (cfg.links)
    hier = jax.block_until_ready(
        mg.build_hierarchy(D, cfg, phi_null_init=phi_null_init, U=U))
    t_setup = time.time() - t0
    print(f"setup done in {t_setup:.1f}s")

    if cfg.gen_null and ns.checkpoint:
        saver = (mio.save_near_null_npz if ns.checkpoint.endswith(".npz")
                 else mio.save_near_null_text)
        from .utils.xfer import host_complex
        saver(ns.checkpoint, [host_complex(hier.levels[l].phi_null)
                              for l in range(cfg.nlevels)])
        print(f"wrote near-null checkpoint {ns.checkpoint}")

    # Self-test pass (reference f_MG_tests runs before every solve).
    worst = None
    if not ns.skip_tests:
        checks = mg.testing.run_mg_tests(hier, cfg)
        worst = max(checks.values())
        bad = {k: v for k, v in checks.items()
               if v > mg.testing.epsilon_for(cfg)}
        print(f"self-tests: {len(checks)} checks, worst {worst:.3e}"
              + (f"  FAILURES: {bad}" if bad else "  (all pass)"))

    if getattr(ns, "roofline", False):
        from . import profiling
        b0 = mg.point_source(cfg)
        tab = profiling.roofline_table(cfg, hier.levels[0].D, b0)
        print(f"roofline ({tab['device']}, peak "
              f"{tab['peak_bytes_per_s']/1e9:.0f} GB/s, "
              f"{tab['peak_source']}):")
        for row in tab["rows"]:
            share = row["roofline_share"]
            print(f"  {row['name']:16s} {row['sec']*1e6:9.1f} us  "
                  f"{row['bytes']/1e6:8.2f} MB  "
                  f"{row['bytes_per_s']/1e9:8.1f} GB/s  "
                  + ("(working set below 4x L2: no roofline share)"
                     if share is None else f"{share*100:6.1f}% of peak"))

    b = mg.point_source(cfg)
    writer = mio.ResultsWriter(cfg, ns.out_dir)
    t0 = time.time()
    if getattr(ns, "mesh", None):
        from .parallel import sharded
        mx, my = (int(x) for x in ns.mesh.split(","))
        mesh = sharded.make_mesh((mx, my))
        hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
        solver = sharded.make_sharded_solver(cfg, mesh, cfg.max_iters)(hier_s)
        phis, iters, res = solver(hier_s, mg.zero_fields(cfg), b)
        from .solver.driver import SolveResult
        from .utils.xfer import host_complex
        out = SolveResult(phi=host_complex(phis[0]), iters=int(iters),
                          resmag=float(res),
                          converged=float(res) < cfg.res_threshold)
    elif getattr(ns, "resume", None):
        from .utils.checkpoint import solve_resumable
        out = solve_resumable(hier, b, cfg, ns.resume,
                              checkpoint_every=ns.checkpoint_every)
    elif getattr(ns, "solver", "stationary") == "fgmres":
        from .solver.krylov import fgmres_solve
        phi, iters, rel = fgmres_solve(hier, b, cfg)
        from .solver.driver import SolveResult
        out = SolveResult(phi=phi, iters=iters, resmag=rel,
                          converged=rel < cfg.res_threshold)
    elif getattr(ns, "solver", "stationary") == "ir":
        out = mg.solve_ir(hier, b, cfg,
                          inner_cycles=getattr(ns, "ir_inner_cycles", 2))
    elif getattr(ns, "solver", "stationary") == "fmg":
        out = mg.solve_fmg(hier, b, cfg)
    elif getattr(ns, "solver", "stationary") == "cgnr":
        # indefinite-capable: CG on the normal equations (krylov.py) —
        # converges where stationary MG / fgmres / eo_mr stall (the
        # reference's literal m=-0.07 regime on beta=32 ensembles)
        from .solver.krylov import cgnr_solve
        phi, iters, rel = cgnr_solve(hier.levels[0].D, b,
                                     tol=cfg.res_threshold,
                                     max_iters=cfg.max_iters, chunk=500)
        from .solver.driver import SolveResult
        from .utils.xfer import host_complex
        out = SolveResult(phi=host_complex(phi), iters=iters, resmag=rel,
                          converged=rel < cfg.res_threshold)
    elif getattr(ns, "solver", "stationary") == "eo_mr":
        phi, iters, rel = mg.eo_mr_solve(hier.levels[0].D, b,
                                         tol=cfg.res_threshold,
                                         max_iters=cfg.max_iters, chunk=200)
        from .solver.driver import SolveResult
        from .utils.xfer import host_complex
        out = SolveResult(phi=host_complex(phi), iters=iters, resmag=rel,
                          converged=rel < cfg.res_threshold)
    else:
        out = mg.solve_with_history(hier, b, cfg, writer=writer)
    dt = time.time() - t0
    writer.write_scaling_summary(out.iters)
    writer.close()

    status = "converged" if out.converged else "NOT converged"
    print(f"{status} in {out.iters} cycles, rel residual {out.resmag:.3e}, "
          f"{dt:.1f}s")
    with open(f"{ns.out_dir}/solve_summary.json", "w") as f:
        json.dump({"L": cfg.L, "m": cfg.m, "stencil": cfg.stencil,
                   "nlevels": cfg.nlevels, "ntl": cfg.ntl,
                   "iters": out.iters, "resmag": out.resmag,
                   "converged": out.converged, "seconds": dt,
                   "setup_seconds": t_setup, "self_tests_worst": worst,
                   "plaquette": [plaq.real, plaq.imag]}, f)
    return 0 if out.converged else 1


if __name__ == "__main__":
    sys.exit(main())

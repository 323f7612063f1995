"""Benchmark harness: level-0 stencil and smoother throughput and
end-to-end solves on the current accelerator.

  python bench.py                          all phases, one after another
  python bench.py --phase NAME --out F     one phase, result JSON to F

Each phase runs in a child process of its own and the parent never imports
JAX, so only one JAX process holds the card at a time. The parent writes
every phase's result to bench_details.json and prints, as its last line,
one JSON headline:
  {"metric": "wilson_stencil_spmv_nnz_per_s", "value": ..., "unit": "nnz/s",
   "vs_baseline": <roofline share of that path or null>, "device_kind": ...}
taken from the L=2048 stencil phase: the path with the best roofline share
among those whose working set streams from device memory (at least
profiling.STREAM_L2_MULTIPLE x the L2; smaller sets report bytes/s only).

Every timing ends in block_until_ready or a host fetch. Every alternative
path is checked against the dense XLA reference before its time counts.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1800))
PHASE_TIMEOUT_S = 600.0


# Measured trajectory of the UNMODIFIED reference gen-1 headline binary
# (2D_laplace_Mgrid.cpp:118-123: L=2048, m=0.002, 9 levels, 20 GS
# sweeps/level, threshold sum|r| < 1e-14) on a host CPU, single thread,
# g++ -O2, per-iteration timestamps (2026-08-20): per-iteration sum|r| =
# 0.84, 2.2e-2, 2.8e-4, 5.1e-6, 7.0e-8, 9.6e-10, 4.9e-12, 1.2e-12 —
# crosses 1e-8 at CYCLE 5 (~1.54 s/cycle), then fluctuates in
# [3.0e-13, 6.5e-13] through iteration 630+ (1020 s) without ever
# reaching 1e-14. That plateau is a floating-point artifact of in-place
# lexicographic GS with scale ~= 2^-2 (the residue expression cancels
# BITWISE on non-source sites at the fp fixed point; verified at L=64
# where the reference plateaus at exactly 1 ulp = 2.22e-16 while any
# buffered/vectorized smoother — ours or its own Jacobi — floors at the
# honest per-site-eps level eps*sum|phi| ~ 1e-12*(L/64)^2). No parallel
# implementation can cross ~1e-9 at L=2048; the honest race is cycles/
# seconds to sum|r| < 1e-8, which BOTH codes pass in ~5 cycles.
_REF_GEN1_CPU = {
    "host": "single-thread CPU", "compiler": "g++ -O2",
    "measured": "2026-08-20",
    "sec_per_cycle": 1.54,
    "history_per_cycle": [0.840399, 0.022314, 2.80892e-4, 5.07859e-6,
                          6.96268e-8, 9.64611e-10, 4.93028e-12,
                          1.24434e-12],
    "cycles_to_1e-7": 5, "seconds_to_1e-7": 7.7,
    "cycles_to_1e-8": 6, "seconds_to_1e-8": 9.2,
    "plateau_sum_r": "3.0e-13..6.5e-13 (in-place-GS fp artifact; see "
                     "PARITY.md 'Known deviations')",
    "seconds_to_1e-14_threshold": "never (observed flat through iter 630, "
                                  "1020 s; 10000-cycle run ~= 4.3 h)"}


# Measured trajectory of the reference FINAL generation (wilson NTL,
# L=256, num_iters=4, block=2, m=-0.005, nlevels=3, t_flag=1, n_copies=4
# — the flagship solve256 config) compiled via scripts/reference_oracle
# .run_final_gen (g++ -O2 -std=c++17 against the repo's Eigen shim) on the
# SAME gauge configuration bench_solve256 uses (Gaussian phases 0.2*N(0,1),
# seed 4302529), single thread, host CPU, 2026-08-20.
_REF_FLAGSHIP_CPU = {
    "host": "single-thread CPU", "compiler": "g++ -O2 (Eigen-shim)",
    "measured": "2026-08-20", "config": "wilson NTL 256^2 nlevels=3 "
    "num_iters=4 n_copies=4 m=-0.005 (same gauge config as solve256)",
    "setup_seconds": 124.9, "sec_per_cycle": 1.489,
    "cycles_to_1e-6": 10, "seconds_to_1e-6_after_setup": 14.6,
    "cycles_to_1e-8": 15, "cycles_to_1e-13": 28,
    "total_seconds_to_1e-13": 164.6,
    "history_head": [0.103148, 0.0109218, 0.00178452]}


def _device():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _wilson_problem(L, m, dtype, seed=7, batch=None):
    """Gauge links from Gaussian phases 0.2*N(0,1), the dense operator and
    a random spinor field."""
    import jax
    import jax.numpy as jnp
    import tpu_multigrid as mg
    cdt = jnp.dtype(dtype)
    rng = np.random.default_rng(seed)
    shape = (2, L, L) if batch is None else (batch, 2, L, L)
    U = mg.models.gauge.gauge_from_phases(0.2 * rng.normal(size=shape), cdt)
    asm = lambda u: mg.models.operators.assemble("wilson", u, m)
    D = asm(U) if batch is None else jax.vmap(asm)(U)
    v = jnp.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                    cdt)
    return U, D, v


def _rel_err(a, ref):
    import jax.numpy as jnp
    return float(jnp.max(jnp.abs(a - ref)) / jnp.max(jnp.abs(ref)))


def _bounded(f):
    """f scaled by 1/4 (|D| <= 4), so x -> f(..., x) iterated in a timed
    loop stays finite; the scale fuses into the same pass."""
    return lambda *a: 0.25 * f(*a)


def _stencil_result(L, n, kind, times, path_bytes, batch=1):
    """Per-path rows (bytes/s, nnz/s and, for streaming working sets, the
    roofline share) and the headline path: the best roofline share among
    streaming paths, else the highest nnz/s."""
    from tpu_multigrid.profiling import roofline_share
    nnz = batch * 5 * n * n * L * L
    rows = {}
    for name, dt in times.items():
        b = path_bytes[name]
        rows[name] = {"sec_per_apply": dt, "bytes_per_apply": b,
                      "achieved_bytes_per_s": b / dt, "nnz_per_s": nnz / dt,
                      "roofline_share": roofline_share(b, dt, kind)}
    streaming = [k for k in rows if rows[k]["roofline_share"] is not None]
    best = (max(streaming, key=lambda k: rows[k]["roofline_share"])
            if streaming else max(rows, key=lambda k: rows[k]["nnz_per_s"]))
    return {"device_kind": kind, "L": L, "n": n, "batch": batch,
            "paths": rows, "best_path": best, **rows[best]}


def bench_stencil(L=256, reps=100):
    """reps x apply_D per path in one jitted fori_loop: XLA dense einsum,
    XLA dense unrolled, and XLA links-only (spin-projected) — identical
    math, different operator representation and bytes."""
    import jax
    import jax.numpy as jnp
    from tpu_multigrid.ops.stencil import apply_D, apply_D_unrolled
    from tpu_multigrid.ops.gauge_stencil import apply_wilson_u
    from tpu_multigrid.profiling import level0_bytes, time_op

    m = -0.07
    U, D, v = _wilson_problem(L, m, "complex64")
    n = 2
    dense = level0_bytes("dense", n, L, rhs=False)
    links = level0_bytes("links", n, L, rhs=False)
    paths = {"xla": (apply_D, (D, v), dense),
             "xla_unroll": (apply_D_unrolled, (D, v), dense),
             "xla_u": (lambda U, v: apply_wilson_u(U, m, v), (U, v), links)}
    ref = jax.jit(apply_D)(D, v)
    times, path_bytes, errs = {}, {}, {}
    for name, (f, args, nbytes) in paths.items():
        errs[name] = _rel_err(jax.jit(f)(*args), ref)
        if not errs[name] < 1e-5:
            raise RuntimeError(f"{name}: rel err {errs[name]:.2e} vs xla")
        times[name] = time_op(_bounded(f), *args, reps=reps)
        path_bytes[name] = nbytes
    out = _stencil_result(L, n, jax.devices()[0].device_kind, times,
                          path_bytes)
    out["rel_err_vs_xla"] = errs
    return out


def bench_stencil_batch(L=256, B=8, reps=200):
    """A batch of B gauge configurations, vmapped: the ensemble shape."""
    import jax
    from tpu_multigrid.ops.stencil import apply_D
    from tpu_multigrid.ops.gauge_stencil import apply_wilson_u
    from tpu_multigrid.profiling import level0_bytes, time_op

    m = -0.07
    U, D, v = _wilson_problem(L, m, "complex64", batch=B)
    n = 2
    fd = jax.vmap(apply_D)
    fu = jax.vmap(lambda u, x: apply_wilson_u(u, m, x))
    ref = jax.jit(fd)(D, v)
    err = _rel_err(jax.jit(fu)(U, v), ref)
    if not err < 1e-5:
        raise RuntimeError(f"links batch: rel err {err:.2e} vs xla")
    times = {"xla_batch": time_op(_bounded(fd), D, v, reps=reps),
             "xla_u_batch": time_op(_bounded(fu), U, v, reps=reps)}
    path_bytes = {"xla_batch": B * level0_bytes("dense", n, L, rhs=False),
                  "xla_u_batch": B * level0_bytes("links", n, L, rhs=False)}
    return _stencil_result(L, n, jax.devices()[0].device_kind, times,
                           path_bytes, batch=B)


def bench_smoother_links(L=2048, n_sweeps=4, reps=10):
    """Level-0 rbgs smoother as the cycle dispatches it: the links-only
    form (ops/gauge_stencil.smooth_u) against the dense form
    (ops/smoothers.smooth), identical math."""
    import jax
    from tpu_multigrid.ops.gauge_stencil import smooth_u
    from tpu_multigrid.ops.smoothers import smooth
    from tpu_multigrid.ops.stencil import site_inverse
    from tpu_multigrid.profiling import level0_bytes, time_op

    m = -0.005
    U, D, phi = _wilson_problem(L, m, "complex64")
    r = phi[::-1]
    Dinv = site_inverse(D[0])
    fu = lambda U, r, p: smooth_u("wilson", U, m, p, r, n_sweeps, "rbgs")
    fd = lambda D, Di, r, p: smooth(D, Di, p, r, n_sweeps, "rbgs")
    err = _rel_err(jax.jit(fu)(U, r, phi), jax.jit(fd)(D, Dinv, r, phi))
    if not err < 2e-6:
        raise RuntimeError(f"links smoother: rel err {err:.2e} vs dense")
    tu = time_op(fu, U, r, phi, reps=reps)
    td = time_op(fd, D, Dinv, r, phi, reps=reps)
    bu = level0_bytes("links", 2, L, passes=n_sweeps)
    bd = level0_bytes("dense", 2, L, passes=n_sweeps)
    return {"L": L, "n_sweeps": n_sweeps, "kind": "rbgs",
            "rel_err_links_vs_dense": err,
            "dense_ms_per_smooth": td * 1e3,
            "links_ms_per_smooth": tu * 1e3,
            "dense_bytes_per_s": bd / td, "links_bytes_per_s": bu / tu,
            "links_speedup": td / tu,
            "device_kind": jax.devices()[0].device_kind}


def bench_mg_vs_mr(L=256):
    """Wilson MG solve to 1e-8 vs unpreconditioned MR (cycle counts) at
    the full BASELINE config (wilson 256^2, >=5x target). complex128:
    the complex64 rounding plateau sits right at the 1e-8 target. The
    cycle counts are hardware-independent, so this phase runs on the host
    CPU (the parent sets JAX_PLATFORMS=cpu for it)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import tpu_multigrid as mg

    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=3, ntl=True,
                      num_iters=4, null_iters=100, dtype="complex128",
                      res_threshold=1e-8, smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)
    U = mg.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)
    b = mg.point_source(cfg)
    hier = mg.build_hierarchy(D, cfg, check=False)
    t0 = time.perf_counter()
    out = mg.solve_chunked(hier, b, cfg, max_iters=500, chunk=5)
    t_solve = time.perf_counter() - t0
    _, mr_iters, mr_rel = mg.mr_solve(D, b, tol=1e-8, max_iters=300000,
                                      chunk=100)
    return {"L": L, "dtype": "complex128", "mg_cycles": out.iters,
            "mg_res": out.resmag, "mg_converged": out.converged,
            "mg_seconds": t_solve, "mr_iters": mr_iters, "mr_res": mr_rel,
            "cycle_reduction": mr_iters / max(out.iters, 1),
            **_device()}


def _flagship(dtype, seed_offset=0):
    """Wilson NTL 256^2 (the flagship config) on Gaussian phases."""
    import tpu_multigrid as mg
    L = 256
    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=3, ntl=True,
                      num_iters=4, null_iters=100, dtype=dtype,
                      res_threshold=1e-6, smoother="rbgs")
    rng = np.random.default_rng(cfg.seed + seed_offset)
    U = mg.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)
    return cfg, U, D


def _timed_setup(D, cfg, U):
    import jax
    import tpu_multigrid as mg
    t0 = time.perf_counter()
    hier = jax.block_until_ready(mg.build_hierarchy(D, cfg, check=False,
                                                    U=U))
    return hier, time.perf_counter() - t0


def bench_solve256():
    """Flagship wilson 256^2 NTL solve in complex64 to 1e-6: setup (cold,
    then warm on a fresh gauge configuration with identical shapes), the
    solve, and the per-cycle time of a fixed 24-cycle program."""
    import tpu_multigrid as mg

    cfg, U, D = _flagship("complex64")
    _, Ub, Db = _flagship("complex64", seed_offset=1)
    b = mg.point_source(cfg)
    hier, t_setup = _timed_setup(D, cfg, U)
    _, t_setup_warm = _timed_setup(Db, cfg, Ub)
    t0 = time.perf_counter()
    out = mg.solve_chunked(hier, b, cfg, max_iters=200, chunk=5)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mg.solve_chunked(hier, b, cfg, max_iters=200, chunk=5)
    t_warm = time.perf_counter() - t0
    n_f = 24
    mg.solve_chunked(hier, b, cfg, max_iters=n_f, chunk=n_f)   # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        mg.solve_chunked(hier, b, cfg, max_iters=n_f, chunk=n_f)
        best = min(best, time.perf_counter() - t0)
    sec_cyc = best / n_f
    return {"L": 256, "dtype": "complex64", "cycles": out.iters,
            "res": out.resmag, "converged": out.converged,
            "setup_seconds": t_setup, "setup_seconds_warm": t_setup_warm,
            "solve_seconds_cold": t_cold, "solve_seconds_warm": t_warm,
            "sec_per_cycle": sec_cyc,
            "speedup_per_cycle_vs_ref":
                _REF_FLAGSHIP_CPU["sec_per_cycle"] / sec_cyc,
            "vs_reference_cpu": _REF_FLAGSHIP_CPU, **_device()}


def bench_solve256_ir():
    """The literal BASELINE solve: wilson 256^2 NTL to 1e-8 and to the
    reference's own 1e-13 (params.h:67) by mixed-precision iterative
    refinement (driver.solve_ir): setup and all MG cycles in complex64,
    one exact complex128 stencil apply per outer step."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import tpu_multigrid as mg
    from tpu_multigrid.solver.driver import solve_ir

    cfg64, U, D = _flagship("complex64")
    _, Ub, Db = _flagship("complex64", seed_offset=1)
    cfg128 = cfg64.replace(dtype="complex128")
    D128 = D.astype(cfg128.cdtype)
    b = mg.point_source(cfg128)
    hier, t_setup = _timed_setup(D, cfg64, U)
    _, t_setup_warm = _timed_setup(Db, cfg64, Ub)

    def ir(thr):
        return solve_ir(hier, b, cfg128.replace(res_threshold=thr),
                        inner_cycles=2, max_iters=200, D_outer=D128)

    ir(1e-13)                                  # compile
    t0 = time.perf_counter()
    out8 = ir(1e-8)
    t_8 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out13 = ir(1e-13)
    t_13 = time.perf_counter() - t0
    if not (out8.converged and out13.converged):
        raise RuntimeError(
            f"not converged: {out8.resmag:.2e}/{out13.resmag:.2e} "
            f"after {out8.iters}/{out13.iters}")
    ref = _REF_FLAGSHIP_CPU
    return {"L": 256, "mode": "ir c64 cycles + c128 defect",
            "cycles_to_1e-8": out8.iters, "res_1e-8": out8.resmag,
            "seconds_to_1e-8_warm": t_8,
            "cycles_to_1e-13": out13.iters, "res_1e-13": out13.resmag,
            "seconds_to_1e-13_warm": t_13,
            "history_1e-13": [float(h) for h in out13.history],
            "setup_seconds": t_setup, "setup_seconds_warm": t_setup_warm,
            "ref_cycles_to_1e-8": ref["cycles_to_1e-8"],
            "ref_cycles_to_1e-13": ref["cycles_to_1e-13"],
            "ref_total_seconds_to_1e-13": ref["total_seconds_to_1e-13"],
            **_device()}


def bench_ensemble(B=8, L=128):
    """B independent gauge configurations: batched adaptive setup and a
    batched fixed-cycle NTL solve, each ONE vmapped XLA program
    (solver/ensemble.py). Reports configs/s and per-phase seconds."""
    import jax
    import jax.numpy as jnp
    import tpu_multigrid as mg
    from tpu_multigrid.solver import ensemble as ens

    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                      num_iters=4, null_iters=60, dtype="complex64",
                      res_threshold=1e-6, smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)
    phases = 0.2 * rng.normal(size=(2, B, 2, L, L))
    Us, Us2 = (mg.models.gauge.gauge_from_phases(p, cfg.cdtype)
               for p in phases)
    b = mg.point_source(cfg)
    bs = jnp.broadcast_to(b, (B,) + b.shape)
    t0 = time.perf_counter()
    hier_b = jax.block_until_ready(ens.build_hierarchies_batched(Us, cfg))
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(ens.build_hierarchies_batched(Us2, cfg))
    t_setup_warm = time.perf_counter() - t0
    n_cyc = 18
    t0 = time.perf_counter()
    ens.solve_ensemble(hier_b, bs, cfg, n_cycles=n_cyc)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, res = ens.solve_ensemble(hier_b, bs, cfg, n_cycles=n_cyc)
    t_warm = time.perf_counter() - t0
    if not np.all(np.isfinite(res)):
        raise RuntimeError("non-finite ensemble residuals")
    return {"B": B, "L": L, "dtype": "complex64", "n_cycles": n_cyc,
            "max_rel_res": float(np.max(res)),
            "all_below_1e-5": bool(np.max(res) < 1e-5),
            "setup_seconds": t_setup, "setup_seconds_warm": t_setup_warm,
            "solve_seconds_cold": t_cold, "solve_seconds_warm": t_warm,
            "configs_per_s_warm": B / t_warm, **_device()}


def bench_geo2048():
    """The reference's own headline run (gen 1: geometric MG, L=2048,
    m=0.002, 9 levels, 20 sweeps/level — 2D_laplace_Mgrid.cpp:118-123)
    end to end, against the compiled reference's measured single-thread
    CPU trajectory (_REF_GEN1_CPU), with the mixed-precision solver (f32
    V-cycles inside an f64 defect-correction loop). The race is to
    sum|r| < 1e-7, the tightest decade both codes' computed residuals
    cross (PARITY.md "Known deviations")."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from tpu_multigrid.solver.geometric import (GeoConfig, geo_source,
                                                geo_residual_floor,
                                                geo_solve_ir)

    cfg = GeoConfig(res_threshold=1e-7, max_iters=12)
    b = geo_source(cfg)
    t0 = time.perf_counter()
    phi, iters, resmag, hist = geo_solve_ir(b, cfg, chunk=1)
    t_cold = time.perf_counter() - t0
    n_f = 12
    geo_solve_ir(b, cfg, max_iters=n_f, chunk=n_f)          # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        geo_solve_ir(b, cfg, max_iters=n_f, chunk=n_f)
        best = min(best, time.perf_counter() - t0)
    sec_cyc = best / n_f
    floor = geo_residual_floor(jnp.asarray(phi), b, cfg)
    return {"L": cfg.L, "nlevels": cfg.nlevels,
            "solver": "geo_solve_ir (f32 V-cycles, f64 defect)",
            "race_threshold_sum_r": cfg.res_threshold,
            "cycles_to_1e-7": iters, "final_res_l1": resmag,
            "reached_1e-7": resmag < cfg.res_threshold,
            "f64_residual_floor_estimate": floor,
            "seconds_cold": t_cold, "sec_per_cycle": sec_cyc,
            "seconds_to_1e-7_warm": sec_cyc * iters,
            "speedup_vs_ref_cpu_per_cycle":
                _REF_GEN1_CPU["sec_per_cycle"] / sec_cyc,
            "history": [float(h) for h in hist],
            "vs_reference_cpu": _REF_GEN1_CPU, **_device()}


# reps are sized so each timed loop runs for at least ~0.1 s on the card
PHASES = {
    "stencil_2048": lambda: bench_stencil(L=2048, reps=200),
    "stencil_4096": lambda: bench_stencil(L=4096, reps=50),
    "stencil_1024": lambda: bench_stencil(L=1024, reps=800),
    "stencil_256": lambda: bench_stencil(L=256, reps=5000),
    "stencil_batch": lambda: bench_stencil_batch(B=8, reps=1000),
    "smoother_2048": lambda: bench_smoother_links(L=2048),
    "solve256": bench_solve256,
    "solve256_ir": bench_solve256_ir,
    "ensemble8": bench_ensemble,
    "geo2048": bench_geo2048,
    "mg_vs_mr": bench_mg_vs_mr,
}
HEADLINE_PHASE = "stencil_2048"
# hardware-independent phases (cycle counts) run on the host CPU
_CPU_PHASES = {"mg_vs_mr"}


def _run_phase(phase: str, out_dir: str, timeout_s: float) -> dict:
    out_file = os.path.join(out_dir, f"bench_phase_{phase}.json")
    env = dict(os.environ)
    if phase in _CPU_PHASES:
        env["JAX_PLATFORMS"] = "cpu"
    t0 = time.time()
    try:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--phase", phase, "--out", out_file],
                           capture_output=True, text=True, env=env,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"error": f"timed out after {timeout_s:.0f} s",
                "phase_seconds": time.time() - t0}
    if p.returncode != 0:
        return {"error": f"rc={p.returncode}", "stderr": p.stderr[-2000:],
                "phase_seconds": time.time() - t0}
    with open(out_file) as f:
        r = json.load(f)
    r["phase_seconds"] = time.time() - t0
    return r


def _headline(stream: dict) -> dict:
    if "nnz_per_s" not in stream:
        return {"metric": "wilson_stencil_spmv_nnz_per_s", "value": 0.0,
                "unit": "nnz/s", "vs_baseline": None,
                "error": stream.get("error", "not measured")}
    return {"metric": "wilson_stencil_spmv_nnz_per_s",
            "value": float(stream["nnz_per_s"]), "unit": "nnz/s",
            "vs_baseline": stream["roofline_share"],
            "path": stream["best_path"],
            "device_kind": stream["device_kind"]}


def main():
    if "--phase" in sys.argv:
        phase = sys.argv[sys.argv.index("--phase") + 1]
        out = sys.argv[sys.argv.index("--out") + 1]
        if phase not in _CPU_PHASES:
            from tpu_multigrid.profiling import device_peak
            from tpu_multigrid.utils.compile import enable_persistent_cache
            device_peak()      # fail fast on a device with no known peak
            enable_persistent_cache()
        result = PHASES[phase]()
        with open(out, "w") as f:
            json.dump(result, f, default=float)
        return

    out_dir = os.environ.get("BENCH_OUT_DIR", ".")
    t_start = time.time()
    details = {"budget_s": BUDGET_S}
    order = [HEADLINE_PHASE] + [p for p in PHASES if p != HEADLINE_PHASE]
    for phase in order:
        left = BUDGET_S - (time.time() - t_start)
        if left < 30:
            details[phase] = {"skipped": "budget exhausted"}
            continue
        details[phase] = _run_phase(phase, out_dir,
                                    min(PHASE_TIMEOUT_S, left))
        with open(os.path.join(out_dir, "bench_details.json"), "w") as f:
            json.dump(details, f, indent=2, default=float)
    print(json.dumps(_headline(details[HEADLINE_PHASE])), flush=True)


if __name__ == "__main__":
    main()

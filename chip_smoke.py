"""Smoke test of the solver on an NVIDIA GPU, through its normal entry
points, at the reference deployment's real size.

  python chip_smoke.py           phases 1-3 on one card
  python chip_smoke.py --four    the 4-card mesh and ensemble paths only

Phases (one process; every timing ends in block_until_ready or a host
fetch):
  1. flagship_cli  tpu_multigrid.cli.main on the flagship deployment —
                   Wilson NTL 256^2, 3 levels, 4 coarse copies,
                   num_iters=4, m=-0.005, beta=32 heat-bath gauge,
                   complex64, to 1e-6 — converged, self-tests passing,
                   cycle count within 1 of the CPU's (CPU_FLAGSHIP_CYCLES).
  2. flagship_ir   the same deployment through --solver ir in complex128
                   (complex64 inner cycles) to 1e-12.
  3. level0_2048   the level-0 links-only residual and rbgs smoother the
                   cycle dispatches (solver/cycles._residual0, _relax) at
                   L=2048 against the dense reference (ops/stencil.residual,
                   ops/smoothers.smooth) on the same card, with achieved
                   bytes/s against a measured device copy and the
                   published peak.
  4. four (--four) the flagship on a (2,2) mesh (parallel.setup +
                   parallel.sharded) against the same config on card 0,
                   and a 4-config ensemble over a ('config',) mesh against
                   the unsharded run.

Exits non-zero, and never prints '"ok": true', when JAX finds no GPU or
any phase fails. The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# Cycles to 1e-6 of phase flagship_cli with JAX on the CPU (x86-64 host,
# complex64; final rel residual 8.855e-07), measured 2026-10-16.
CPU_FLAGSHIP_CYCLES = 15

FLAGSHIP = ["--L", "256", "--stencil", "wilson", "--m", "-0.005",
            "--nlevels", "3", "--ntl", "--n-copies", "4", "--num-iters", "4",
            "--smoother", "rbgs", "--gauge", "heatbath", "--beta", "32",
            "--seed", "4302529"]

# Bound of the links-only level-0 kernels against the dense reference in
# complex64 (both sum the same terms in another order).
LEVEL0_TOL = 2e-6

# The CLI's result files (a full field per cycle) go here and are removed
# once each phase has read its summary.
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".chip_smoke")


class PhaseError(RuntimeError):
    pass


def _require(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, read by nvidia-smi in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _cli(args, out_dir):
    from tpu_multigrid import cli
    os.makedirs(out_dir, exist_ok=True)
    try:
        rc = cli.main(list(args) + ["--out-dir", out_dir])
        with open(os.path.join(out_dir, "solve_summary.json")) as f:
            return rc, json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_flagship_cli(out_dir=OUT_DIR, extra=(),
                       expect_cycles=CPU_FLAGSHIP_CYCLES):
    rc, s = _cli(FLAGSHIP + ["--dtype", "complex64", "--res-threshold",
                             "1e-6", *extra],
                 os.path.join(out_dir, "flagship_cli"))
    _require(rc == 0 and s["converged"],
             f"flagship_cli: rc={rc}, converged={s['converged']}, "
             f"res {s['resmag']:.3e} after {s['iters']} cycles")
    _require(s["self_tests_worst"] is not None
             and s["self_tests_worst"] <= 1e-4,
             f"flagship_cli: self-tests worst {s['self_tests_worst']}")
    if expect_cycles is not None:
        _require(abs(s["iters"] - expect_cycles) <= 1,
                 f"flagship_cli: {s['iters']} cycles, CPU gives "
                 f"{expect_cycles}")
    print(f"flagship_cli: setup {s['setup_seconds']:.2f} s (compile "
          f"included), {s['iters']} cycles (CPU {expect_cycles}), rel "
          f"residual {s['resmag']:.3e}, solve {s['seconds']:.2f} s (CLI "
          f"history mode, per-cycle result files included), self-tests "
          f"worst {s['self_tests_worst']:.2e}", flush=True)
    return s


def phase_flagship_ir(out_dir=OUT_DIR, extra=()):
    rc, s = _cli(FLAGSHIP + ["--solver", "ir", "--dtype", "complex128",
                             "--res-threshold", "1e-12", *extra],
                 os.path.join(out_dir, "flagship_ir"))
    _require(rc == 0 and s["converged"] and s["resmag"] < 1e-12,
             f"flagship_ir: rc={rc}, res {s['resmag']:.3e} after "
             f"{s['iters']} cycles")
    print(f"flagship_ir: setup {s['setup_seconds']:.2f} s (complex128, "
          f"compile included), {s['iters']} complex64 inner cycles, rel "
          f"residual {s['resmag']:.3e}, solve {s['seconds']:.2f} s",
          flush=True)
    return s


def phase_level0(L=2048, n_sweeps=4, seed=4302529, reps=20,
                 copy_bytes=2**30):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpu_multigrid.config import MGConfig
    from tpu_multigrid.models import gauge, operators
    from tpu_multigrid.ops.smoothers import smooth
    from tpu_multigrid.ops.stencil import residual, site_inverse
    from tpu_multigrid.solver import cycles
    from tpu_multigrid import profiling

    cfg = MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=1,
                   num_iters=n_sweeps, smoother="rbgs", dtype="complex64")
    U = gauge.gauge_from_phases(
        gauge.heatbath_ensemble(L, cfg.beta, 10, seed), cfg.cdtype)
    _require(cycles.links_active(cfg, U, 0),
             "level0: links path not active for the flagship dtype")
    D = operators.assemble("wilson", U, cfg.m)
    Dinv = site_inverse(D[0])
    rng = np.random.default_rng(seed)
    phi, r = (jnp.asarray(rng.normal(size=(2, 2, L, L))
                          + 1j * rng.normal(size=(2, 2, L, L)), cfg.cdtype))

    # the level-0 functions the cycle dispatches, and their references
    res_links = lambda U, r, p: cycles._residual0(None, p, r, cfg, 0, U)
    res_dense = lambda D, r, p: residual(D, p, r)
    sm_links = lambda U, r, p: cycles._relax(None, p, r, cfg, 0, U)
    sm_dense = lambda D, Di, r, p: smooth(D, Di, p, r, n_sweeps, "rbgs")

    def rel(a, b):
        return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))

    err_res = rel(jax.jit(res_links)(U, r, phi),
                  jax.jit(res_dense)(D, r, phi))
    err_sm = rel(jax.jit(sm_links)(U, r, phi),
                 jax.jit(sm_dense)(D, Dinv, r, phi))
    print(f"level0_2048: L={L}, complex64 (f32 parts), contractions at "
          f"HIGHEST precision; max rel error links vs dense: residual "
          f"{err_res:.2e}, rbgs x{n_sweeps} {err_sm:.2e} (bound "
          f"{LEVEL0_TOL:g})", flush=True)
    _require(err_res <= LEVEL0_TOL and err_sm <= LEVEL0_TOL,
             f"level0: links path disagrees with the dense reference "
             f"({err_res:.2e}, {err_sm:.2e})")

    kind = profiling.device_kind()
    peak = profiling.device_peak(kind)
    copy = profiling.copy_bandwidth(copy_bytes)
    # iterate x -> 0.25 (r - D x) so the timed loop stays bounded; the
    # scale fuses into the same pass
    rows = {
        "links residual": (lambda U, r, p: 0.25 * res_links(U, r, p),
                           (U, r, phi), "links", 1),
        "dense residual": (lambda D, r, p: 0.25 * res_dense(D, r, p),
                           (D, r, phi), "dense", 1),
        f"links rbgs x{n_sweeps}": (sm_links, (U, r, phi), "links",
                                    n_sweeps),
        f"dense rbgs x{n_sweeps}": (sm_dense, (D, Dinv, r, phi), "dense",
                                    n_sweeps),
    }
    print(f"level0_2048: measured device copy {copy / 1e12:.3f} TB/s "
          f"({copy_bytes / 2**30:.0f} GiB f32 read+write); published peak "
          f"{peak.hbm_bytes_per_s / 1e12:.2f} TB/s ({peak.source})",
          flush=True)
    out = {"copy_bytes_per_s": copy, "rel_err_residual": err_res,
           "rel_err_smoother": err_sm}
    for name, (fn, args, path, passes) in rows.items():
        sec = profiling.time_op(fn, *args, reps=reps)
        nbytes = profiling.level0_bytes(path, 2, L, passes=passes)
        bps = nbytes / sec
        out[name] = {"sec": sec, "bytes_per_s": bps,
                     "share_of_copy": bps / copy,
                     "share_of_peak": bps / peak.hbm_bytes_per_s}
        print(f"level0_2048: {name:16s} {sec * 1e3:8.3f} ms  "
              f"{profiling.level0_words(path, 2)} words/site x {passes}  "
              f"{bps / 1e12:.3f} TB/s = {bps / copy:.3f} of copy, "
              f"{bps / peak.hbm_bytes_per_s:.3f} of peak", flush=True)
    return out


def phase_four(L=256, nlevels=3, null_iters=500, ens_L=128, ens_B=4,
               ens_cycles=12):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge, operators
    from tpu_multigrid.parallel import sharded
    from tpu_multigrid.parallel.setup import build_hierarchy_sharded
    from tpu_multigrid.solver.driver import solve
    from tpu_multigrid.solver.ensemble import (build_hierarchies_batched,
                                               solve_ensemble)

    devs = jax.devices()
    _require(len(devs) >= 4, f"four: {len(devs)} devices, need 4")
    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=nlevels,
                      ntl=True, n_copies=4, num_iters=4,
                      null_iters=null_iters, smoother="rbgs",
                      dtype="complex64", res_threshold=1e-5)
    U = gauge.gauge_from_phases(
        gauge.heatbath_ensemble(L, cfg.beta, 100, cfg.seed), cfg.cdtype)
    D = operators.assemble("wilson", U, cfg.m)
    b = mg.point_source(cfg)

    # domain-parallel: sharded setup and solve on a (2,2) mesh
    mesh = sharded.make_mesh((2, 2), devs[:4])
    t0 = time.perf_counter()
    hier = jax.block_until_ready(build_hierarchy_sharded(D, cfg, mesh))
    t_setup = time.perf_counter() - t0
    solver = sharded.make_sharded_solver(cfg, mesh, max_iters=100)(hier)
    hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
    t0 = time.perf_counter()
    phis, iters, res = jax.block_until_ready(
        solver(hier_s, mg.zero_fields(cfg), b))
    t_solve = time.perf_counter() - t0
    iters, res = int(iters), float(res)
    _require(res < cfg.res_threshold,
             f"four: sharded solve res {res:.3e} after {iters}")

    # the same config on card 0 alone, on the same hierarchy
    hier0 = jax.device_put(hier, devs[0])
    ref = solve(hier0, jax.device_put(b, devs[0]), cfg, max_iters=100)
    dphi = float(np.max(np.abs(np.asarray(phis[0]) - ref.phi)))
    print(f"four: (2,2) mesh, Wilson NTL {L}^2 to {cfg.res_threshold:g}: "
          f"{iters} cycles sharded vs {ref.iters} on card 0, max |dphi| "
          f"{dphi:.2e}; sharded setup {t_setup:.2f} s (compile included), "
          f"solve {t_solve:.3f} s (compile included)", flush=True)
    _require(ref.converged and ref.iters == iters,
             f"four: cycles differ: sharded {iters}, card 0 {ref.iters}")
    _require(dphi <= 5e-5, f"four: max |dphi| {dphi:.2e} > 5e-5")

    # data-parallel: an ensemble of configurations over a ('config',) mesh
    ecfg = mg.MGConfig(L=ens_L, stencil="wilson", m=-0.005, nlevels=2,
                       ntl=True, n_copies=4, num_iters=4, null_iters=100,
                       smoother="rbgs", dtype="complex64")
    Us = jnp.stack([gauge.gauge_from_phases(
        gauge.heatbath_ensemble(ens_L, ecfg.beta, 50, ecfg.seed + i),
        ecfg.cdtype) for i in range(ens_B)])
    hier_b = build_hierarchies_batched(Us, ecfg)
    bs = jnp.broadcast_to(mg.point_source(ecfg),
                          (ens_B, ecfg.n_dof[0], ens_L, ens_L))
    cmesh = Mesh(np.asarray(devs[:4]), ("config",))
    phi_s, res_s = solve_ensemble(hier_b, bs, ecfg, n_cycles=ens_cycles,
                                  mesh=cmesh)
    phi_r, res_r = solve_ensemble(hier_b, bs, ecfg, n_cycles=ens_cycles)
    drel = float(np.max(np.abs(phi_s - phi_r)) / np.max(np.abs(phi_r)))
    print(f"four: ensemble of {ens_B} configs {ens_L}^2 over ('config',) "
          f"mesh vs unsharded: max |dphi|/max|phi| {drel:.2e} (complex "
          f"fields), max rel res {float(np.max(res_s)):.2e} vs "
          f"{float(np.max(res_r)):.2e}", flush=True)
    _require(np.all(np.isfinite(res_s)) and drel <= 1e-5,
             f"four: ensemble fields differ: {drel:.2e}")
    return {"iters": iters, "ref_iters": ref.iters, "dphi": dphi,
            "ensemble_rel_diff": drel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh and ensemble paths")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}; device: {dev.platform} "
          f"{dev.device_kind!r} x{len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    print(f"nvidia-smi: {gpu_name_and_power_limit()}", flush=True)

    if args.four:
        phases = [("four", phase_four)]
        count = 4
    else:
        phases = [("flagship_cli", phase_flagship_cli),
                  ("flagship_ir", phase_flagship_ir),
                  ("level0_2048", phase_level0)]
        count = 1
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

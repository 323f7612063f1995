"""Conquer the reference's literal near-critical Wilson regime m = -0.07
(mgrid_ntl.cpp:51 example config).

Two measured facts drive the design (PARITY.md "Known deviations"):
the reference hardcodes beta=32.0, where our heat-bath ensembles give
m_c ~= -0.021 (L=32 dense spectrum), so at m=-0.07 the operator is
INDEFINITE and every stationary scheme diverges — while the reference's
own stored analysis data (3c_U1_mass_variation.ipynb) came from beta=6.0
and beta=3 ensembles, where m_c is far deeper.

Part A (definite regime, golden parity): scan m_c(beta) by dense
spectrum, pick beta=4.0 (m_c ~= -0.12, so m=-0.07 has a 0.05 gap),
generate one ensemble with our native heat-bath, feed the IDENTICAL
phases to the compiled reference final generation AND to our solver at
wilson NTL 128^2 m=-0.07 — record both convergence histories, plus the
unpreconditioned-MR baseline (the BASELINE.json >=5x cycle-reduction
metric, at the reference's own example mass).

Part B (indefinite regime, beta=32): demonstrate an actual solve of the
indefinite 128^2 operator to rel residual 1e-8 via CGNR — CG on the
always-Hermitian-positive-definite normal equations D^dag D
(solver/krylov.cgnr_solve; D^dag = g5 D g5 by Wilson g5-hermiticity) —
with complex64 iterations inside an f64-plane defect-correction loop
(krylov.cgnr_solve_ir). Also records that MG-preconditioned
FGMRES(20) and EO-MR stall on this operator (measured ~0.2 rel residual
plateau), which is WHY CGNR is the shipped indefinite path.

Usage:
  python scripts/wilson_m007.py --part A        (CPU, ~10 min)
  python scripts/wilson_m007.py --part B        (GPU if available)
Writes both parts to --out (default wilson_m007.json), merging with what
the file already holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

M = -0.07
BETA_DEF = 4.0
SEED = 4302529


def _load(path):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _save(d, path):
    with open(path, "w") as f:
        json.dump(d, f, indent=1, default=float)
    print(f"wrote {path}")


def beta_scan():
    """m_c(beta) from the dense spectrum at L=32 (additive: the Wilson
    diagonal is (2+m)I, so lambda(m) = lambda(0) + m and
    m_c = -min Re lambda(0))."""
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge, operators
    from tpu_multigrid.analysis import dense_operator

    rows = []
    for beta in (32.0, 8.0, 6.0, 4.0, 2.0):
        th = gauge.heatbath_ensemble(32, beta, 200, SEED)
        U = gauge.gauge_from_phases(th, np.complex128)
        A = np.asarray(dense_operator(
            operators.assemble("wilson", U, 0.0)))
        mc = -float(np.linalg.eigvals(A).real.min())
        rows.append({"beta": beta, "m_c": mc,
                     "definite_at_m007": bool(mc < M)})
        print(f"beta={beta}: m_c={mc:+.4f}")
    return rows


def part_a(L=128, fast=False):
    import jax
    jax.config.update("jax_enable_x64", True)
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge
    from scripts.reference_oracle import run_final_gen

    res = {"config": f"wilson NTL L={L}, m={M}, beta={BETA_DEF} "
                     "heat-bath (definite: see beta_scan), nlevels=3, "
                     "num_iters=10, n_copies=4, identical gauge phases "
                     "fed to both codes"}
    res["beta_scan"] = beta_scan()

    if fast:
        L = 64
    theta = gauge.heatbath_ensemble(L, BETA_DEF, 200, SEED)

    t0 = time.time()
    ref = run_final_gen(L, 10, 2, M, 3, 1, 4, stencil="wilson",
                        gauge_phases=theta, timeout=3600)
    res["reference"] = {
        "seconds": time.time() - t0,
        "converged": ref["converged"],
        "history_tail": ref["history"][-5:],
        "cycles_to_1e-8": next((i for i, r in ref["history"]
                                if r < 1e-8), None),
        "cycles_to_1e-13": (ref["converged"][0] if ref["converged"]
                            else None)}
    print("reference:", res["reference"])

    cfg = mg.MGConfig(L=L, stencil="wilson", m=M, nlevels=3, ntl=True,
                      n_copies=4, num_iters=10, null_iters=500,
                      smoother="rbgs", res_threshold=1e-13,
                      dtype="complex128")
    U = gauge.gauge_from_phases(theta, np.complex128)
    D = mg.models.operators.assemble("wilson", U, cfg.m)
    t0 = time.time()
    hier = mg.build_hierarchy(D, cfg, check=False)
    b = mg.point_source(cfg)
    out = mg.solve_with_history(hier, b, cfg, max_iters=200)
    hist = [float(h) for h in out.history]
    res["ours"] = {
        "seconds": time.time() - t0,
        "cycles_to_1e-8": next((i + 1 for i, r in enumerate(hist)
                                if r < 1e-8), None),
        "cycles_to_1e-13": out.iters if out.converged else None,
        "resmag": out.resmag, "converged": out.converged,
        "history_tail": hist[-5:]}
    print("ours:", res["ours"])

    # MG speedup vs unpreconditioned MR at the reference's example mass
    _, mr_iters, mr_rel = mg.mr_solve(D, b, tol=1e-8, max_iters=300000,
                                      chunk=2000)
    ours8 = res["ours"]["cycles_to_1e-8"] or out.iters
    res["mr_baseline"] = {"iters": mr_iters, "rel": mr_rel,
                          "cycle_reduction_vs_mg": mr_iters / max(ours8, 1)}
    print("mr:", res["mr_baseline"])
    return res


def part_b(L=128, fast=False):
    """Indefinite beta=32, m=-0.07: CGNR (+ f64-plane defect correction)
    to 1e-8, on whatever accelerator is available."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge
    from tpu_multigrid.solver.krylov import cgnr_solve_ir, cgnr_solve

    if fast:
        L = 64
    plat = jax.devices()[0].platform
    theta = gauge.heatbath_ensemble(L, 32.0, 100, SEED)
    with jax.default_device(jax.devices("cpu")[0]):
        U128 = gauge.gauge_from_phases(theta, np.complex128)
        D128 = np.asarray(
            mg.models.operators.assemble("wilson", U128, M))
        b = np.zeros((2, L, L), np.complex128)
        b[0, 2, 2] = 5.0

    from tpu_multigrid.utils.xfer import device_complex
    U64 = device_complex(np.asarray(U128), jnp.complex64)
    D64 = mg.models.operators.assemble("wilson", U64, M)

    t0 = time.time()
    out = cgnr_solve_ir(D64, D128, b, tol=1e-8, inner_tol=1e-5,
                        inner_max=6000, max_outer=8)
    sec = time.time() - t0
    row = {"platform": plat, "L": L, "beta": 32.0, "m": M,
           "indefinite": True,
           # min Re lambda(m) = min Re lambda(0) + m = +0.02104 + m
           # (the L=32 beta=32 spectrum floor from beta_scan)
           "min_re_lambda_at_m_L32": float(0.02104 + M),
           "solver": "cgnr + f64-plane defect correction",
           "rel_residual": out["rel"], "inner_iters": out["inner_iters"],
           "outer_steps": out["outer"], "seconds_total": sec,
           "converged": bool(out["rel"] < 1e-8)}
    print("cgnr_ir:", row)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=["A", "B", "AB"], default="AB")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default="wilson_m007.json")
    args = ap.parse_args()

    res = _load(args.out)
    res["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    if "A" in args.part:
        import jax
        jax.config.update("jax_platforms", "cpu")
        res["A_definite_golden"] = part_a(fast=args.fast)
        _save(res, args.out)
    if "B" in args.part:
        res["B_indefinite_cgnr"] = part_b(fast=args.fast)
        _save(res, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

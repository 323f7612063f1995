"""Reproduce the reference's scaling studies as committed artifacts.

The analysis notebooks' core scientific results (SURVEY §4.3) are trends of iterations-to-converge:

  A. vs mass, MG vs plain relaxation (0_submit cells 5-6 + notebook 1_:
     MG grows ~log(1/m) while pure GS grows ~1/m)
  B. vs nlevels at fixed mass, U(1) gauged laplace (notebook 3c_, which
     used the author's beta=6.0 heat-bath ensembles)
  C. vs NTL n_copies, wilson (notebook 2c_/8a_: more quadrant copies ->
     fewer cycles, all NTL variants beat same-depth telescoping or tie
     within noise)
  D. vs L at fixed mass (MG iteration count ~L-independent)
  E/F. the same (sub)grids through the COMPILED REFERENCE final
     generation at 64^2 on identical gauge configurations
     (scripts/reference_oracle.run_final_gen) -> side-by-side trend
     comparison ours-vs-reference.

Writes bench_rungs/scans.json (summary + per-point rows + trend checks)
and plots/scaling_*.png. CPU, complex128 (validation precision). Run:
    python scripts/run_scans.py [--fast]
(--fast shrinks grids for smoke-testing; the committed artifact is the
full run.)
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
OUT = os.path.join(ROOT, "bench_rungs", "scans.json")
PLOTS = os.path.join(ROOT, "plots")


def _our_point(cfg, U, max_iters=3000, chunk=None):
    import tpu_multigrid as mg
    D = mg.models.operators.assemble(cfg.stencil, U.astype(cfg.cdtype),
                                     cfg.m)
    t0 = time.time()
    hier = mg.build_hierarchy(D, cfg, check=False)
    b = mg.point_source(cfg)
    # while_loop solve: EXACT iterations-to-converge (the quantity every
    # scaling trend plots)
    out = mg.solve(hier, b, cfg, max_iters=max_iters)
    return {"L": cfg.L, "m": cfg.m, "stencil": cfg.stencil,
            "nlevels": cfg.nlevels, "ntl": cfg.ntl,
            "n_copies": cfg.n_copies, "iters": int(out.iters),
            "resmag": float(out.resmag),
            "converged": bool(out.converged),
            "seconds": time.time() - t0}


def near_critical_copies():
    """C2: NTL copies NEAR CRITICALITY (m=-0.018 on beta=32 where
    m_c ~= -0.021): notebook 2c_'s regime where the quadrant copies
    genuinely differentiate (at comfortable masses all variants tie —
    scan C and the compiled reference both show that). Appends a
    C2 section to scans.json."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge

    L, m = 64, -0.018
    theta = gauge.heatbath_ensemble(L, 32.0, 100, 4302529)
    U = gauge.gauge_from_phases(theta, np.complex128)
    rows = []
    base = mg.MGConfig(L=L, stencil="wilson", m=m, nlevels=3,
                       num_iters=10, null_iters=500, smoother="rbgs",
                       res_threshold=1e-11, dtype="complex128")
    for kind, cfg in [("telescoping", base)] + [
            (f"ntl_{nc}copy", base.replace(ntl=True, n_copies=nc))
            for nc in (1, 2, 3, 4)]:
        row = _our_point(cfg, U, max_iters=400)
        row["kind"] = kind
        rows.append(row)
        print(f"[C2] {kind}: {row['iters']} cycles "
              f"(conv={row['converged']})", flush=True)
    d = json.load(open(OUT))
    d["C2_ntl_copies_near_critical"] = {
        "config": f"wilson L={L}, m={m} (m_c ~= -0.021 at beta=32), "
                  "nlevels=3, num_iters=10, res 1e-11", "rows": rows}
    iters = {r["kind"]: r["iters"] for r in rows}
    d["trends"]["ntl_copies_near_critical"] = iters
    d["trends"]["ntl_near_critical_4_lt_tl"] = bool(
        iters.get("ntl_4copy", 10**9) <= iters.get("telescoping", 0))
    with open(OUT, "w") as f:
        json.dump(d, f, indent=1, default=float)
    print(f"updated {OUT}")
    return 0


def gen2_ntl_scan():
    """G: the gen-2 geometric NTL prototype — the program notebook 2c_'s
    stored data came from. Runs telescoping (t_flag=0) vs 4-copy NTL
    (t_flag=1) over a mass grid, BOTH through our geo2 mode and through
    the compiled gen-2 reference (reference_oracle.run_gen2). Measured:
    EXACT cycle-count match at every grid point; plain-average NTL costs
    a few extra cycles vs telescoping in both codes — the scheme's value
    is running the 4 coarse problems CONCURRENTLY (SURVEY 5.7), not a
    lower iteration count. Appends section G to scans.json."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tpu_multigrid.solver import geometric as geo
    from scripts.reference_oracle import run_gen2

    L, nl, ni, thr = 64, 4, 4, 1e-10
    rows = []
    for m in (0.05, 0.1, 0.3):
        for t_flag in (0, 1):
            cfg = geo.Geo2Config(L=L, m=m, nlevels=nl, num_iters=ni,
                                 res_threshold=thr, t_flag=bool(t_flag),
                                 smoother="gs_lex")
            b = geo.geo2_source(cfg)
            t0 = time.time()
            _, iters, res, _ = geo.geo2_solve(b, cfg, max_iters=500,
                                              chunk=1)
            ref_hist, ref_conv = run_gen2(L, m, nl, ni, t_flag=t_flag,
                                          threshold=thr, max_iters=500)
            row = {"L": L, "m": m, "t_flag": t_flag,
                   "our_iters": int(iters), "our_res": float(res),
                   "ref_iters": (ref_conv[0] + 1) if ref_conv else None,
                   "seconds": time.time() - t0}
            rows.append(row)
            print(f"[G] m={m} t_flag={t_flag}: ours {row['our_iters']} "
                  f"ref {row['ref_iters']}", flush=True)
    d = json.load(open(OUT))
    d["G_gen2_ntl_vs_telescoping"] = {
        "config": f"gen-2 geometric prototype, L={L}, nlevels={nl}, "
                  f"num_iters={ni}, gs_lex (trajectory-matching mode), "
                  "res threshold 1e-10, oracle = compiled "
                  "telescoping_2d_laplace_Mgrid.cpp", "rows": rows}
    by = {(r["m"], r["t_flag"]): r for r in rows}
    d["trends"]["gen2_exact_reference_match"] = {
        str(m): {"tl": by[(m, 0)]["our_iters"],
                 "ntl": by[(m, 1)]["our_iters"],
                 "ref_tl": by[(m, 0)]["ref_iters"],
                 "ref_ntl": by[(m, 1)]["ref_iters"]}
        for m in (0.05, 0.1, 0.3)}
    with open(OUT, "w") as f:
        json.dump(d, f, indent=1, default=float)
    print(f"updated {OUT}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--near-critical", action="store_true",
                    help="run only the C2 near-critical copies scan")
    ap.add_argument("--gen2", action="store_true",
                    help="run only the G gen-2 NTL-vs-telescoping scan")
    args = ap.parse_args()
    if args.near_critical:
        return near_critical_copies()
    if args.gen2:
        return gen2_ntl_scan()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge

    res = {"measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
           "platform": "cpu", "dtype": "complex128",
           "res_threshold": 1e-13, "trends": {}}

    def log(tag, row):
        print(f"[{tag}] " + json.dumps(row), flush=True)

    # ---- A. mass scan: MG (full depth) vs plain relaxation -------------
    masses = [0.001, 0.002, 0.004, 0.01, 0.05, 0.1, 0.4]
    gs_masses = [0.01, 0.05, 0.1, 0.4]
    L_A = 128
    if args.fast:
        masses, gs_masses, L_A = [0.01, 0.1], [0.1], 32
    A = []
    for m in masses:
        cfg = mg.MGConfig(L=L_A, stencil="laplace", m=m, nlevels=4,
                          num_iters=20, null_iters=500, smoother="rbgs",
                          res_threshold=1e-13, dtype="complex128")
        row = _our_point(cfg, gauge.identity_gauge(L_A, cfg.cdtype))
        row["kind"] = "mg"
        A.append(row)
        log("A", row)
    for m in gs_masses:
        # nlevels=0 degenerates to pure relaxation (reference f_MG_simple
        # nlevels=0 behavior) — the notebook-1_ "Pure GS" baseline
        cfg = mg.MGConfig(L=L_A, stencil="laplace", m=m, nlevels=0,
                          num_iters=20, null_iters=10, smoother="rbgs",
                          res_threshold=1e-13, dtype="complex128",
                          max_iters=4000)
        row = _our_point(cfg, gauge.identity_gauge(L_A, cfg.cdtype),
                         max_iters=4000, chunk=100)
        row["kind"] = "relax"
        A.append(row)
        log("A", row)
    res["A_mass_scan"] = {
        "config": f"laplace L={L_A}, nlevels=4 (mg) / 0 (relax), "
                  "num_iters=20, identity gauge",
        "rows": A}

    # ---- B. levels scan, U(1) beta=6 heat-bath (notebook 3c_) ----------
    L_B = 64
    lv_masses = [0.001, 0.01, 0.1]
    levels = [1, 2, 3, 4]
    if args.fast:
        lv_masses, levels, L_B = [0.01], [1, 2], 32
    theta6 = gauge.heatbath_ensemble(L_B, 6.0, 200, 4302529)
    U6 = gauge.gauge_from_phases(theta6, np.complex128)
    B = []
    for m in lv_masses:
        for nl in levels:
            cfg = mg.MGConfig(L=L_B, stencil="laplace", m=m, nlevels=nl,
                              num_iters=20, null_iters=500,
                              smoother="rbgs", res_threshold=1e-13,
                              dtype="complex128", beta=6.0)
            row = _our_point(cfg, U6)
            B.append(row)
            log("B", row)
    res["B_levels_scan"] = {
        "config": f"gauged laplace L={L_B}, heat-bath beta=6.0 (the "
                  "coupling family the reference's own 3c_ stored data "
                  "used), num_iters=20", "rows": B}

    # ---- C. NTL copies scan, wilson (notebooks 2c_/8a_) ----------------
    L_C = 64
    m_C = -0.005
    copies = [1, 2, 3, 4]
    if args.fast:
        copies = [1, 4]
    theta32 = gauge.heatbath_ensemble(L_C, 32.0, 100, 4302529)
    U32 = gauge.gauge_from_phases(theta32, np.complex128)
    C = []
    cfg_tl = mg.MGConfig(L=L_C, stencil="wilson", m=m_C, nlevels=3,
                         num_iters=10, null_iters=500, smoother="rbgs",
                         res_threshold=1e-13, dtype="complex128")
    row = _our_point(cfg_tl, U32)
    row["kind"] = "telescoping"
    C.append(row)
    log("C", row)
    for nc in copies:
        cfg = cfg_tl.replace(ntl=True, n_copies=nc)
        row = _our_point(cfg, U32)
        row["kind"] = f"ntl_{nc}copy"
        C.append(row)
        log("C", row)
    res["C_ntl_copies"] = {
        "config": f"wilson L={L_C}, m={m_C}, nlevels=3, num_iters=10, "
                  "beta=32 heat-bath", "rows": C}

    # ---- D. L-independence ---------------------------------------------
    Ls = [32, 64, 128, 256]
    if args.fast:
        Ls = [32, 64]
    D_rows = []
    for L in Ls:
        cfg = mg.MGConfig(L=L, stencil="laplace", m=0.01,
                          nlevels=min(4, int(np.log2(L)) - 2),
                          num_iters=20, null_iters=500, smoother="rbgs",
                          res_threshold=1e-13, dtype="complex128")
        row = _our_point(cfg, gauge.identity_gauge(L, cfg.cdtype))
        D_rows.append(row)
        log("D", row)
    res["D_L_scan"] = {"config": "laplace m=0.01, depth min(4, log2 L - 2)",
                       "rows": D_rows}

    # ---- E/F. the compiled reference on identical gauge configs --------
    if not args.skip_oracle:
        from scripts.reference_oracle import run_final_gen
        E = []
        or_masses = [0.004, 0.01, 0.1]
        or_levels = [1, 2, 3]
        if args.fast:
            or_masses, or_levels = [0.01], [2]
        L_E = 64
        theta_e = gauge.heatbath_ensemble(L_E, 32.0, 100, 4302529)
        U_e = gauge.gauge_from_phases(theta_e, np.complex128)
        for m in or_masses:
            for nl in or_levels:
                t0 = time.time()
                ref = run_final_gen(L_E, 10, 2, m, nl, 0, 1,
                                    stencil="laplace",
                                    gauge_phases=theta_e)
                ref_iters = (ref["converged"][0] if ref["converged"]
                             else None)
                cfg = mg.MGConfig(L=L_E, stencil="laplace", m=m,
                                  nlevels=nl, num_iters=10,
                                  null_iters=500, smoother="rbgs",
                                  res_threshold=1e-13,
                                  dtype="complex128")
                ours = _our_point(cfg, U_e)
                row = {"L": L_E, "m": m, "nlevels": nl,
                       "ref_iters": ref_iters,
                       "ref_seconds": time.time() - t0,
                       "our_iters": ours["iters"],
                       "our_converged": ours["converged"]}
                E.append(row)
                log("E", row)
        res["E_oracle_laplace"] = {
            "config": f"final-gen reference vs ours, laplace L={L_E}, "
                      "num_iters=10, identical beta=32 heat-bath gauge",
            "rows": E}

        F = []
        or_copies = [1, 4] if not args.fast else [4]
        for nc in or_copies:
            t0 = time.time()
            ref = run_final_gen(L_E, 10, 2, -0.005, 3, 1, nc,
                                stencil="wilson", gauge_phases=theta_e)
            ref_iters = ref["converged"][0] if ref["converged"] else None
            cfg = mg.MGConfig(L=L_E, stencil="wilson", m=-0.005,
                              nlevels=3, num_iters=10, null_iters=500,
                              smoother="rbgs", ntl=True, n_copies=nc,
                              res_threshold=1e-13, dtype="complex128")
            ours = _our_point(cfg, U_e)
            row = {"L": L_E, "n_copies": nc, "ref_iters": ref_iters,
                   "ref_seconds": time.time() - t0,
                   "our_iters": ours["iters"],
                   "our_converged": ours["converged"]}
            F.append(row)
            log("F", row)
        res["F_oracle_wilson_ntl"] = {
            "config": f"final-gen reference vs ours, wilson NTL L={L_E}, "
                      "m=-0.005, nlevels=3, identical gauge", "rows": F}

    # ---- trend checks ---------------------------------------------------
    tr = res["trends"]
    mg_rows = [r for r in A if r["kind"] == "mg" and r["converged"]]
    rx_rows = [r for r in A if r["kind"] == "relax"]
    if len(mg_rows) >= 2:
        lo, hi = mg_rows[0], mg_rows[-1]   # smallest vs largest mass
        tr["mg_mass_growth"] = {
            "iters_small_m": lo["iters"], "iters_large_m": hi["iters"],
            "ratio": lo["iters"] / max(hi["iters"], 1),
            "mass_ratio": hi["m"] / lo["m"]}
    if rx_rows and mg_rows:
        common = [(r, x) for r in mg_rows for x in rx_rows
                  if r["m"] == x["m"]]
        if common:
            r, x = common[0]
            tr["mg_vs_relax_at_same_m"] = {
                "m": r["m"], "mg_iters": r["iters"],
                "relax_iters": x["iters"],
                "relax_converged": x["converged"]}
    ntl_rows = {r["kind"]: r["iters"] for r in C}
    tr["ntl_copies_monotone"] = ntl_rows
    if "ntl_4copy" in ntl_rows and "ntl_1copy" in ntl_rows:
        tr["ntl_4_le_1"] = bool(ntl_rows["ntl_4copy"]
                                <= ntl_rows["ntl_1copy"])
    d_it = [r["iters"] for r in D_rows if r["converged"]]
    if d_it:
        tr["L_independence"] = {
            "iters_by_L": {str(r["L"]): r["iters"] for r in D_rows},
            "max_over_min": max(d_it) / min(d_it)}
    if res.get("E_oracle_laplace"):
        pairs = [(r["ref_iters"], r["our_iters"])
                 for r in res["E_oracle_laplace"]["rows"]
                 if r["ref_iters"]]
        if len(pairs) >= 2:
            a = np.array(pairs, float)
            tr["oracle_trend_corr"] = float(np.corrcoef(a[:, 0],
                                                        a[:, 1])[0, 1])
            tr["oracle_max_cycle_gap"] = int(
                np.max(np.abs(a[:, 0] - a[:, 1])))

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(res, f, indent=1, default=float)
    print(f"wrote {OUT}")

    # ---- plots ----------------------------------------------------------
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        os.makedirs(PLOTS, exist_ok=True)

        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        mgv = [(1.0 / r["m"], r["iters"]) for r in A if r["kind"] == "mg"]
        rxv = [(1.0 / r["m"], r["iters"]) for r in A
               if r["kind"] == "relax"]
        if mgv:
            x, y = zip(*sorted(mgv))
            ax.loglog(x, y, "o-", label="MG (4-level)")
        if rxv:
            x, y = zip(*sorted(rxv))
            ax.loglog(x, y, "s--", label="plain relaxation")
        ax.set_xlabel("1/m")
        ax.set_ylabel("cycles to 1e-13")
        ax.set_title(f"Mass scaling, laplace {L_A}$^2$ (notebook 1_)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(PLOTS, "scaling_mass.png"), dpi=120)

        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        for m in sorted({r["m"] for r in B}):
            pts = sorted((r["nlevels"], r["iters"]) for r in B
                         if r["m"] == m)
            if pts:
                x, y = zip(*pts)
                ax.semilogy(x, y, "o-", label=f"m={m}")
        ax.set_xlabel("nlevels")
        ax.set_ylabel("cycles to 1e-13")
        ax.set_title(f"Depth scaling, U(1) laplace beta=6, {L_B}$^2$ "
                     "(notebook 3c_)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(PLOTS, "scaling_levels.png"), dpi=120)

        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        kinds = [r["kind"] for r in C]
        iters = [r["iters"] for r in C]
        ax.bar(range(len(kinds)), iters)
        ax.set_xticks(range(len(kinds)), kinds, rotation=20)
        ax.set_ylabel("cycles to 1e-13")
        ax.set_title(f"NTL quadrant copies, wilson {L_C}$^2$ "
                     "(notebooks 2c_/8a_)")
        fig.tight_layout()
        fig.savefig(os.path.join(PLOTS, "scaling_ntl_copies.png"), dpi=120)
        print(f"wrote plots to {PLOTS}")
    except Exception as e:
        print(f"plotting skipped: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

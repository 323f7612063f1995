"""Scaling harness: sharded-stencil / sharded-cycle throughput vs mesh
size (BASELINE.json "nnz/s and sites/s at 1 chip / 1 host / >= 2 hosts").

Runs the same SPMD program (parallel.sharded halo-exchange cycle) over
1, 2, 4, ... device meshes and reports per-size wall time, sites/s, and
scaling efficiency vs the 1-device run.

On a host with several GPUs this measures multi-card scaling (one process
drives every card). Run with --platform cpu --devices 8 to exercise the
identical program on a virtual host mesh (correctness + harness shape,
NOT a hardware number — the printed device_kind records which it was).

Usage:
  python scripts/scaling_bench.py [--platform cpu] [--devices 8]
      [--L 256] [--reps 20] [--out /tmp/scaling.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual host-platform device count")
    ap.add_argument("--L", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", default="complex64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.devices:
        jax.config.update("jax_num_cpu_devices", args.devices)

    import numpy as np
    import tpu_multigrid as mg
    from tpu_multigrid.parallel import sharded

    L = args.L
    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                      num_iters=4, null_iters=30, dtype=args.dtype,
                      res_threshold=0.0,  # fixed-iteration timing runs
                      smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)
    U = mg.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = mg.models.operators.assemble(cfg.stencil, U, cfg.m)
    hier = mg.build_hierarchy(D, cfg, check=False)
    b = mg.point_source(cfg)

    ndev_all = len(jax.devices())
    sizes = []
    n = 1
    while n <= ndev_all:
        sizes.append(n)
        n *= 2

    rows = []
    for ndev in sizes:
        mx = int(np.floor(np.sqrt(ndev)))
        while ndev % mx:
            mx -= 1
        mesh = sharded.make_mesh((mx, ndev // mx),
                                 devices=jax.devices()[:ndev])
        solver = sharded.make_sharded_solver(cfg, mesh,
                                             max_iters=args.reps)(hier)
        hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
        phis0 = mg.zero_fields(cfg)
        out = solver(hier_s, phis0, b)         # compile + warmup
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(solver(hier_s, phis0, b))
            best = min(best, time.perf_counter() - t0)
        sec_per_cycle = best / args.reps
        rows.append({"devices": ndev, "mesh": [mx, ndev // mx],
                     "sec_per_cycle": sec_per_cycle,
                     "fine_sites_per_s": L * L / sec_per_cycle})

    base = rows[0]["sec_per_cycle"]
    for r in rows:
        r["speedup"] = base / r["sec_per_cycle"]
        r["efficiency"] = r["speedup"] / r["devices"]

    result = {"device_kind": jax.devices()[0].device_kind,
              "platform": jax.devices()[0].platform,
              "L": L, "dtype": args.dtype,
              "note": ("hardware number" if jax.devices()[0].platform
                       == "gpu" and ndev_all > 1 else
                       "single-device/virtual-mesh environment: program "
                       "validation only, not a hardware scaling number"),
              "rows": rows}
    print(json.dumps(result, indent=2, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, default=float)


if __name__ == "__main__":
    main()

"""Checkpoint / resume (SURVEY.md §5.4).

The reference checkpoints only the expensive setup artifact (near-null
vectors, via gen_null=0/1) and gauge fields. This module covers that
surface (see utils/io.py for the reference text formats) PLUS full
solver-state checkpointing the reference lacks: hierarchy + solution
vectors + iteration counter in one npz, so long solves can resume after
preemption.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..config import MGConfig
from .xfer import device_complex, host_complex
from ..solver.hierarchy import Hierarchy, LevelOps, NTLOps


def save_solver_state(path: str, cfg: MGConfig, hier: Hierarchy, phis,
                      it: int, resmag: float):
    arrs = {}
    for l, lev in enumerate(hier.levels):
        arrs[f"D_{l}"] = host_complex(lev.D)
        arrs[f"D0inv_{l}"] = host_complex(lev.D0inv)
        if lev.phi_null is not None:
            arrs[f"phi_null_{l}"] = host_complex(lev.phi_null)
    if hier.ntl is not None:
        arrs["ntl_phi_null"] = host_complex(hier.ntl.phi_null)
        arrs["ntl_D"] = host_complex(hier.ntl.D)
        arrs["ntl_D0inv"] = host_complex(hier.ntl.D0inv)
    if hier.gauge is not None:
        arrs["gauge_U"] = host_complex(hier.gauge)
    for l, p in enumerate(phis):
        arrs[f"phi_{l}"] = host_complex(p)
    meta = {"iter": it, "resmag": resmag, "nlevels": cfg.nlevels,
            "cfg": {f: getattr(cfg, f) for f in
                    ("L", "stencil", "m", "nlevels", "block_x", "block_y",
                     "num_iters", "smoother", "ntl", "n_copies", "dtype")}}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrs)


def load_solver_state(path: str, cfg: MGConfig) -> Tuple[Hierarchy, tuple,
                                                         int, float]:
    import jax.numpy as jnp
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["cfg"]["L"] != cfg.L or meta["cfg"]["stencil"] != cfg.stencil:
            raise ValueError("checkpoint config mismatch: "
                             f"{meta['cfg']} vs current")
        levels = []
        for l in range(cfg.nlevels + 1):
            pn = (device_complex(z[f"phi_null_{l}"], None)
                  if f"phi_null_{l}" in z.files else None)
            levels.append(LevelOps(D=device_complex(z[f"D_{l}"], None),
                                   D0inv=device_complex(z[f"D0inv_{l}"], None),
                                   phi_null=pn))
        ntl = None
        if "ntl_D" in z.files:
            ntl = NTLOps(phi_null=device_complex(z["ntl_phi_null"], None),
                         D=device_complex(z["ntl_D"], None),
                         D0inv=device_complex(z["ntl_D0inv"], None))
        phis = tuple(device_complex(z[f"phi_{l}"], None)
                     for l in range(cfg.nlevels + 1))
        gauge = (device_complex(z["gauge_U"], None)
                 if "gauge_U" in z.files else None)
    return (Hierarchy(levels=tuple(levels), ntl=ntl, gauge=gauge), phis,
            int(meta["iter"]), float(meta["resmag"]))


def _state_pytree(hier: Hierarchy, phis, it: int, resmag: float):
    return {"levels": [{"D": lev.D, "D0inv": lev.D0inv,
                        "phi_null": lev.phi_null}
                       for lev in hier.levels],
            "ntl": (None if hier.ntl is None else
                    {"phi_null": hier.ntl.phi_null, "D": hier.ntl.D,
                     "D0inv": hier.ntl.D0inv}),
            "gauge": hier.gauge,
            "phis": list(phis),
            "iter": it, "resmag": resmag}


def save_solver_state_orbax(path: str, hier: Hierarchy, phis, it: int,
                            resmag: float):
    """Checkpoint via orbax: arrays are written per-shard with
    their shardings, so a hierarchy living distributed on a device mesh
    (parallel/sharded.py) checkpoints without gathering to host — the
    multi-host analog of the reference's near-null text checkpoint
    (modules_main.h:39-79). `path` is a directory (created fresh)."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path),
               _state_pytree(hier, phis, it, resmag), force=True)
    ckptr.wait_until_finished()


def load_solver_state_orbax(path: str, hier_like: Hierarchy, phis_like
                            ) -> Tuple[Hierarchy, tuple, int, float]:
    """Restore an orbax solver-state checkpoint. `hier_like`/`phis_like`
    provide the target structure (shapes, dtypes AND shardings — restored
    arrays land directly on the same mesh layout)."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    target = _state_pytree(hier_like, phis_like, 0, 0.0)
    st = ckptr.restore(os.path.abspath(path), target)
    levels = tuple(LevelOps(D=d["D"], D0inv=d["D0inv"],
                            phi_null=d["phi_null"]) for d in st["levels"])
    ntl = (None if st["ntl"] is None else
           NTLOps(phi_null=st["ntl"]["phi_null"], D=st["ntl"]["D"],
                  D0inv=st["ntl"]["D0inv"]))
    return (Hierarchy(levels=levels, ntl=ntl, gauge=st.get("gauge")),
            tuple(st["phis"]), int(st["iter"]), float(st["resmag"]))


def solve_resumable(hier, b, cfg: MGConfig, path: str,
                    checkpoint_every: int = 50,
                    max_iters: Optional[int] = None):
    """Chunked solve that checkpoints every `checkpoint_every` cycles and
    resumes from `path` if it exists."""
    from ..solver.driver import SolveResult, _cycle_and_res
    from ..solver.hierarchy import zero_fields
    from ..utils.compile import aot_call
    import jax
    import jax.numpy as jnp

    max_iters = max_iters or cfg.max_iters
    it, resmag = 0, float("inf")
    phis = zero_fields(cfg)
    if os.path.exists(path):
        hier, phis, it, resmag = load_solver_state(path, cfg)

    def run_chunk(hier, phis, b):
        def body(i, phis):
            phis, _, _ = _cycle_and_res(hier, phis, b, cfg)
            return phis
        phis = jax.lax.fori_loop(0, checkpoint_every, body, phis)
        from ..ops.stencil import residual_norm_ratio
        return phis, residual_norm_ratio(hier.levels[0].D, phis[0], b)

    while it < max_iters:
        phis, res = aot_call(run_chunk, hier, phis, b,
                             key=("resume", cfg, checkpoint_every))
        it += checkpoint_every
        resmag = float(res)
        save_solver_state(path, cfg, hier, phis, it, resmag)
        if resmag < cfg.res_threshold or resmag > cfg.div_threshold \
                or not np.isfinite(resmag):
            break
    return SolveResult(phi=host_complex(phis[0]), iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)

"""Performance observability: per-kernel timing, the device-memory byte
model of the hot kernels, roofline accounting, and jax.profiler trace
capture (SURVEY.md §5.1 — the reference has no tracing at all).

Every kernel here is bandwidth-bound, so bytes are the roofline. A
roofline share is only meaningful when the working set streams from
device memory: sets that fit in (a few times) the L2 cache can be served
from it across loop iterations, so `roofline_share` reports None for
working sets below `STREAM_L2_MULTIPLE` times the device's L2, and such
measurements report bytes/s only.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, asdict
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from .config import MGConfig


@dataclass(frozen=True)
class DevicePeak:
    hbm_bytes_per_s: float
    l2_bytes: int
    source: str


# Published peaks, keyed by the exact `device_kind` JAX reports. A device
# that is not listed has no peak: lookups raise rather than default.
DEVICE_PEAKS: Dict[str, DevicePeak] = {
    "NVIDIA H100 80GB HBM3": DevicePeak(
        hbm_bytes_per_s=3.35e12, l2_bytes=50 * 2**20,
        source="NVIDIA H100 SXM data sheet (80 GB HBM3, 3.35 TB/s, "
               "50 MB L2)"),
}

# A working set of at least this many L2 capacities streams from device
# memory on every pass; smaller sets get bytes/s only.
STREAM_L2_MULTIPLE = 4


def device_kind() -> str:
    return jax.devices()[0].device_kind


def device_peak(kind: Optional[str] = None) -> DevicePeak:
    """Published peaks of `kind` (default: the first JAX device).
    Raises ValueError for a device kind with no entry."""
    kind = device_kind() if kind is None else kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(DEVICE_PEAKS)}") from None


def roofline_share(nbytes: int, sec: float,
                   kind: Optional[str] = None) -> Optional[float]:
    """Achieved bytes/s over the published peak, or None when the working
    set is below STREAM_L2_MULTIPLE x L2 (not a streaming measurement)."""
    peak = device_peak(kind)
    if nbytes < STREAM_L2_MULTIPLE * peak.l2_bytes:
        return None
    return nbytes / sec / peak.hbm_bytes_per_s


# ---- byte model --------------------------------------------------------
#
# Least device-memory traffic of one pass over the lattice, in complex
# words per site, for the level-0 kernels of an n-dof field. A pass reads
# the operator, the field and the right-hand side and writes one field:
#   dense: the 5 n x n stencil blocks (a smoother sweep reads the 4 hop
#          blocks plus the n x n diagonal inverse: the same 5 n^2);
#   links: the two U(1) link planes (the diagonal is the scalar 2+m or
#          -(4+m), so nothing else is read).
# A plain apply D v reads no right-hand side: one word of n fewer.
# Wilson (n=2): dense 26, links 8 per residual or sweep; 24 and 6 per
# apply.

def level0_words(path: str, n: int, rhs: bool = True) -> int:
    op = {"dense": 5 * n * n, "links": 2}[path]
    return op + (3 if rhs else 2) * n


def level0_bytes(path: str, n: int, L: int, dtype_bytes: int = 8,
                 passes: int = 1, rhs: bool = True) -> int:
    """Least bytes of `passes` level-0 passes on an L x L lattice."""
    return passes * level0_words(path, n, rhs) * L * L * dtype_bytes


def stencil_bytes(n: int, L: int, dtype_bytes: int = 8) -> int:
    """Least traffic of one dense apply_D: read D + read v + write out."""
    return level0_bytes("dense", n, L, dtype_bytes, rhs=False)


# ---- timing --------------------------------------------------------------

def time_op(fn: Callable, *args, reps: int = 100, passes: int = 3) -> float:
    """Seconds per call of `fn(*args[:-1], x)` iterated `reps` times on its
    last argument inside one jitted fori_loop (one dispatch per pass, so
    dispatch cost is amortised). Compiles and runs once untimed, then
    returns the best of `passes` timed runs, each ended by
    block_until_ready, divided by reps."""
    def many(*a):
        return jax.lax.fori_loop(0, reps, lambda i, x: fn(*a[:-1], x), a[-1])

    run = jax.jit(many)
    run(*args).block_until_ready()
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        run(*args).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best / reps


def copy_bandwidth(nbytes: int = 2**30, reps: int = 20) -> float:
    """Measured device-to-device streaming rate, bytes/s: an elementwise
    pass over an `nbytes` f32 array (reads nbytes, writes nbytes)."""
    x = jnp.zeros((nbytes // 4,), jnp.float32)
    sec = time_op(lambda v: v + 1.0, x, reps=reps)
    return 2 * nbytes / sec


@dataclass
class RooflineRow:
    name: str
    sec: float
    bytes: int
    bytes_per_s: float = 0.0
    roofline_share: Optional[float] = None


def roofline_table(cfg: MGConfig, D, v, r=None) -> Dict:
    """Time the dense level kernels against the device's published peak.
    Raises ValueError on a device with no published peak."""
    from .ops.stencil import apply_D, site_inverse
    from .ops.smoothers import jacobi_sweep, rbgs_sweep

    kind = device_kind()
    peak = device_peak(kind)
    n, L = v.shape[0], v.shape[-1]
    dbytes = jnp.dtype(cfg.cdtype).itemsize
    Dinv = site_inverse(D[0])
    if r is None:
        r = v * 0
    sweep = level0_bytes("dense", n, L, dbytes)
    rows = [
        RooflineRow("apply_D", time_op(lambda D, x: apply_D(D, x), D, v),
                    stencil_bytes(n, L, dbytes)),
        RooflineRow("jacobi_sweep",
                    time_op(lambda D, x: jacobi_sweep(D, Dinv, x, r), D, v),
                    sweep),
        RooflineRow("rbgs_sweep",
                    time_op(lambda D, x: rbgs_sweep(D, Dinv, x, r), D, v),
                    sweep),
    ]
    for row in rows:
        row.bytes_per_s = row.bytes / row.sec
        row.roofline_share = roofline_share(row.bytes, row.sec, kind)
    return {"device": kind, "peak_bytes_per_s": peak.hbm_bytes_per_s,
            "peak_source": peak.source,
            "rows": [asdict(x) for x in rows]}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()

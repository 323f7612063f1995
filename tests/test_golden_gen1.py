"""Golden-run parity: compile and run the reference's generation-1
geometric-MG program (plain g++, no deps) and compare residual
trajectories against our geometric mode with the exact lexicographic
smoother. This is the BASELINE.md golden-data protocol, executed live."""
import shutil
import subprocess

import numpy as np
import pytest

from tpu_multigrid.solver import geometric as geo

import sys
sys.path.insert(0, "/root/repo/scripts")
from reference_oracle import run_gen1, REF  # noqa: E402

needs_ref = pytest.mark.skipif(
    shutil.which("g++") is None or not __import__("os").path.exists(REF),
    reason="needs g++ and the mounted reference")


def my_history(L, m, nlevels, num_iters, threshold, max_iters):
    cfg = geo.GeoConfig(L=L, m=m, nlevels=nlevels, num_iters=num_iters,
                        res_threshold=threshold, smoother="gs_lex")
    b = geo.geo_source(cfg)
    phi, iters, res, hist = geo.geo_solve(b, cfg, max_iters=max_iters,
                                          chunk=1)
    return hist, iters, res


@needs_ref
@pytest.mark.parametrize("L,m,nl,ni,thr", [(32, 0.5, 3, 4, 1e-12),
                                           (64, 0.05, 4, 10, 1e-10)])
def test_gen1_trajectory_match(L, m, nl, ni, thr):
    # thr sits above the f64 rounding plateau of sum|r| for each size so
    # the stopping iteration is well-defined for both implementations.
    ref_hist, ref_conv = run_gen1(L, m, nl, ni, threshold=thr,
                                  max_iters=200)
    mine, iters, res = my_history(L, m, nl, ni, thr, 200)
    assert ref_conv is not None, "reference did not converge"
    ref_vals = np.array([v for (_, v) in ref_hist])
    k = min(len(ref_vals), len(mine))
    assert k >= 3
    # identical algorithm + exact lexicographic smoother -> trajectories
    # agree to the reference's %g print precision (6 significant digits),
    # excluding near-threshold entries where absolute rounding ~1e-16
    # dominates relatively
    sel = ref_vals[:k] > 1e-8
    np.testing.assert_allclose(np.asarray(mine[:k])[sel], ref_vals[:k][sel],
                               rtol=5e-6)
    # converged iteration count matches within 1 (summation-order rounding
    # at the threshold)
    ref_iters = ref_conv[0] + 1  # reference iter is 0-based
    assert abs(iters - ref_iters) <= 1, (iters, ref_iters)


@needs_ref
def test_gen1_trajectory_match_L256():
    """Reference-scale-closer golden (companion of the 2048² headline): 256²,
    6 levels, the reference's own mass scaled to keep m·L at its headline
    value (0.002·2048). Trajectory match to the reference's 6-digit print
    precision while residuals are far from the fp plateau."""
    L, m, nl, ni, thr = 256, 0.016, 6, 20, 1e-10
    ref_hist, ref_conv = run_gen1(L, m, nl, ni, threshold=thr,
                                  max_iters=60, timeout=900)
    mine, iters, res = my_history(L, m, nl, ni, thr, 60)
    ref_vals = np.array([v for (_, v) in ref_hist])
    k = min(len(ref_vals), len(mine))
    assert k >= 3
    # at 256^2 the per-entry fp summation noise is ~1e-13 absolute, so
    # 6-digit relative agreement only holds while entries are > ~1e-7
    sel = ref_vals[:k] > 1e-7
    assert sel.sum() >= 3
    np.testing.assert_allclose(np.asarray(mine[:k])[sel],
                               ref_vals[:k][sel], rtol=5e-6)

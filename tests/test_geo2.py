"""Generation-2 parity: the geometric NON-TELESCOPING prototype
(code/2_scalar_2d_nontelescoping/telescoping_2d_laplace_Mgrid.cpp and its
_singleinterpolation variant) — quadrant-offset geometric transfers, the
4-way coarse projection with plain-average recombination, and golden-run
trajectory matches against the compiled reference programs."""
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.solver import geometric as geo

sys.path.insert(0, "/root/repo/scripts")
from reference_oracle import run_gen2, REF_GEN2_DIR  # noqa: E402

needs_ref = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists(REF_GEN2_DIR),
    reason="needs g++ and the mounted reference")


# --- quadrant transfer operators vs the reference's site formula ----------

def _ref_quad_restrict(rt, quad):
    """f_projection's index math (telescoping...cpp:98-107), verbatim."""
    L = rt.shape[0]
    Lc = L // 2
    out = np.zeros((Lc, Lc))
    sx = {1: 1, 2: -1, 3: -1, 4: 1}[quad]
    sy = {1: 1, 2: 1, 3: -1, 4: -1}[quad]
    for x in range(Lc):
        for y in range(Lc):
            xa, ya = 2 * x, 2 * y
            xb, yb = (2 * x + sx) % L, (2 * y + sy) % L
            out[x, y] = 0.25 * (rt[xa, ya] + rt[xa, yb]
                                + rt[xb, ya] + rt[xb, yb])
    return out


def _ref_quad_prolong(c, quad):
    """f_interpolate's index math (telescoping...cpp:126-139), verbatim."""
    Lc = c.shape[0]
    L = 2 * Lc
    out = np.zeros((L, L))
    sx = {1: 1, 2: -1, 3: -1, 4: 1}[quad]
    sy = {1: 1, 2: 1, 3: -1, 4: -1}[quad]
    for x in range(Lc):
        for y in range(Lc):
            xa, ya = 2 * x, 2 * y
            xb, yb = (2 * x + sx) % L, (2 * y + sy) % L
            for (i, j) in [(xa, ya), (xa, yb), (xb, ya), (xb, yb)]:
                out[i, j] += c[x, y]
    return out


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_quad_transfers_match_reference_formula(quad):
    rng = np.random.default_rng(3 + quad)
    rt = rng.normal(size=(8, 8))
    c = rng.normal(size=(4, 4))
    np.testing.assert_allclose(
        np.asarray(geo.quad_restrict(jnp.asarray(rt), quad)),
        _ref_quad_restrict(rt, quad), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(geo.quad_prolong(jnp.asarray(c), quad)),
        _ref_quad_prolong(c, quad), rtol=1e-14, atol=1e-14)


def test_quad_prolong_adjoint_of_restrict():
    # <R v, w>_c == <v, P w>_f / 4 (restrict averages, prolong injects)
    rng = np.random.default_rng(9)
    v = jnp.asarray(rng.normal(size=(16, 16)))
    w = jnp.asarray(rng.normal(size=(8, 8)))
    for quad in (1, 2, 3, 4):
        lhs = jnp.vdot(geo.quad_restrict(v, quad), w)
        rhs = jnp.vdot(v, geo.quad_prolong(w, quad)) / 4.0
        assert abs(float(lhs - rhs)) < 1e-12


# --- convergence (parallel rbgs smoother) ----------------------------------

def test_geo2_ntl_converges_rbgs():
    cfg = geo.Geo2Config(L=32, m=0.5, nlevels=3, num_iters=4, t_flag=True,
                         smoother="rbgs", res_threshold=1e-10)
    b = geo.geo2_source(cfg)
    phi, iters, res, hist = geo.geo2_solve(b, cfg, max_iters=100, chunk=2)
    assert res < 1e-10
    # the NTL correction must not break the fixed point: residual of the
    # returned phi recomputed from scratch agrees
    r = geo.geo_residual(jnp.asarray(phi), b, 0, cfg)
    assert float(jnp.abs(r).sum()) == pytest.approx(res, rel=1e-6)


# --- golden trajectories vs the compiled reference -------------------------

def _mine(L, m, nl, ni, thr, t_flag, combine="divide", n_single=1,
          max_iters=200):
    cfg = geo.Geo2Config(L=L, m=m, nlevels=nl, num_iters=ni,
                         res_threshold=thr, t_flag=t_flag, combine=combine,
                         n_single=n_single, smoother="gs_lex")
    b = geo.geo2_source(cfg)
    phi, iters, res, hist = geo.geo2_solve(b, cfg, max_iters=max_iters,
                                           chunk=1)
    return hist, iters, res


def _compare(ref_hist, ref_conv, mine, iters):
    assert ref_conv is not None, "reference did not converge"
    # gen 2 prints at the TOP of the loop: ref_vals[k] = sum|r| after k
    # cycles, while mine[j] = after j+1 cycles -> compare shifted by one
    ref_vals = np.array([v for (_, v) in ref_hist])
    k = min(len(ref_vals) - 1, len(mine))
    assert k >= 3
    sel = ref_vals[1:k + 1] > 1e-10   # above the f64 plateau
    np.testing.assert_allclose(np.asarray(mine[:k])[sel],
                               ref_vals[1:k + 1][sel], rtol=5e-6)
    # "Loop breaks at iteration k" = k+1 cycles completed
    assert abs(iters - (ref_conv[0] + 1)) <= 1, (iters, ref_conv)


@needs_ref
@pytest.mark.parametrize("t_flag", [0, 1])
def test_gen2_trajectory_match(t_flag):
    L, m, nl, ni, thr = 32, 0.5, 3, 4, 1e-12
    ref_hist, ref_conv = run_gen2(L, m, nl, ni, t_flag=t_flag,
                                  threshold=thr, max_iters=200)
    mine, iters, res = _mine(L, m, nl, ni, thr, t_flag=bool(t_flag))
    _compare(ref_hist, ref_conv, mine, iters)


@needs_ref
def test_gen2_trajectory_match_slow_mass():
    # lighter mass + more levels: more cycles, stresses the NTL averaging
    L, m, nl, ni, thr = 64, 0.05, 4, 4, 1e-10
    ref_hist, ref_conv = run_gen2(L, m, nl, ni, t_flag=1, threshold=thr,
                                  max_iters=300)
    mine, iters, res = _mine(L, m, nl, ni, thr, t_flag=True, max_iters=300)
    _compare(ref_hist, ref_conv, mine, iters)


@needs_ref
@pytest.mark.parametrize("nn", [1, 2])
def test_gen2_single_interpolation_variant(nn):
    L, m, nl, ni, thr = 32, 0.5, 3, 4, 1e-12
    ref_hist, ref_conv = run_gen2(L, m, nl, ni, t_flag=1, threshold=thr,
                                  max_iters=200, variant="single",
                                  n_single=nn)
    mine, iters, res = _mine(L, m, nl, ni, thr, t_flag=True,
                             combine="single", n_single=nn)
    _compare(ref_hist, ref_conv, mine, iters)

"""Golden-run parity vs the reference's FINAL generation (adaptive
laplace/wilson + non-telescoping), compiled against our minimal
Eigen-compatible shim and run on gauge ensembles we generate and feed to
BOTH codes (the BASELINE.md golden protocol for the adaptive gens).

RNG streams differ (std::mt19937 vs jax PRNG) so near-null vectors — and
hence exact residual values — differ; what must agree is the algorithmic
convergence behavior: cycles-to-threshold and the per-cycle contraction
rate on identical operators.
"""
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, "/root/repo/scripts")
from reference_oracle import run_final_gen, REF_FINAL_DIR  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from tpu_multigrid.config import MGConfig  # noqa: E402
from tpu_multigrid.models import gauge, operators  # noqa: E402
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source  # noqa: E402
from tpu_multigrid.solver.driver import solve_with_history  # noqa: E402

needs_ref = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.isdir(REF_FINAL_DIR),
    reason="needs g++ and the mounted reference")


def run_mine(stencil, L, m, nlevels, num_iters, ntl, n_copies, phases):
    cfg = MGConfig(L=L, stencil=stencil, m=m, nlevels=nlevels,
                   num_iters=num_iters, ntl=ntl, n_copies=n_copies,
                   null_iters=500, smoother="gs_lex",
                   res_threshold=1e-13)
    U = gauge.gauge_from_phases(phases, cfg.cdtype)
    D = operators.assemble(stencil, U, cfg.m)
    hier = build_hierarchy(D, cfg, check=False)
    return solve_with_history(hier, point_source(cfg), cfg, max_iters=100)


def contraction(hist, lo=1e-12, hi=1e-2):
    """Geometric-mean per-cycle residual reduction in the clean regime."""
    h = np.asarray(hist, dtype=float)
    sel = (h > lo) & (h < hi)
    h = h[sel]
    if len(h) < 2:
        return None
    return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1)))


@needs_ref
@pytest.mark.parametrize("stencil,ntl,m", [
    ("wilson", 1, 0.1),
    ("wilson", 0, 0.1),
    ("laplace", 1, 0.02),
])
def test_final_gen_convergence_parity(stencil, ntl, m):
    L, nlevels, num_iters, n_copies = 16, 2, 10, 4
    phases = gauge.heatbath_ensemble(L, 32.0, 100, 4302529)

    ref = run_final_gen(L, num_iters, 2, m, nlevels, ntl, n_copies,
                        stencil=stencil, gauge_phases=phases)
    assert ref["converged"] is not None, ref["stdout_tail"]
    ref_iters = ref["converged"][0]

    out = run_mine(stencil, L, m, nlevels, num_iters, bool(ntl), n_copies,
                   phases)
    assert out.converged

    # Same algorithm on the same operator: cycle counts within +-2 cycles
    # (near-null RNG streams differ).
    assert abs(out.iters - ref_iters) <= 2, (out.iters, ref_iters)

    # Contraction rates agree within 2.5x (rate ~ 1e-2/cycle, so this is
    # a tight band on the log slope).
    c_ref = contraction([v for _, v in ref["history"]])
    c_me = contraction(out.history)
    assert c_ref is not None and c_me is not None
    ratio = c_me / c_ref
    assert 0.4 < ratio < 2.5, (c_me, c_ref)


@needs_ref
def test_final_gen_ntl_weights_structure():
    """NTL min-res weights from both codes: complex, 4 per iteration, and
    the dominant-weight pattern (weights sum to ~1 on a converged
    correction) is shared."""
    L, m = 16, 0.1
    phases = gauge.heatbath_ensemble(L, 32.0, 100, 4302529)
    ref = run_final_gen(L, 10, 2, m, 2, 1, 4, stencil="wilson",
                        gauge_phases=phases)
    out = run_mine("wilson", L, m, 2, 10, True, 4, phases)
    assert ref["weights"] and out.ntl_weights is not None
    # both produce 4 finite, non-degenerate complex weights per iteration
    for w in (np.asarray(ref["weights"][0]), out.ntl_weights[0]):
        assert w.shape == (4,)
        assert np.isfinite(w).all()
        assert np.std(np.abs(w)) > 1e-6   # min-res, not a plain average


@needs_ref
def test_reference_results_files_parse_with_our_loaders(tmp_path):
    """The reference's actual results_*.txt output parses with our
    analysis loaders (the de-facto notebook API, SURVEY §5.5) — and its
    near-null checkpoint file round-trips through our reader."""
    from tpu_multigrid import analysis
    from tpu_multigrid.utils import io as mio

    L, m = 16, 0.2
    phases = gauge.heatbath_ensemble(L, 32.0, 60, 11)
    ref = run_final_gen(L, 8, 2, m, 2, 1, 4, stencil="wilson",
                        gauge_phases=phases, workdir=str(tmp_path))
    run_dir = os.path.join(str(tmp_path), "run")
    iters, fields = analysis.load_results_phi(
        os.path.join(run_dir, "results_phi.txt"), L, 2)
    assert len(iters) >= 2 and fields.shape[1:] == (2, L, L)
    # residual file of level 0
    it2, res0 = analysis.load_results_phi(
        os.path.join(run_dir, "results_res_lvl-0.txt"), L, 2)
    assert res0.shape[1:] == (2, L, L)
    # the logged level-0 residual magnitudes decrease
    mags = np.linalg.norm(res0.reshape(len(it2), -1), axis=1)
    assert mags[-1] < mags[1]
    # near-null checkpoint written by the reference reads with our loader
    cfg = MGConfig(L=L, stencil="wilson", m=m, nlevels=2)
    nn_path = os.path.join(run_dir, mio.near_null_filename(cfg))
    assert os.path.exists(nn_path)
    pns = mio.load_near_null_text(nn_path, cfg)
    assert pns[0].shape == (4, 2, L, L)
    # the reference's rows are block-orthonormal under OUR block geometry
    from tpu_multigrid.ops.transfer import check_ortho, block_norms
    pn0 = jnp.asarray(pns[0])
    assert float(check_ortho(pn0, 1, 2, 2)) < 1e-10
    np.testing.assert_allclose(
        np.asarray(block_norms(pn0[0], 1, 2, 2)), 1.0, atol=1e-10)


@needs_ref
def test_solve_with_reference_near_null_vectors(tmp_path):
    """Full interoperability: build OUR hierarchy from the REFERENCE's
    near-null checkpoint (gen_null=0 path) and converge — both codes'
    transfer operators are exchangeable artifacts."""
    from tpu_multigrid.utils import io as mio
    from tpu_multigrid.solver.driver import solve_with_history

    L, m = 16, 0.2
    phases = gauge.heatbath_ensemble(L, 32.0, 60, 11)
    ref = run_final_gen(L, 8, 2, m, 2, 1, 4, stencil="wilson",
                        gauge_phases=phases, workdir=str(tmp_path))
    assert ref["converged"] is not None
    run_dir = os.path.join(str(tmp_path), "run")

    cfg = MGConfig(L=L, stencil="wilson", m=m, nlevels=2, ntl=True,
                   num_iters=8, gen_null=False, smoother="gs_lex",
                   res_threshold=1e-13)
    pns = mio.load_near_null_text(
        os.path.join(run_dir, mio.near_null_filename(cfg)), cfg)
    pn_init = tuple(jnp.asarray(p, cfg.cdtype) for p in pns)
    U = gauge.gauge_from_phases(phases, cfg.cdtype)
    D = operators.assemble("wilson", U, cfg.m)
    hier = build_hierarchy(D, cfg, phi_null_init=pn_init)
    out = solve_with_history(hier, point_source(cfg), cfg, max_iters=50)
    assert out.converged
    # identical transfer operators + same smoother => cycle counts agree
    # within 1 of the reference's own run
    assert abs(out.iters - ref["converged"][0]) <= 1, \
        (out.iters, ref["converged"])


@needs_ref
@pytest.mark.parametrize("stencil,m", [("wilson", 0.1), ("laplace", 0.02)])
def test_final_gen_convergence_parity_L32_3lvl(stencil, m):
    """Reference-scale-closer golden: 32^2, 3 levels (coarsest 4^2), NTL —
    parity beyond the 16^2/2-level proxy."""
    L, nlevels, num_iters, n_copies = 32, 3, 10, 4
    phases = gauge.heatbath_ensemble(L, 32.0, 100, 4302529)

    ref = run_final_gen(L, num_iters, 2, m, nlevels, 1, n_copies,
                        stencil=stencil, gauge_phases=phases)
    assert ref["converged"] is not None, ref["stdout_tail"]
    ref_iters = ref["converged"][0]

    out = run_mine(stencil, L, m, nlevels, num_iters, True, n_copies,
                   phases)
    assert out.converged
    assert abs(out.iters - ref_iters) <= 2, (out.iters, ref_iters)

    c_ref = contraction([v for _, v in ref["history"]])
    c_me = contraction(out.history)
    assert c_ref is not None and c_me is not None
    ratio = c_me / c_ref
    assert 0.4 < ratio < 2.5, (c_me, c_ref)

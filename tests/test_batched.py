"""Batched multi-RHS solve (DP analog)."""
import jax
import jax.numpy as jnp
import numpy as np

from tpu_multigrid.config import MGConfig
from tpu_multigrid.models import gauge, operators
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source
from tpu_multigrid.solver.driver import solve_batched, solve


def test_solve_batched_matches_individual():
    cfg = MGConfig(L=16, stencil="laplace", m=0.2, nlevels=2, num_iters=6,
                   null_iters=60, res_threshold=1e-10)
    D = operators.assemble("laplace", gauge.identity_gauge(16, cfg.cdtype),
                           cfg.m)
    hier = build_hierarchy(D, cfg, check=False)
    rng = np.random.default_rng(0)
    bs = jnp.asarray(rng.normal(size=(3, 1, 16, 16)) + 0j)
    phi, res = solve_batched(hier, bs, cfg, n_cycles=12)
    assert (res < 1e-8).all(), res
    # first RHS individually
    out = solve(hier, bs[0], cfg, max_iters=12)
    np.testing.assert_allclose(phi[0], out.phi, atol=1e-8)


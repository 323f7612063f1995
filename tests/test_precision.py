"""Every contraction on the cycle path asks for HIGHEST precision.

On the GPU an f32 or complex64 contraction handed to cuBLAS may run in
TF32 (about three decimal digits) unless its precision is pinned. These
tests read the precision of every dot_general in each cycle-path
function's jaxpr, sub-jaxprs (jit, loops, shard_map) included.
"""
import jax
import jax.extend as je
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import tpu_multigrid as mg
from tpu_multigrid.ops import stencil, transfer
from tpu_multigrid.parallel import halo, sharded
from tpu_multigrid.solver import cycles

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dot_precisions(jaxpr, out=None):
    out = [] if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for q in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(q, je.core.ClosedJaxpr):
                    _dot_precisions(q.jaxpr, out)
                elif isinstance(q, je.core.Jaxpr):
                    _dot_precisions(q, out)
    return out


def _flagship(L=16):
    cfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                      num_iters=2, null_iters=8, dtype="complex64")
    rng = np.random.default_rng(0)
    U = mg.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    D = mg.models.operators.assemble("wilson", U, cfg.m)
    hier = mg.build_hierarchy(D, cfg, check=False, U=U)
    return cfg, hier, mg.point_source(cfg)


def _field(shape, seed=1):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                       jnp.complex64)


def _on_mesh(fn, *args):
    """fn inside shard_map over a (2,2) mesh, lattice axes sharded."""
    mesh = sharded.make_mesh((2, 2), jax.devices()[:4])
    specs = tuple(P(*([None] * (a.ndim - 2)), "x", "y") for a in args)
    return jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=specs[-1],
                         check_vma=False)


def _case(name):
    cfg, hier, b = _flagship()
    D, v = hier.levels[0].D, _field((2, 16, 16))
    pn = hier.levels[0].phi_null
    vc = _field((4, 8, 8))
    if name == "apply_D":
        return stencil.apply_D, (D, v)
    if name == "restrict":
        return lambda p, x: transfer.restrict(p, x, 2, 2, 2), (pn, v)
    if name == "prolong":
        return lambda p, x: transfer.prolong(p, x, 3, 2, 2), (pn, vc)
    if name == "min_res_weights":
        xs = jnp.stack([v, 2 * v, v * 1j, v + 1])
        return (lambda D, r, xs: cycles.min_res_weights(D, r, xs, cfg),
                (D, v, xs))
    if name == "ntl_cycle":
        return (lambda h, p, b: cycles.ntl_cycle(h, p, b, cfg),
                (hier, mg.zero_fields(cfg), b))
    if name == "halo_smooth":
        f = lambda D, Di, r, x: halo.smooth_sharded(D, Di, x, r, 2, "rbgs")
        return _on_mesh(f, D, hier.levels[0].D0inv, v, v), (
            D, hier.levels[0].D0inv, v, v)
    if name == "sharded_transfer":
        f = lambda p, x: sharded._prolong_sharded(
            p, sharded._restrict_sharded(p, x, 2, 2, 2), 2, 2, 2)
        return _on_mesh(f, pn, v), (pn, v)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "apply_D", "restrict", "prolong", "min_res_weights", "ntl_cycle",
    "halo_smooth", "sharded_transfer"])
def test_cycle_contractions_pin_highest(name):
    fn, args = _case(name)
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, f"{name}: no contraction found"
    assert all(p == HIGHEST for p in precs), (name, precs)

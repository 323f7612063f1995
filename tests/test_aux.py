"""Auxiliary subsystems: solver-state checkpoint/resume, profiling
accounting, multihost helpers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.config import MGConfig
from tpu_multigrid.models import gauge, operators
from tpu_multigrid.solver.hierarchy import build_hierarchy, point_source
from tpu_multigrid.utils import checkpoint as ckpt
from tpu_multigrid import profiling


def _small_problem():
    cfg = MGConfig(L=16, stencil="laplace", m=0.1, nlevels=2, num_iters=6,
                   null_iters=60, res_threshold=1e-10)
    D = operators.assemble("laplace", gauge.identity_gauge(16, cfg.cdtype),
                           cfg.m)
    return cfg, build_hierarchy(D, cfg, check=False), point_source(cfg)


def test_checkpoint_resume_roundtrip(tmp_path):
    cfg, hier, b = _small_problem()
    path = str(tmp_path / "state.npz")
    out1 = ckpt.solve_resumable(hier, b, cfg, path, checkpoint_every=3,
                                max_iters=3)
    assert os.path.exists(path) and not out1.converged
    # resume continues from the checkpoint and converges
    out2 = ckpt.solve_resumable(hier, b, cfg, path, checkpoint_every=3,
                                max_iters=60)
    assert out2.converged
    assert out2.iters > out1.iters
    # fresh-solve result matches the resumed result
    from tpu_multigrid.solver.driver import solve
    ref = solve(hier, b, cfg, max_iters=60)
    np.testing.assert_allclose(out2.phi, ref.phi, atol=1e-8)


def test_checkpoint_rejects_mismatched_config(tmp_path):
    cfg, hier, b = _small_problem()
    path = str(tmp_path / "state.npz")
    ckpt.solve_resumable(hier, b, cfg, path, checkpoint_every=2, max_iters=2)
    import pytest
    with pytest.raises(ValueError):
        ckpt.load_solver_state(path, cfg.replace(L=32))


def test_roofline_table_runs(monkeypatch):
    """The table needs the device's published peak: on a device with no
    entry (the CPU here) it raises; with an entry it times each kernel
    and reports bytes/s, and a roofline share only for streaming sets."""
    import pytest
    cfg, hier, b = _small_problem()
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.roofline_table(cfg, hier.levels[0].D, b)
    monkeypatch.setitem(profiling.DEVICE_PEAKS, "cpu", profiling.DevicePeak(
        hbm_bytes_per_s=1e11, l2_bytes=1, source="test"))
    tab = profiling.roofline_table(cfg, hier.levels[0].D, b)
    names = [r["name"] for r in tab["rows"]]
    assert "apply_D" in names and "rbgs_sweep" in names
    for r in tab["rows"]:
        assert r["sec"] > 0 and r["bytes_per_s"] > 0
        assert r["roofline_share"] > 0


def test_multihost_helpers():
    from tpu_multigrid.parallel import multihost
    assert multihost.mesh_shape_for(8) == (2, 4)
    assert multihost.mesh_shape_for(16) == (4, 4)
    assert multihost.mesh_shape_for(7) == (1, 7)
    m = multihost.global_mesh()
    assert set(m.axis_names) == {"x", "y"}
    assert multihost.is_coordinator()


def test_orbax_checkpoint_sharded_roundtrip(tmp_path):
    """Orbax checkpoint of a SHARDED hierarchy round-trips with shardings
    intact (the multi-device checkpoint path; arrays written per-shard)."""
    from tpu_multigrid.parallel import sharded
    from tpu_multigrid.solver.hierarchy import zero_fields

    cfg, hier, b = _small_problem()
    mesh = sharded.make_mesh((2, 2))
    hier_s = sharded.shard_hierarchy(hier, cfg, mesh)
    phis = zero_fields(cfg)
    path = str(tmp_path / "orbax_state")
    ckpt.save_solver_state_orbax(path, hier_s, phis, 7, 0.125)
    hier2, phis2, it, resmag = ckpt.load_solver_state_orbax(
        path, hier_s, phis)
    assert (it, resmag) == (7, 0.125)
    np.testing.assert_allclose(np.asarray(hier2.levels[0].D),
                               np.asarray(hier_s.levels[0].D))
    # restored arrays carry the original sharding (no host gather)
    assert (hier2.levels[0].D.sharding ==
            hier_s.levels[0].D.sharding)
    np.testing.assert_allclose(np.asarray(phis2[0]), np.asarray(phis[0]))


def test_persistent_compile_cache(tmp_path):
    """enable_persistent_cache wires jax's on-disk XLA cache: it stays off
    on CPU unless forced, and a forced compile writes entries into the
    directory JAX_COMPILATION_CACHE_DIR names."""
    import jax
    import jax.numpy as jnp
    from tpu_multigrid.utils import compile as uc

    path = str(tmp_path / "xla_cache")
    # CPU platforms are gated off (machine-feature-specialized AOT
    # entries risk SIGILL across hosts); force=True for the wiring test.
    # MUST disable afterwards: leaving the cache on makes every later
    # large CPU compile in this pytest process attempt an executable
    # serialization, which segfaults flakily (see
    # utils.compile.disable_persistent_cache docstring).
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        assert uc.enable_persistent_cache() == ""
        jax.config.update("jax_compilation_cache_dir", path)
        assert uc.enable_persistent_cache(force=True) == path
        jax.jit(lambda a: (a @ a).sum()).lower(
            jnp.ones((64, 64))).compile()
        assert os.listdir(path), "no cache entries written"
    finally:
        uc.disable_persistent_cache()


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the cache stays there; without
    it, the cache goes to the fixed .jax_cache inside the checkout, the
    same path on every call and in every process."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import jax; from tpu_multigrid.utils import compile as uc\n"
            "try:\n"
            "    print(uc.enable_persistent_cache(force=True))\n"
            "    print(uc.enable_persistent_cache(force=True))\n"
            "finally:\n"
            "    uc.disable_persistent_cache()\n")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "given")
    want = (str(tmp_path / "given") if env_dir
            else os.path.join(root, ".jax_cache"))
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == [want, want]


def test_checkpoint_preserves_gauge_links(tmp_path):
    """Hierarchies carrying gauge links (the level-0 links fast path)
    keep them through the npz checkpoint roundtrip."""
    import jax.numpy as jnp
    import numpy as np
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge, operators
    from tpu_multigrid.utils.checkpoint import (save_solver_state,
                                                load_solver_state)

    cfg = mg.MGConfig(L=16, stencil="wilson", m=-0.005, nlevels=2,
                      num_iters=4, null_iters=16, dtype="complex64")
    U = gauge.gauge_from_phases(
        0.2 * np.random.default_rng(1).normal(size=(2, 16, 16)),
        cfg.cdtype)
    D = operators.assemble("wilson", U, cfg.m)
    hier = mg.build_hierarchy(D, cfg, check=False, U=U)
    phis = mg.zero_fields(cfg)
    p = str(tmp_path / "st.npz")
    save_solver_state(p, cfg, hier, phis, 3, 0.5)
    h2, _, it, res = load_solver_state(p, cfg)
    assert h2.gauge is not None
    np.testing.assert_allclose(np.asarray(jnp.abs(h2.gauge)),
                               np.asarray(jnp.abs(hier.gauge)), atol=1e-6)

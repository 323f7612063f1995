"""Compilation utilities.

`aot_call`: lower + compile a jitted function once per argument signature
and call the compiled executable; the solver drivers route their large
programs through it so repeated solves reuse one executable.

`enable_persistent_cache`: JAX's on-disk compilation cache for GPU runs.
"""
from __future__ import annotations

import os

import jax

_cache: dict = {}

# Cache directory used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
# path inside the checkout (listed in .gitignore). The directory is part of
# the cache key, so it never depends on a temporary name, a pid or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_persistent_enabled = False


def enable_persistent_cache(force: bool = False) -> str:
    """Enable JAX's on-disk compilation cache on the GPU (on other
    platforms only with force=True). Returns the cache directory, or ''
    when left off.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    function keeps it; otherwise the cache goes to DEFAULT_CACHE_DIR.

    CPU is left off: XLA:CPU cache entries are specialised to the exact
    host CPU features, so entries written on another machine risk SIGILL,
    and CPU compiles are fast anyway."""
    global _persistent_enabled
    if not force and jax.devices()[0].platform != "gpu":
        return ""
    path = jax.config.jax_compilation_cache_dir
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    if not _persistent_enabled:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_enable_compilation_cache", True)
        # cache every program: MG solves contain many medium programs
        # whose individual compile times sit below the 1 s default
        # threshold
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _persistent_enabled = True
    return path


def disable_persistent_cache() -> None:
    """Turn the on-disk cache back off and drop jax's initialized cache
    object. Needed by tests that force-enable the cache on CPU: leaving
    it enabled makes every LATER large XLA:CPU compile in the process
    attempt an executable serialization into the cache dir — measured to
    segfault the interpreter flakily (crash inside
    compilation_cache.put_executable_and_time during an unrelated
    solve)."""
    global _persistent_enabled
    from jax._src import compilation_cache as _cc
    jax.config.update("jax_enable_compilation_cache", False)
    jax.config.update("jax_compilation_cache_dir", None)
    _cc.reset_cache()
    _persistent_enabled = False


def _args_signature(args):
    """Shapes + dtypes + shardings of every array leaf, plus the platform.

    The sharding term is essential: a compiled executable is specialized to
    its input shardings, so the same fn/shapes compiled for single-device
    arrays must NOT be reused for mesh-sharded arrays (that exact collision
    once served a single-device `build_ntl` executable to
    `build_hierarchy_sharded`'s sharded args)."""
    leaves = []
    for a in jax.tree_util.tree_leaves(args):
        if hasattr(a, "shape"):
            sh = getattr(a, "sharding", None)
            leaves.append((a.shape, str(getattr(a, "dtype", "?")),
                           repr(sh) if sh is not None else None))
    return (jax.tree_util.tree_structure(args), tuple(leaves),
            jax.devices()[0].platform)


def aot_call(fn, *args, static_argnames=(), key=None):
    """Compile fn for these args and call the compiled executable.

    Cache key = (key or id(fn)) + full argument signature (shapes, dtypes,
    shardings, platform). A caller-supplied `key` is only a *prefix* — it
    can merge fewer things than the default (e.g. ignore id(fn) identity
    across closures) but can never merge args that need distinct
    executables."""
    full_key = (key if key is not None else id(fn), _args_signature(args))
    compiled = _cache.get(full_key)
    if compiled is None:
        jitted = jax.jit(fn, static_argnames=static_argnames)
        compiled = jitted.lower(*args).compile()
        _cache[full_key] = compiled
    return compiled(*args)


def clear_cache():
    _cache.clear()

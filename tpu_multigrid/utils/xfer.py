"""Host<->device helpers for complex arrays.

Thin aliases for the plain operations; callers across the package still
use these names.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def device_full(shape, value, dtype) -> jnp.ndarray:
    """`jnp.full(shape, value, dtype)`."""
    return jnp.full(tuple(shape), value, dtype)


def device_zeros_like(x) -> jnp.ndarray:
    """`jnp.zeros_like(x)`."""
    return jnp.zeros_like(x)


def device_complex(arr, dtype=jnp.complex64) -> jnp.ndarray:
    """Host array -> device array of `dtype` (None keeps the input's
    own dtype)."""
    a = np.asarray(arr)
    return jnp.asarray(a, a.dtype if dtype is None else dtype)


def host_complex(x) -> np.ndarray:
    """Device array -> numpy."""
    return np.asarray(x)

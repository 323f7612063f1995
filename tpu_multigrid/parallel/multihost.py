"""Multi-process scaffolding (SURVEY.md §5.8): jax.distributed bring-up
and process-spanning mesh construction.

`initialize()` wires the JAX distributed runtime from an explicit
coordinator address, process count and process id, and `global_mesh`
builds the ('x','y') lattice mesh over ALL devices so the shard_map solver
in parallel/sharded.py runs unchanged across processes.

Without a coordinator address initialize is a no-op and the mesh covers
the local devices (one process driving all cards of a host).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .halo import AXIS_X, AXIS_Y


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when a coordinator address is given
    (JAX finds no cluster by itself here). Returns True if distributed
    mode is active; initialization errors propagate."""
    import jax
    if coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Near-square 2D factorization of the device count: the lattice is
    square, so a near-square split keeps each shard's halo perimeter
    smallest. Every card reaches every other at the same rate, so the
    split follows the lattice alone."""
    mx = int(np.floor(np.sqrt(n_devices)))
    while n_devices % mx:
        mx -= 1
    return mx, n_devices // mx


def global_mesh(shape: Optional[Tuple[int, int]] = None):
    """('x','y') mesh over all devices of all processes."""
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if shape is None:
        shape = mesh_shape_for(len(devs))
    n = shape[0] * shape[1]
    return Mesh(np.asarray(devs[:n]).reshape(shape), (AXIS_X, AXIS_Y))


def is_coordinator() -> bool:
    import jax
    return jax.process_index() == 0

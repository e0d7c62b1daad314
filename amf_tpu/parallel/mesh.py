"""Device-mesh helpers.

The reference's entire parallel substrate is a lock-guarded
``multiprocessing.Pool`` + pickle IPC (SURVEY.md §2.4/§5.8). The
replacement is the JAX runtime itself: a 1-D ``Mesh`` over which the
embarrassingly-parallel candidate axis of lookahead scoring is sharded with
``shard_map``; the final argmax is the only collective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CANDIDATE_AXIS = "candidates"


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = CANDIDATE_AXIS
) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def candidate_sharding(mesh: Mesh, axis_name: str = CANDIDATE_AXIS) -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: jax.Array, multiple: int, axis: int = 0, fill=0):
    """Pad an axis to a device-count multiple so it can be evenly sharded."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    import jax.numpy as jnp

    return jnp.pad(x, pad_widths, constant_values=fill), size

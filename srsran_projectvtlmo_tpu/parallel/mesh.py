"""Device meshes and sharding helpers.

The reference parallelizes with per-thread executors and CPU affinity
(reference: apps/services/worker_manager.h:59-82); the analog here is a
jax.sharding.Mesh whose axes carry cells/slots (data parallel) and codeblock
batches (the LDPC batch axis).  XLA inserts the collectives; programs stay
single-source.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def cell_mesh(nof_devices: int | None = None, axis: str = "cell") -> Mesh:
    devs = jax.devices()
    n = nof_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=(axis,))


def shard_leading(x, mesh: Mesh, axis: str = "cell"):
    """Place an array with its leading dim sharded over `axis`, rest replicated."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))

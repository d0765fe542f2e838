"""Device-mesh helpers for the sharded index.

The reference is single-node/single-process by construction (SURVEY §2.4:
no NCCL/MPI/network code anywhere); the scaling axis here is
*database-size sharding*: hash/range-partitioned device-resident shards over
a ``jax.sharding.Mesh``, per-shard local beam search, and cross-shard top-k
merge over collectives (SURVEY §5 "distributed communication backend").
The cards of one host are joined all to all, so the mesh is one flat axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]), (axis,))


def shard_leading(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard dim 0 (the shard-stack dim) across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

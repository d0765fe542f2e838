"""Multi-host scaling: jax.distributed entry + global-mesh index.

The reference is single-node by construction (SURVEY §2.4/§5: no
NCCL/MPI/network code anywhere); this is the new surface SURVEY §7.2 M5
mandates. Design:

  - **Entry path**: every process calls :func:`initialize_distributed`
    (``jax.distributed.initialize``) before first JAX use; afterwards
    ``jax.devices()`` is the *global* device list and SPMD programs span
    every host.
  - **Placement**: the shard axis of :class:`~.sharded.StackedGraphArrays`
    is laid out over a mesh of ALL global devices in process-major order
    (``jax.devices()`` ordering), so the shards owned by one host's cards
    are mesh-adjacent.
  - **Intra-/inter-host split**: the only cross-device communication in
    :func:`~.sharded.sharded_search` is the final ``all_gather`` of
    ``[B, k]`` (rowid, dist) tuples over the data axis. With process-major
    placement the intra-host phase stays between a host's own cards, and
    only the tiny per-host top-k union crosses the network. Corpus loading
    and graph build are host-local (each process builds only the subgraphs
    of its own cards — the network never sees vectors or graph blocks);
    checkpointing is likewise per-process, shard-parallel.
  - **Dataset partitioning**: global round-robin over the shard axis
    (:func:`~.sharded.partition_rows`); a process materializes only the
    partitions assigned to its local devices, then
    ``jax.make_array_from_single_device_arrays`` assembles the global
    stacked arrays without any host ever holding the full index.

On CPU the same code runs multi-process via Gloo collectives
(``jax_cpu_collectives_implementation``), which is how
tests/test_multihost.py proves the cross-process search compiles and merges
without accelerators (SURVEY §4: "multi-host tests runnable on CPU via
jax.distributed").
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphParams
from .mesh import DATA_AXIS
from .sharded import (
    StackedGraphArrays,
    _join_rowids64,
    _split_rowids64,
    partition_rows,
    sharded_search,
)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    cpu_collectives: str | None = None,
) -> None:
    """The multi-host entry path: call once per process before first JAX use.

    Where the cluster environment tells JAX the topology, the three None
    defaults auto-discover it (the standard ``jax.distributed.initialize()``
    contract); otherwise pass all three. On CPU also pass
    ``cpu_collectives="gloo"`` (tests) — Gloo backs the cross-process
    collectives that NCCL provides between GPUs.
    """
    if cpu_collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)
    if coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_global_mesh(axis: str = DATA_AXIS) -> Mesh:
    """One mesh axis over every device of every process, process-major (so
    intra-host neighbors are mesh-adjacent and the all_gather's intra-host
    phase stays between a host's own cards)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


class MultiHostShardedIndex:
    """Sharded index spanning hosts: each process builds/owns only the
    subgraphs living on its local chips; search is one SPMD program over the
    global mesh.

    The single-host :class:`~.sharded.ShardedIndex` stacks all shards on one
    host then device_puts; at pod scale no host can hold the full index, so
    this class assembles the global arrays from per-process local shards
    (``jax.make_array_from_single_device_arrays``).
    """

    def __init__(self, config: LmDiskannConfig, mesh: Mesh | None = None):
        config.validate()
        self.config = config
        self.params = GraphParams.from_config(config)
        self.mesh = mesh if mesh is not None else make_global_mesh()
        devices = list(self.mesh.devices.flat)
        self.n_shards = len(devices)
        pidx = jax.process_index()
        # shard s lives on mesh device s; this process owns the shards of
        # its addressable devices.
        self.local_shards = [
            s for s, d in enumerate(devices) if d.process_index == pidx
        ]
        self._devices = devices
        self.coordinators: dict[int, Coordinator] = {}
        self._stacked: StackedGraphArrays | None = None
        self._capacity = 0

    def build(self, rowids, vectors: np.ndarray, max_batch: int = 1024) -> None:
        """Build the local shards from the *global* corpus partition map.

        Every process calls this with the same (rowids, vectors) view — or,
        at real scale, with a loader that yields only the rows whose
        round-robin partition lands on a local shard; rows routed to remote
        shards are skipped here and built by their owner process.
        """
        vectors = np.ascontiguousarray(np.atleast_2d(vectors), np.float32)
        rowids = np.asarray(rowids, np.int64)
        parts = partition_rows(len(rowids), self.n_shards)
        cap = 1 << max(int(np.ceil(np.log2(max(len(p) for p in parts) or 1))), 6)
        self._capacity = cap
        for s in self.local_shards:
            part = parts[s]
            coord = Coordinator(self.config, initial_capacity=cap)
            if len(part):
                coord.bulk_build(
                    rowids[part].tolist(), vectors[part], max_batch=max_batch
                )
            coord._ensure_capacity(cap)
            self.coordinators[s] = coord
        self._stacked = None

    # ----------------------------------------------------------------- #

    def _assemble(self, per_shard_local: dict[int, np.ndarray], dtype=None):
        """Global [S, ...] array from this process's local shard pieces."""
        sample = next(iter(per_shard_local.values()))
        global_shape = (self.n_shards,) + sample.shape
        sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        bufs = [
            jax.device_put(
                np.asarray(per_shard_local[s], dtype)[None], self._devices[s]
            )
            for s in self.local_shards
        ]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, bufs
        )

    def stacked(self) -> StackedGraphArrays:
        if self._stacked is not None:
            return self._stacked
        coords = self.coordinators
        proto = coords[self.local_shards[0]].arrays
        assembled = {
            name: self._assemble(
                {s: np.asarray(coords[s].arrays[i]) for s in self.local_shards}
            )
            for i, name in enumerate(proto._fields)
        }
        hi_lo = {
            s: _split_rowids64(coords[s]._slot_rowids[: self._capacity])
            for s in self.local_shards
        }
        stacked = StackedGraphArrays(
            arrays=type(proto)(**assembled),
            rowids_hi=self._assemble({s: h for s, (h, _) in hi_lo.items()}),
            rowids_lo=self._assemble({s: l for s, (_, l) in hi_lo.items()}),
            entry=self._assemble(
                {
                    s: np.asarray([coords[s].entry_slot], np.int32)[0]
                    for s in self.local_shards
                }
            ),
            counts=self._assemble(
                {
                    s: np.asarray([coords[s].count], np.int32)[0]
                    for s in self.local_shards
                }
            ),
        )
        self._stacked = stacked
        return stacked

    def search(self, queries: np.ndarray, k: int, l_search: int | None = None):
        """SPMD search over the global mesh; the merged result is replicated,
        so every process returns the identical (rowids, distances)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        L = max(l_search if l_search is not None else self.config.l_search, k)
        hi, lo, dists = sharded_search(
            self.stacked(),
            jax.numpy.asarray(queries),
            mesh=self.mesh,
            params=self.params,
            l_search=L,
            k=k,
        )
        ids = _join_rowids64(np.asarray(hi), np.asarray(lo))
        return ids, np.asarray(dists)

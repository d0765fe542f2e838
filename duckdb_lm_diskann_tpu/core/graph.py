"""The device-resident graph container: LM-DiskANN node blocks as
struct-of-arrays.

JAX re-design of the reference's node-block storage
(core/GraphNode.{hpp,cpp} offset accessors + the rowid->block-pointer map in
core/GraphManager.hpp:123). The reference keeps one self-contained 4KB block
per node:

    u16 count | node vector | R x row_t ids | R x pos planes | R x neg planes

so that beam search needs exactly one block read per visited node. On the
accelerator the same self-containment property is expressed as one *row*
across a handful of device-resident arrays — "one block read" becomes "one
gather row", and the cached (compressed) neighbor vectors still make
frontier scoring possible without a second gather (the property
libsql/vectordiskann.c:1370-1396 depends on):

    vectors    f32[C, D]      node vectors (full precision)
    neighbors  i32[C, R]      neighbor *slots*, -1 = empty (the reference
                              uses row_t MAX as the empty sentinel,
                              GraphManager.cpp:155)
    edge_*                    cached neighbor codes, layout per EdgeType
    valid      bool[C]        live-node mask (tombstones; V2 design's
                              tombstoned_nodes table, Consolidated
                              Proposal:171-186)

Device arrays index nodes by dense int32 *slot*; the 64-bit user row ids and
the rowid<->slot map live on the host (:class:`SlotAllocator` — the analog of
``rowid_to_node_ptr_map_``). Slots are assigned in insertion order, which
makes the pinned (distance, slot) tie-break reproduce the reference's
insertion-ordered row ids for append workloads.

All updates are functional: methods return new ``GraphArrays`` pytrees, so
every mutation composes with jit/grad/shard_map — the reference's
StorageLock/IndexLock concurrency (hnsw_index.cpp:191,301-303) is replaced by
pure batched transforms (SURVEY §2.4).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..common.types import EdgeType, MetricType, VectorType
from ..ops.quantize import words_per_i4
from .config import LmDiskannConfig, words_per_plane_u32


class GraphArrays(NamedTuple):
    """Device-side graph state (a pytree: jit/shard_map-friendly).

    Edge-code fields not used by the active EdgeType are zero-size
    placeholders so the pytree structure is static across configs.
    """

    vectors: jnp.ndarray  # f32[C, D] — or i8[C, D] for INT8 node vectors
    neighbors: jnp.ndarray  # i32[C, R]
    valid: jnp.ndarray  # bool[C]
    edge_pos: jnp.ndarray  # u32[C, R, W]  (TERNARY; sign plane for FLOAT1BIT) else [C, 0, 0]
    edge_neg: jnp.ndarray  # u32[C, R, W]  (TERNARY) else [C, 0, 0]
    edge_i8: jnp.ndarray  # i8[C, R, D]   (INT8)    else [C, 0, 0]
    edge_i4: jnp.ndarray  # u32[C, R, ceil(D/8)] planar words (INT4; see ops/quantize.words_per_i4) else [C, 0, 0]
    edge_scale: jnp.ndarray  # f32[C, R]   (INT8/INT4) else [C, 0]
    edge_f32: jnp.ndarray  # f32[C, R, D] (FLOAT32) / f16[C, R, D] (FLOAT16) else [C, 0, 0]
    # Rows mutated since the last checkpoint (the V2 design's dirty-block
    # ring, Consolidated Proposal:96-107): store_vectors/write_neighbor_rows
    # set it, deletes set it, checkpoint persists only dirty blocks and
    # clears it. Cost: one bool per slot.
    dirty_rows: jnp.ndarray  # bool[C]

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]


def _default_bitonic(env: str | None = None) -> bool:
    """Resolve the hop-merge implementation. One source of truth:
    ops/topk.default_bitonic (explicit LMD_BITONIC wins; else chosen per
    backend)."""
    from ..ops.topk import default_bitonic

    if env is not None:
        return env != "0"
    return default_bitonic()


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Static (hashable) parameters closed over by jitted kernels."""

    dims: int
    r: int
    metric: MetricType
    edge_type: EdgeType
    alpha: float
    l_insert: int
    l_search: int
    max_visits: int
    # Insert-path visit budget (see LmDiskannConfig.insert_max_visits: a
    # documented throughput deviation from libSQL's capless insert search).
    insert_max_visits: int = 0
    # Beam width of the insert-path search in BATCHED builds (sequential
    # batch-1 inserts pin width 1 for libSQL visit-order parity); see
    # LmDiskannConfig.insert_beam_width.
    insert_beam_width: int = 1
    # Node-vector storage dtype. INT8 (ARRAY(TINYINT, N) columns) keeps the
    # device array in int8 — 4x less HBM and visit-gather bandwidth — and
    # widens to f32 in-register at distance time, the real version of the
    # reference's CalculateDistance<float,int8> convert (distance.hpp:
    # 165-198); its AddNode stores a placeholder cast instead
    # (GraphManager.cpp:98-107, SURVEY Appendix B — done right here).
    node_vtype: VectorType = VectorType.FLOAT32
    # Hop-merge implementation: True = fused bitonic compare-exchange
    # networks, False = generic lax.sort (exactness-equal; see
    # ops/topk.merge_beams). Static so bench can A/B both; the default
    # depends on the backend (ops/topk.default_bitonic).
    bitonic: bool = True

    @classmethod
    def from_config(cls, config: LmDiskannConfig) -> "GraphParams":
        import os

        return cls(
            dims=config.dimensions,
            r=config.r,
            metric=config.metric_type,
            edge_type=config.resolve_edge_type(),
            alpha=config.alpha,
            l_insert=config.l_insert,
            l_search=config.l_search,
            max_visits=config.resolved_max_visits(),
            insert_max_visits=config.resolved_insert_max_visits(),
            insert_beam_width=config.insert_beam_width,
            node_vtype=config.node_vector_type,
            bitonic=_default_bitonic(os.environ.get("LMD_BITONIC")),
        )

    @property
    def words(self) -> int:
        return words_per_plane_u32(self.dims)

    @property
    def prune_metric(self) -> MetricType:
        """Metric used inside RobustPrune's alpha test.

        The Vamana rule ``alpha * d(p, r) < d(node, p)`` presumes
        non-negative distances; IP distance is -dot and can be negative,
        which inverts the rule and destroys graph quality. The reference
        carries IP through the same formula unvalidated (libSQL ships only
        cos/L2, vectorIndexInt.h:118-124); we prune IP indexes in cosine
        geometry (same neighbor *directions*, non-negative distances) while
        search ordering stays pure IP.
        """
        return MetricType.COSINE if self.metric is MetricType.IP else self.metric


def make_graph_arrays(params: GraphParams, capacity: int) -> GraphArrays:
    """Allocate zeroed arrays for ``capacity`` node slots."""
    d, r, w = params.dims, params.r, params.words
    et = params.edge_type
    tern = et is EdgeType.TERNARY
    onebit = et is EdgeType.FLOAT1BIT  # single sign plane in edge_pos
    i8 = et is EdgeType.INT8
    i4 = et is EdgeType.INT4
    f32 = et is EdgeType.FLOAT32
    f16 = et is EdgeType.FLOAT16
    i4w = words_per_i4(d)
    vec_dtype = (
        jnp.int8 if params.node_vtype is VectorType.INT8 else jnp.float32
    )
    pos = tern or onebit
    return GraphArrays(
        vectors=jnp.zeros((capacity, d), vec_dtype),
        neighbors=jnp.full((capacity, r), -1, jnp.int32),
        valid=jnp.zeros((capacity,), jnp.bool_),
        edge_pos=jnp.zeros((capacity, r if pos else 0, w if pos else 0), jnp.uint32),
        edge_neg=jnp.zeros((capacity, r if tern else 0, w if tern else 0), jnp.uint32),
        edge_i8=jnp.zeros((capacity, r if i8 else 0, d if i8 else 0), jnp.int8),
        edge_i4=jnp.zeros((capacity, r if i4 else 0, i4w if i4 else 0), jnp.uint32),
        edge_scale=jnp.zeros((capacity, r if (i8 or i4) else 0), jnp.float32),
        edge_f32=jnp.zeros(
            (capacity, r if (f32 or f16) else 0, d if (f32 or f16) else 0),
            jnp.float16 if f16 else jnp.float32,
        ),
        dirty_rows=jnp.zeros((capacity,), jnp.bool_),
    )


def grow_graph_arrays(arrays: GraphArrays, new_capacity: int) -> GraphArrays:
    """Double-and-copy growth (the analog of usearch's shared->exclusive
    resize upgrade in hnsw_index.cpp:391-449, minus the locks)."""
    old = arrays.capacity
    if new_capacity <= old:
        return arrays

    def grow(a):
        pad = [(0, new_capacity - old)] + [(0, 0)] * (a.ndim - 1)
        if a.dtype == jnp.int32 and a.ndim == 2:  # neighbors: -1 sentinel
            return jnp.pad(a, pad, constant_values=-1)
        return jnp.pad(a, pad)

    return GraphArrays(*(grow(a) for a in arrays))


class SlotAllocator:
    """Host-side rowid<->slot bookkeeping + free-list.

    The analog of GraphManager's ``rowid_to_node_ptr_map_``
    (GraphManager.hpp:123) and StorageManager's free-list-vs-append block
    allocation design note (StorageManager.cpp:294-309). Freed slots are NOT
    immediately reusable: they go to a pending deletion queue and only return
    to the free list on vacuum (Coordinator::PerformVacuum ->
    ProcessDeletionQueue, Coordinator.cpp:353-368), which keeps zombie edges
    from resolving to a new, different node in between.
    """

    def __init__(self) -> None:
        self.rowid_to_slot: dict[int, int] = {}
        self.slot_to_rowid: dict[int, int] = {}
        self.free_slots: list[int] = []
        self.pending_deletion: list[int] = []  # delete queue (slots)
        self.high_water: int = 0

    @property
    def count(self) -> int:
        return len(self.rowid_to_slot)

    def allocate(self, rowid: int) -> int:
        if rowid in self.rowid_to_slot:
            raise KeyError(f"row id {rowid} already in index")
        slot = self.free_slots.pop() if self.free_slots else self.high_water
        if slot == self.high_water:
            self.high_water += 1
        self.rowid_to_slot[rowid] = slot
        self.slot_to_rowid[slot] = rowid
        return slot

    def allocate_batch(self, rowids) -> np.ndarray:
        """Atomic batch allocation: validate EVERY rowid (against the map
        and within the batch) before allocating any, so a duplicate
        mid-batch cannot leave earlier rowids permanently mapped to ghost
        slots that no rollback knows about (round-4 review finding)."""
        rowids = [int(r) for r in rowids]
        seen: set[int] = set()
        for r in rowids:
            if r in self.rowid_to_slot:
                raise KeyError(f"row id {r} already in index")
            if r in seen:
                raise KeyError(f"row id {r} duplicated in batch")
            seen.add(r)
        return np.asarray([self.allocate(r) for r in rowids], np.int32)

    def free(self, rowid: int) -> int:
        """Unmap a row id; its slot joins the deletion queue."""
        slot = self.rowid_to_slot.pop(rowid)
        del self.slot_to_rowid[slot]
        self.pending_deletion.append(slot)
        return slot

    def process_deletion_queue(self) -> list[int]:
        """Vacuum: recycle pending slots into the free list
        (StorageManager::ProcessDeletionQueue semantics)."""
        recycled = self.pending_deletion
        self.free_slots.extend(recycled)
        self.pending_deletion = []
        return recycled

    def rowids_array(self, capacity: int) -> np.ndarray:
        """Dense slot->rowid map (-1 for unmapped), for result translation."""
        out = np.full(capacity, -1, np.int64)
        for slot, rowid in self.slot_to_rowid.items():
            out[slot] = rowid
        return out

    def lookup_slots(self, rowids) -> np.ndarray:
        return np.asarray(
            [self.rowid_to_slot.get(int(r), -1) for r in rowids], np.int32
        )


def derive_vector_type(vectors: np.ndarray) -> VectorType:
    """Dims/dtype derive from the data, mirroring the reference deriving them
    from the ARRAY(FLOAT|TINYINT, N) column type (db/LmDiskannIndex.cpp:137-154)."""
    vt = VectorType.from_dtype(vectors.dtype)
    if vt is VectorType.UNKNOWN:
        raise TypeError(
            f"Unsupported vector dtype {vectors.dtype}; expected float32 or int8 "
            "(ARRAY(FLOAT, N) / ARRAY(TINYINT, N) in the reference)"
        )
    return vt

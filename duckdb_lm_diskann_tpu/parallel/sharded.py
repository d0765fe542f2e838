"""Sharded index: multi-chip search and build over a device mesh.

Scaling design (SURVEY §5 / §7.2 M4-M5; the reference has no
distributed story to copy — this is new surface):

  - The vector set is hash/round-robin partitioned into S shards; each shard
    is an independent LM-DiskANN subgraph whose arrays live in one card's
    memory (``StackedGraphArrays``: every field gains a leading [S] dim sharded
    over the mesh's 'data' axis).
  - Search: queries are replicated; every chip runs the SAME batched beam
    search on its local subgraph inside ``shard_map`` (hops are lock-step
    compiled code, no cross-chip traffic), then per-shard top-k candidate
    sets — (global rowid, exact distance) tuples — are exchanged with ONE
    ``all_gather`` and merged with the deterministic (dist, id)
    sort. Exactly the candidate-exchange plan of SURVEY §2.4/§5.
  - Result equivalence: every visited node's distance is exact at visit and
    the final merge is a global sort, so the union-of-shards top-k equals
    the single-graph top-k whenever per-shard recall holds (each shard
    holds 1/S of the data and runs the same L — per-shard search is
    *easier* than the global problem).
  - Build: one batched insert step per shard runs under the same
    ``shard_map`` (device-only variant of core.builder.insert_batch);
    shards never exchange build traffic (their subgraphs are disjoint).

The same code paths compile for any mesh size — 8 virtual CPU devices in
tests, the GPUs of a host in production. Each shard's coordinator builds and
mutates on the mesh device that holds the shard.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..common.types import INVALID_ROW_ID
from ..core import builder
from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, GraphParams, make_graph_arrays
from ..core.searcher import beam_search
from ..ops import topk as topk_ops
from .mesh import DATA_AXIS, make_mesh


class StackedGraphArrays(NamedTuple):
    """GraphArrays with a leading shard dim [S, ...] + per-shard metadata.

    Row ids are 64-bit (duckdb row_t); devices default to 32-bit ints, so
    the slot->rowid map is carried as (hi, lo) int32 halves — hi = id >> 32,
    lo = low 32 bits (bit pattern). Empty slots are (-1, -1), which
    reassembles to int64 -1 == INVALID_ROW_ID.
    """

    arrays: GraphArrays  # every field [S, ...]
    rowids_hi: jnp.ndarray  # i32[S, C] high 32 bits of slot -> rowid
    rowids_lo: jnp.ndarray  # i32[S, C] low 32 bits (bit pattern)
    entry: jnp.ndarray  # i32[S] per-shard entry slot
    counts: jnp.ndarray  # i32[S] live counts


def _split_rowids64(rowids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    r = np.asarray(rowids, np.int64)
    hi = (r >> 32).astype(np.int32)
    lo = (r & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def _join_rowids64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.int64) << 32) | (
        np.asarray(lo, np.int32).view(np.uint32).astype(np.int64)
    )


def _local(tree):
    """Strip the leading shard dim inside shard_map (size 1 there)."""
    return jax.tree.map(lambda a: a[0], tree)


def partition_rows(n: int, n_shards: int) -> list[np.ndarray]:
    """Round-robin (hash-mod) partition of row indices -> per-shard lists."""
    return [np.arange(n)[i::n_shards] for i in range(n_shards)]


class ShardedIndex:
    """Host-side owner of per-shard Coordinators + the stacked device state.

    Build happens per shard (disjoint subgraphs), then shards are stacked
    and placed with a leading-dim sharding so each lives on its own chip.
    """

    def __init__(self, config: LmDiskannConfig, mesh=None):
        config.validate()
        self.config = config
        self.params = GraphParams.from_config(config)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.devices.size
        self.coordinators = [Coordinator(config) for _ in range(self.n_shards)]
        self._stacked: StackedGraphArrays | None = None
        # Incremental restack state: per-shard single-device buffers, keyed
        # by stacked-field name, refreshed only for shards mutated since the
        # last stack (round-1 restacked the WHOLE index host->device on
        # every mutation — O(N) per insert, disqualifying at 10M+ rows).
        self._shard_bufs: list[dict | None] = [None] * self.n_shards
        self._dirty_shards: set[int] = set(range(self.n_shards))
        self._stacked_cap = 0

    def _on_shard_device(self, s: int):
        """Run shard ``s``'s coordinator work on the mesh device that holds
        the shard, so each card builds and keeps only its own rows."""
        return jax.default_device(self.mesh.devices.flat[s])

    def _invalidate(self, shards) -> None:
        self._stacked = None
        self._dirty_shards.update(shards)

    def build(self, rowids, vectors: np.ndarray, max_batch: int = 1024) -> None:
        vectors = np.ascontiguousarray(np.atleast_2d(vectors), np.float32)
        rowids = np.asarray(rowids, np.int64)
        parts = partition_rows(len(rowids), self.n_shards)
        for s, part in enumerate(parts):
            if len(part):
                with self._on_shard_device(s):
                    self.coordinators[s].bulk_build(
                        rowids[part].tolist(), vectors[part],
                        max_batch=max_batch,
                    )
        self._invalidate(range(self.n_shards))

    def insert(self, rowids, vectors: np.ndarray) -> None:
        """Dynamic insert: route new rows to the smallest shards."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        order = np.argsort([c.count for c in self.coordinators], kind="stable")
        parts = np.array_split(np.arange(len(vectors)), self.n_shards)
        touched = []
        for s, part in zip(order, parts):
            if len(part):
                with self._on_shard_device(int(s)):
                    self.coordinators[s].insert(
                        [int(rowids[i]) for i in part], vectors[part]
                    )
                touched.append(int(s))
        self._invalidate(touched)

    def delete(self, rowids) -> int:
        n = 0
        touched = []
        for s, c in enumerate(self.coordinators):
            with self._on_shard_device(s):
                d = c.delete(rowids)
            if d:
                touched.append(s)
            n += d
        self._invalidate(touched)
        return n

    # ----------------------------------------------------------------- #
    # device state

    def stacked(self) -> StackedGraphArrays:
        """Assemble the device-sharded stacked state, re-uploading ONLY the
        shards mutated since the last call: each shard's rows live in one
        per-device buffer; ``jax.make_array_from_single_device_arrays``
        stitches the cached + refreshed buffers into the global arrays
        without touching clean shards (cost O(dirty), not O(N))."""
        if self._stacked is not None:
            return self._stacked
        cap = max(max(c.capacity for c in self.coordinators), 1)
        if cap != self._stacked_cap:
            # capacity growth reshapes every buffer: full refresh
            self._dirty_shards = set(range(self.n_shards))
            self._stacked_cap = cap
        devices = list(self.mesh.devices.flat)
        sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        for s in self._dirty_shards:
            c = self.coordinators[s]
            c._ensure_capacity(cap)
            hi, lo = _split_rowids64(c._slot_rowids[:cap])
            per_field = {
                name: np.asarray(c.arrays[i])
                for i, name in enumerate(GraphArrays._fields)
            }
            per_field["rowids_hi"] = hi
            per_field["rowids_lo"] = lo
            per_field["entry"] = np.asarray(c.entry_slot, np.int32)
            per_field["counts"] = np.asarray(c.count, np.int32)
            self._shard_bufs[s] = {
                name: jax.device_put(v[None], devices[s])
                for name, v in per_field.items()
            }
        self._dirty_shards = set()

        def assemble(name):
            sample = self._shard_bufs[0][name]
            global_shape = (self.n_shards,) + sample.shape[1:]
            return jax.make_array_from_single_device_arrays(
                global_shape,
                sharding,
                [self._shard_bufs[s][name] for s in range(self.n_shards)],
            )

        stacked = StackedGraphArrays(
            arrays=GraphArrays(*(assemble(n) for n in GraphArrays._fields)),
            rowids_hi=assemble("rowids_hi"),
            rowids_lo=assemble("rowids_lo"),
            entry=assemble("entry"),
            counts=assemble("counts"),
        )
        self._stacked = stacked
        return stacked

    def update(self, rowid: int, vector) -> None:
        """Update = delete + re-insert (Coordinator::Update semantics)."""
        self.delete([int(rowid)])
        self.insert([int(rowid)], np.atleast_2d(np.asarray(vector)))

    # ----------------------------------------------------------------- #
    # persistence (VERDICT r3 item 3): shard-parallel directories

    def save(self, directory) -> dict:
        """Checkpoint every shard into ``<directory>/shard_NNN/`` through
        the unchanged single-chip save (store/checkpoint.save_index: same
        graph.lmd + shadow format per shard) plus a ``sharded.json``
        manifest. Each shard's subgraph is self-contained — disjoint rows,
        no cross-shard edges — so per-shard directories ARE the natural
        unit of shard-parallel persistence (on a multi-host deployment each
        host writes its own shards' directories; single-controller here).
        Reference: hnsw_index.cpp:502-546 persistence duty."""
        import json
        from pathlib import Path

        from ..store.checkpoint import save_index

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        infos = []
        for s, c in enumerate(self.coordinators):
            infos.append(save_index(c, directory / f"shard_{s:03d}"))
        (directory / "sharded.json").write_text(
            json.dumps({"mode": "disjoint", "n_shards": self.n_shards})
        )
        return {"n_shards": self.n_shards, "shards": infos}

    def search(self, queries: np.ndarray, k: int, l_search: int | None = None):
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        L = max(l_search if l_search is not None else self.config.l_search, k)
        hi, lo, dists = sharded_search(
            self.stacked(),
            jnp.asarray(queries),
            mesh=self.mesh,
            params=self.params,
            l_search=L,
            k=k,
            assume_all_valid=all(
                not c._ever_tombstoned for c in self.coordinators
            ),
        )
        ids = _join_rowids64(np.asarray(hi), np.asarray(lo))
        return ids, np.asarray(dists)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "params", "l_search", "k", "assume_all_valid"),
)
def sharded_search(
    stacked: StackedGraphArrays,
    queries: jnp.ndarray,  # f32[B, D] (replicated)
    *,
    mesh,
    params: GraphParams,
    l_search: int,
    k: int,
    assume_all_valid: bool = False,
):
    """Per-shard local beam search + ONE all-gather top-k merge.

    Inside shard_map each chip sees its own [1, ...] slice of the stacked
    state; the only cross-chip communication is the final all_gather of
    [B, k] (rowid, dist) tuples — overlappable with the next batch's compute
    when pipelined by the caller.
    """
    spec = P(DATA_AXIS)
    rep = P()

    def shard_fn(arrays, rowids_hi, rowids_lo, entry, queries):
        local = _local(arrays)
        res = beam_search(
            local,
            queries,
            entry[0],
            params=params,
            l_search=l_search,
            k=k,
            assume_all_valid=assume_all_valid,
        )
        # slot -> global rowid (int64 as hi/lo halves) before leaving the
        # shard; invalid result slots carry (-1, -1).
        slots = res.topk_slots
        safe = jnp.maximum(slots, 0)
        gids_hi = jnp.where(slots >= 0, rowids_hi[0][safe], jnp.int32(-1))
        gids_lo = jnp.where(slots >= 0, rowids_lo[0][safe], jnp.int32(-1))
        dists = jnp.where(slots >= 0, res.topk_dists, jnp.inf)
        # Exchange candidate sets: all_gather over the data axis -> [S, B, k].
        all_hi = jax.lax.all_gather(gids_hi, DATA_AXIS)
        all_lo = jax.lax.all_gather(gids_lo, DATA_AXIS)
        all_dists = jax.lax.all_gather(dists, DATA_AXIS)
        # Deterministic global merge: sort union by (dist, rowid64), take k.
        # The low half is XOR-biased so signed int32 order matches unsigned
        # bit order; invalid entries sort last on dist=+inf regardless.
        B = queries.shape[0]
        flat_hi = jnp.moveaxis(all_hi, 0, 1).reshape(B, -1)
        flat_lo = jnp.moveaxis(all_lo, 0, 1).reshape(B, -1)
        flat_dists = jnp.moveaxis(all_dists, 0, 1).reshape(B, -1)
        lo_key = flat_lo ^ jnp.int32(-0x80000000)
        m_dists, m_hi, m_key = jax.lax.sort(
            (flat_dists, flat_hi, lo_key), dimension=-1, num_keys=3
        )
        m_lo = m_key ^ jnp.int32(-0x80000000)
        return m_hi[..., :k], m_lo[..., :k], m_dists[..., :k]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: spec, stacked.arrays),
            spec,
            spec,
            spec,
            rep,
        ),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return fn(
        stacked.arrays, stacked.rowids_hi, stacked.rowids_lo,
        stacked.entry, queries,
    )


def load_sharded(directory, mesh=None) -> ShardedIndex:
    """Load a ShardedIndex saved by :meth:`ShardedIndex.save`. The mesh
    must span exactly the saved shard count (the row partition is baked
    into the per-shard subgraphs; re-sharding = rebuild)."""
    import json
    from pathlib import Path

    from ..store.checkpoint import load_index

    directory = Path(directory)
    meta = json.loads((directory / "sharded.json").read_text())
    n_shards = int(meta["n_shards"])
    mesh = mesh if mesh is not None else make_mesh()
    if int(mesh.devices.size) != n_shards:
        raise ValueError(
            f"mesh has {int(mesh.devices.size)} devices but the checkpoint "
            f"was saved with {n_shards} shards"
        )
    coordinators = [
        load_index(directory / f"shard_{s:03d}") for s in range(n_shards)
    ]
    idx = ShardedIndex(coordinators[0].config, mesh=mesh)
    idx.coordinators = coordinators
    idx._invalidate(range(n_shards))
    return idx


# --------------------------------------------------------------------- #
# device-only sharded build step (the "training step" for multi-chip)


@functools.partial(jax.jit, static_argnames=("params",))
def insert_batch_device(
    arrays: GraphArrays,
    new_slots: jnp.ndarray,  # i32[M]
    new_vecs: jnp.ndarray,  # f32[M, D]
    entry_slot: jnp.ndarray,  # i32[]
    *,
    params: GraphParams,
) -> GraphArrays:
    """Fully on-device batched insert step (no host round-trip).

    Since round 2 this IS the single-chip bulk path — builder.insert_step
    runs the full-quality algorithm (multi-round reciprocal replace/prune +
    orphan in-link guarantee) entirely on device, so the multi-chip
    'training step' and the host build are the same algorithm.
    """
    arrays, refresh_t, refresh_f, _ = builder.insert_step(
        arrays,
        new_slots,
        new_vecs,
        entry_slot,
        params=params,
        full_visited=False,
        recip_rounds=builder._RECIP_ROUNDS,
        # inline single-edge code writes (per-shard arrays are 1/S-sized,
        # so the aliasing headroom concern of the 1M single-chip fused
        # program does not apply here)
        defer_edge_writes=False,
    )
    arrays = builder.refresh_edge_codes(arrays, refresh_t, params=params)
    return builder.refresh_edge_codes(arrays, refresh_f, params=params)


@functools.partial(jax.jit, static_argnames=("mesh", "params"))
def sharded_insert_step(
    stacked: StackedGraphArrays,
    new_slots: jnp.ndarray,  # i32[S, M] per-shard slots
    new_vecs: jnp.ndarray,  # f32[S, M, D] per-shard batches
    *,
    mesh,
    params: GraphParams,
) -> GraphArrays:
    """One build step on every shard simultaneously (no cross-shard traffic:
    subgraphs are disjoint). Returns updated stacked arrays."""
    spec = P(DATA_AXIS)

    def shard_fn(arrays, slots, vecs, entry):
        local = _local(arrays)
        out = insert_batch_device(
            local, slots[0], vecs[0], entry[0], params=params
        )
        return jax.tree.map(lambda a: a[None], out)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: spec, stacked.arrays), spec, spec, spec,
        ),
        out_specs=jax.tree.map(lambda _: spec, stacked.arrays),
        check_vma=False,
    )
    return fn(stacked.arrays, new_slots, new_vecs, stacked.entry)

"""Globally-sharded single graph: exact multi-chip result equivalence.

The disjoint-subgraph mode (:mod:`.sharded`) scales throughput but changes
the algorithm (per-shard entry points, union-of-shards merge). BASELINE.json
mandates a mode whose results are *identical* to the single-graph search
(SURVEY §7.3: "cross-shard candidate exchange every hop over a single global
graph"; the reference's global entry point, GraphManager.cpp:564-621). This
module provides it:

  - ONE graph, built exactly like the single-chip index (same slots, same
    neighbor lists, same entry point). Its arrays are block-partitioned by
    row across the mesh: global slot g lives on shard g // C_local at local
    row g % C_local — so device memory per card is 1/S of the index.
  - Search is the *unchanged* ``core.searcher.beam_search`` program run
    replicated on every chip inside ``shard_map``. Every row gather becomes
    owner-masked-local-gather + ``psum``: the owning shard contributes the
    row, all others contribute zeros, and the sum reassembles the exact
    value on every chip. Exactly one shard is ever nonzero, and x + 0 is
    exact in IEEE float, so the traversal — every beam insertion, visit
    order, tie-break — is bit-identical to the single-chip run. The test
    suite asserts ID-exact equality (not overlap).
  - The per-hop cross-chip traffic is the frontier working set (node row +
    R cached edge codes + neighbor validity), a few MB per hop at B=1024 —
    the candidate-exchange plan of SURVEY §2.4/§5.

Trade-off vs the disjoint mode: per-hop collectives cost latency, so this
mode is for indexes too large for one card's memory where exact single-graph
semantics are required; the disjoint mode remains the throughput scaler.
Both modes share all engine code.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..common.types import INVALID_ROW_ID
from ..core.builder import (
    _pair_chunk,
    _pow2_at_least,
    _RECIP_ROUNDS,
    delete_repair_round,
    force_edge_lists,
    insert_step,
    refresh_edge_codes,
    rescue_orphans_round,
    store_vectors,
)
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, GraphParams, make_graph_arrays
from ..core.searcher import beam_search
from .mesh import DATA_AXIS, make_mesh


@jax.tree_util.register_pytree_node_class
class PsumRows:
    """A row-sharded array that behaves like the full [C, ...] array under
    integer-array indexing, inside ``shard_map``.

    Holds only the local [C_local, ...] block; ``rows[idx]`` gathers the
    locally-owned rows (others -> 0) and ``psum``s over the mesh axis, so
    every shard sees the exact global gather. Registered as a pytree so a
    ``GraphArrays`` built from these passes through jit/shard_map untouched.
    """

    def __init__(self, local: jnp.ndarray, axis: str = DATA_AXIS):
        self.local = local
        self.axis = axis

    # pytree protocol
    def tree_flatten(self):
        return (self.local,), self.axis

    @classmethod
    def tree_unflatten(cls, axis, children):
        return cls(children[0], axis)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def ndim(self):
        return self.local.ndim

    @property
    def shape(self):
        # Global logical shape (C = S * C_local) for capacity arithmetic.
        s = jax.lax.axis_size(self.axis)
        return (self.local.shape[0] * s,) + self.local.shape[1:]

    def __getitem__(self, idx):
        idx = jnp.asarray(idx)
        c_local = self.local.shape[0]
        me = jax.lax.axis_index(self.axis)
        own = (idx // c_local) == me
        rows = self.local[jnp.where(own, idx % c_local, 0)]
        mask = own.reshape(own.shape + (1,) * (rows.ndim - own.ndim))
        if self.dtype == jnp.bool_:
            contrib = jnp.where(mask, rows, False).astype(jnp.int32)
            return jax.lax.psum(contrib, self.axis) > 0
        contrib = jnp.where(mask, rows, jnp.zeros((), self.dtype))
        return jax.lax.psum(contrib, self.axis)

    def astype(self, dtype):
        return PsumRows(self.local.astype(dtype), self.axis)

    @property
    def at(self):
        """Owner-masked functional scatter: ``rows.at[idx].set(vals,
        mode='drop')`` applies each row update on the shard that owns it
        (global slot g lives on shard g // C_local) and drops it everywhere
        else — the write-side dual of the psum gather. Every shard executes
        the same replicated update program, so each row is written exactly
        once, by its owner, with the same value it would get on one chip.
        Only ``mode='drop'`` row scatters are supported (the builder's
        write discipline: invalid targets carry the capacity sentinel)."""
        return _PsumRowsAt(self)


class _PsumRowsAt:
    def __init__(self, rows: "PsumRows"):
        self._rows = rows

    def __getitem__(self, idx):
        return _PsumRowsAtIndexer(self._rows, idx)


class _PsumRowsAtIndexer:
    def __init__(self, rows: "PsumRows", idx):
        self._rows = rows
        self._idx = idx

    def _local_idx(self) -> jnp.ndarray:
        rows = self._rows
        # Row scatter (idx) or per-element (row, col) scatter — the latter
        # is the builder's single-edge code write (write_single_edge_codes).
        idx = self._idx[0] if isinstance(self._idx, tuple) else self._idx
        idx = jnp.asarray(idx)
        c_local = rows.local.shape[0]
        me = jax.lax.axis_index(rows.axis)
        own = (idx >= 0) & ((idx // c_local) == me)
        # Non-owned rows get the out-of-bounds local index; with
        # mode='drop' below the scatter skips them (never wraps).
        return jnp.where(own, idx % c_local, c_local)

    def _indices(self):
        li = self._local_idx()
        if isinstance(self._idx, tuple):
            return (li,) + tuple(self._idx[1:])
        return (li,)

    def set(self, vals, mode: str = "drop"):
        if mode != "drop":
            raise NotImplementedError("PsumRows scatters require mode='drop'")
        rows = self._rows
        return PsumRows(
            rows.local.at[self._indices()].set(vals, mode="drop"), rows.axis
        )

    def add(self, vals, mode: str = "drop"):
        if mode != "drop":
            raise NotImplementedError("PsumRows scatters require mode='drop'")
        rows = self._rows
        return PsumRows(
            rows.local.at[self._indices()].add(vals, mode="drop"), rows.axis
        )

    def max(self, vals, mode: str = "drop"):
        if mode != "drop":
            raise NotImplementedError("PsumRows scatters require mode='drop'")
        rows = self._rows
        return PsumRows(
            rows.local.at[self._indices()].max(vals, mode="drop"), rows.axis
        )


def _stack_rows(a: np.ndarray, n_shards: int) -> np.ndarray:
    """[C, ...] -> [S, C/S, ...] block partition (C already padded)."""
    return np.asarray(a).reshape((n_shards, a.shape[0] // n_shards) + a.shape[1:])


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "params", "l_search", "k", "beam_width", "assume_all_valid"
    ),
)
def global_sharded_search(
    stacked: GraphArrays,  # every field [S, C/S, ...], sharded over 'data'
    queries: jnp.ndarray,  # f32[B, D] (replicated)
    entry_slot: jnp.ndarray,  # i32[] or i32[S_seeds] GLOBAL slot(s)
    *,
    mesh,
    params: GraphParams,
    l_search: int,
    k: int,
    beam_width: int = 1,
    assume_all_valid: bool = False,
):
    """The single-graph beam search over row-sharded arrays: the one
    engine program, with every row access routed through PsumRows."""
    spec = P(DATA_AXIS)
    rep = P()

    def shard_fn(arrays, queries, entry_slot):
        local = GraphArrays(*(PsumRows(a[0]) for a in arrays))
        res = beam_search(
            local,
            queries,
            entry_slot,
            params=params,
            l_search=l_search,
            k=k,
            beam_width=beam_width,
            assume_all_valid=assume_all_valid,
        )
        return res.topk_slots, res.topk_dists

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: spec, stacked), rep, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )
    return fn(stacked, queries, entry_slot)


def _alloc_stacked(params: GraphParams, capacity: int, mesh) -> GraphArrays:
    """Zeroed row-sharded arrays [S, C/S, ...]: each device materializes
    ONLY its own shard (jit + out_shardings writes per-device constants),
    so the full [C, ...] arrays never exist on any one device — the
    precondition for building an index larger than one chip's HBM."""
    S = int(mesh.devices.size)
    if capacity % S:
        raise ValueError("capacity must divide the mesh size")
    sharding = NamedSharding(mesh, P(DATA_AXIS))

    @functools.partial(jax.jit, out_shardings=sharding)
    def alloc():
        local = make_graph_arrays(params, capacity // S)
        return GraphArrays(
            *(jnp.broadcast_to(a[None], (S,) + a.shape) for a in local)
        )

    return alloc()


@functools.partial(
    jax.jit, static_argnames=("mesh",), donate_argnums=(0,)
)
def _global_store(stacked: GraphArrays, slots, vecs, *, mesh) -> GraphArrays:
    """store_vectors over row-sharded arrays (the first-node bootstrap)."""
    spec = P(DATA_AXIS)
    rep = P()

    def shard_fn(arrays, slots, vecs):
        local = GraphArrays(*(PsumRows(a[0]) for a in arrays))
        out = store_vectors.__wrapped__(local, slots, vecs)
        return GraphArrays(*(a.local[None] for a in out))

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: spec, stacked), rep, rep),
        out_specs=jax.tree.map(lambda _: spec, stacked),
        check_vma=False,
    )
    return fn(stacked, slots, vecs)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "params", "full_visited", "recip_rounds", "all_valid"
    ),
    donate_argnums=(0,),
)
def _global_insert_step(
    stacked: GraphArrays,
    new_slots,  # i32[M] global slots (-1 padded)
    new_vecs,  # f32[M, D] (replicated)
    entry_slot,  # i32[]
    *,
    mesh,
    params: GraphParams,
    full_visited: bool,
    recip_rounds: int,
    all_valid: bool = True,
) -> GraphArrays:
    """One whole batched Vamana insert over ROW-SHARDED arrays — the
    device-scaled build path (SURVEY §7.2 M5). The UNCHANGED single-graph
    insert program (core/builder.insert_step: candidate search,
    RobustPrune, neighbor write, reciprocal replace/prune rounds, in-link
    guarantee, deferred edge-code refresh) runs replicated on every shard
    inside shard_map, with every row gather reassembled by PsumRows' psum
    exchange and every row write applied shard-locally by the owner
    (PsumRows.at). Compute is replicated; graph MEMORY is 1/S per device —
    the binding constraint at the BASELINE 100M target (~510 GB of graph
    state, docs/SCALING.md). Results are bit-identical to the single-chip
    build: gathers are exact (x + 0), writes land once, and all arithmetic
    runs at the same shapes in the same order."""
    spec = P(DATA_AXIS)
    rep = P()

    def shard_fn(arrays, new_slots, new_vecs, entry_slot):
        local = GraphArrays(*(PsumRows(a[0]) for a in arrays))
        out, refresh_t, refresh_f, _ = insert_step.__wrapped__(
            local,
            new_slots,
            new_vecs,
            entry_slot,
            params=params,
            full_visited=full_visited,
            recip_rounds=recip_rounds,
            # same flag the single-chip path passes: True only while no
            # slot was ever tombstoned (coordinator.insert all_valid)
            all_valid=all_valid,
        )
        # Deferred edge-code refresh in the same bounded chunks as
        # insert_batch (per-shard caches are 1/S, so one traced program
        # holds the whole chain comfortably).
        CH = _pair_chunk(refresh_t.shape[0], params.r, params.dims)
        for off in range(0, refresh_t.shape[0], CH):
            out = refresh_edge_codes.__wrapped__(
                out, refresh_t[off : off + CH], params=params
            )
        out = refresh_edge_codes.__wrapped__(out, refresh_f, params=params)
        return GraphArrays(*(a.local[None] for a in out))

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: spec, stacked), rep, rep, rep),
        out_specs=jax.tree.map(lambda _: spec, stacked),
        check_vma=False,
    )
    return fn(stacked, new_slots, new_vecs, entry_slot)


# --------------------------------------------------------------------- #
# Sharded twins of the DELETE-path device programs (VERDICT r3 item 4).
# Each runs the UNCHANGED single-graph program (core/builder) replicated
# inside shard_map with every row access routed through PsumRows — the same
# construction as _global_insert_step. The one op that needed a true
# distributed re-derivation, the global in-link histogram, lives in
# builder.inlink_histogram (local histograms + psum).

_SPEC = P(DATA_AXIS)
_REP = P()


def _wrap(arrays: GraphArrays) -> GraphArrays:
    return GraphArrays(*(PsumRows(a[0]) for a in arrays))


def _unwrap(arrays: GraphArrays) -> GraphArrays:
    return GraphArrays(*(a.local[None] for a in arrays))


@functools.partial(jax.jit, static_argnames=("mesh", "field"))
def _g_gather_rows(stacked: GraphArrays, idx, *, mesh, field: str):
    """Replicated gather of whole rows of one stacked field by GLOBAL slot
    (owner contributes, psum reassembles)."""

    def shard_fn(arrays, idx):
        return getattr(_wrap(arrays), field)[idx]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP),
        out_specs=_REP,
        check_vma=False,
    )
    return fn(stacked, idx)


@functools.partial(
    jax.jit, static_argnames=("mesh",), donate_argnums=(0,)
)
def _g_tombstone(stacked: GraphArrays, del_idx, *, mesh) -> GraphArrays:
    """valid=False + dirty=True on the deleted slots, owner-applied."""

    def shard_fn(arrays, del_idx):
        local = _wrap(arrays)
        out = local._replace(
            valid=local.valid.at[del_idx].set(False),
            dirty_rows=local.dirty_rows.at[del_idx].set(True),
        )
        return _unwrap(out)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP),
        out_specs=jax.tree.map(lambda _: _SPEC, stacked),
        check_vma=False,
    )
    return fn(stacked, del_idx)


@functools.partial(
    jax.jit, static_argnames=("mesh", "params"), donate_argnums=(0,)
)
def _g_delete_repair_round(
    stacked: GraphArrays, tgt, extra, dels, *, mesh, params: GraphParams
) -> GraphArrays:

    def shard_fn(arrays, tgt, extra, dels):
        out = delete_repair_round.__wrapped__(
            _wrap(arrays), tgt, extra, dels, params=params
        )
        return _unwrap(out)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP, _REP, _REP),
        out_specs=jax.tree.map(lambda _: _SPEC, stacked),
        check_vma=False,
    )
    return fn(stacked, tgt, extra, dels)


@functools.partial(
    jax.jit, static_argnames=("mesh", "params"), donate_argnums=(0,)
)
def _g_delete_repair_scan(
    stacked: GraphArrays, tgt_stack, extra_stack, dels, *,
    mesh, params: GraphParams,
) -> GraphArrays:
    """G stacked equal-width repair rounds in one dispatch (the sharded
    twin of builder.delete_repair_scan): lax.scan inside the shard_map
    carries the row-sharded arrays through the sequential rounds, so the
    per-hop psum row exchange runs per scan step with no host round-trip
    between rounds."""

    def shard_fn(arrays, tgt_stack, extra_stack, dels):
        def body(arr, xs):
            t, e = xs
            return (
                delete_repair_round.__wrapped__(
                    arr, t, e, dels, params=params
                ),
                None,
            )

        # PsumRows is a registered pytree, so the wrapped (row-sharded)
        # GraphArrays is carried through the scan directly.
        out, _ = jax.lax.scan(
            body, _wrap(arrays), (tgt_stack, extra_stack)
        )
        return _unwrap(out)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP, _REP, _REP),
        out_specs=jax.tree.map(lambda _: _SPEC, stacked),
        check_vma=False,
    )
    return fn(stacked, tgt_stack, extra_stack, dels)


@functools.partial(
    jax.jit, static_argnames=("mesh", "params"), donate_argnums=(0,)
)
def _g_rescue_round(
    stacked: GraphArrays, tgt, sibs, dels, *, mesh, params: GraphParams
):

    def shard_fn(arrays, tgt, sibs, dels):
        out, adopters = rescue_orphans_round.__wrapped__(
            _wrap(arrays), tgt, sibs, dels, params=params
        )
        return _unwrap(out), adopters

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP, _REP, _REP),
        out_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP),
        check_vma=False,
    )
    return fn(stacked, tgt, sibs, dels)


@functools.partial(
    jax.jit, static_argnames=("mesh", "params"), donate_argnums=(0,)
)
def _g_refresh(
    stacked: GraphArrays, tgts, *, mesh, params: GraphParams
) -> GraphArrays:

    def shard_fn(arrays, tgts):
        return _unwrap(
            refresh_edge_codes.__wrapped__(_wrap(arrays), tgts, params=params)
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP),
        out_specs=jax.tree.map(lambda _: _SPEC, stacked),
        check_vma=False,
    )
    return fn(stacked, tgts)


@functools.partial(
    jax.jit, static_argnames=("mesh", "params"), donate_argnums=(0,)
)
def _g_force_links(
    stacked: GraphArrays, adopters, orphans, *, mesh, params: GraphParams
) -> GraphArrays:
    """force_edge_lists + dirty marking over the sharded tables (the
    repair_reachability write step)."""

    def shard_fn(arrays, adopters, orphans):
        local = _wrap(arrays)
        nbrs = force_edge_lists(
            local.vectors, local.neighbors, adopters,
            jnp.where(adopters >= 0, orphans, -1), params,
        )[0]
        cap = local.capacity
        dirty = local.dirty_rows.at[
            jnp.where(adopters >= 0, adopters, cap)
        ].set(True, mode="drop")
        return _unwrap(local._replace(neighbors=nbrs, dirty_rows=dirty))

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: _SPEC, stacked), _REP, _REP),
        out_specs=jax.tree.map(lambda _: _SPEC, stacked),
        check_vma=False,
    )
    return fn(stacked, adopters, orphans)


@jax.jit
def _medoid_stacked(vectors, valid):
    """Medoid over row-sharded [S, C/S, D] vectors (GSPMD inserts the
    cross-shard reductions). Same formula as Coordinator.set_entry_to_medoid;
    the cross-row mean reduction runs at a different shape, so the mean can
    differ in final-ulp rounding — the argmin choice is identical unless two
    rows are equidistant-to-ulp from the dataset mean."""
    v = vectors.astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(
        jnp.where(valid[..., None], v, 0.0), axis=(0, 1)
    ) / cnt.astype(jnp.float32)
    d = jnp.sum((v - mean[None, None, :]) ** 2, axis=-1)
    d = jnp.where(valid, d, jnp.inf)
    return jnp.argmin(d.reshape(-1))


class GlobalShardedIndex:
    """One LM-DiskANN graph whose HBM footprint is split across all chips.

    Build/DML run on the host-side Coordinator (single graph, unchanged
    semantics); ``distribute()`` block-partitions the arrays over the mesh;
    ``search`` runs the exact single-graph program with per-hop cross-shard
    row exchange. Results are ID- and distance-identical to
    ``Coordinator.search``.
    """

    def __init__(self, coordinator: Coordinator, mesh=None):
        self.coordinator = coordinator
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = int(self.mesh.devices.size)
        self._stacked: GraphArrays | None = None
        # True once the graph was BUILT sharded (distributed_build): the
        # full arrays have never existed on any one device/process, and all
        # further DML must stay on the sharded path.
        self._distributed = False
        self._needs_repair = False

    # DML delegates to the single-graph Coordinator — except after a
    # distributed build, where the replicated Coordinator arrays were never
    # populated and inserts run the sharded program directly.
    def insert(self, rowids, vectors) -> None:
        if self._distributed:
            self._distributed_insert(rowids, vectors)
            return
        self.coordinator.insert(rowids, vectors)
        self._stacked = None

    def delete(self, rowids) -> int:
        if self._distributed:
            return self._delete_distributed(rowids)
        n = self.coordinator.delete(rowids)
        self._stacked = None
        return n

    def _delete_distributed(self, rowids) -> int:
        """DELETE over row-sharded arrays: statement-for-statement mirror of
        Coordinator.delete (back-edge unlink + batched repair rounds +
        tombstone + orphan rescue + entry fallback), with every device
        program routed through its sharded twin and the global in-link
        histogram computed as local histograms + psum
        (builder.inlink_histogram). Graph results are identical to the
        single-chip delete: gathers are exact (x + 0), writes land once on
        their owner, and all arithmetic runs at the same shapes in the same
        order."""
        coord = self.coordinator
        rowids = [int(r) for r in rowids]
        seen: set[int] = set()
        present = [
            r
            for r in rowids
            if r in coord.allocator.rowid_to_slot
            and not (r in seen or seen.add(r))
        ]
        if not present:
            return 0
        del_slots = np.asarray(
            [coord.allocator.rowid_to_slot[r] for r in present], np.int32
        )
        del_set = set(int(s) for s in del_slots)
        params = coord.params
        R = params.r

        Dn = len(del_slots)
        # Pad the jitted gather/tombstone shapes like the repair rounds:
        # every distinct delete-batch size would otherwise compile two new
        # shard_map programs (minutes per shape on remote-compile backends).
        dpad0 = _pow2_at_least(Dn, 256)
        del_pad0 = np.full(dpad0, -1, np.int32)
        del_pad0[:Dn] = del_slots
        del_dev0 = jnp.asarray(del_pad0)
        nbr_rows = np.asarray(
            _g_gather_rows(
                self._stacked, del_dev0, mesh=self.mesh, field="neighbors",
            )
        )[:Dn]
        from ..core.builder import group_repair_rounds, plan_delete_repair

        rounds, rescue_plan = plan_delete_repair(nbr_rows, del_slots, R)
        for kind, t_pad, extra in group_repair_rounds(rounds):
            step = (
                _g_delete_repair_round
                if kind == "one"
                else _g_delete_repair_scan
            )
            self._stacked = step(
                self._stacked, jnp.asarray(t_pad), jnp.asarray(extra),
                del_dev0, mesh=self.mesh, params=params,
            )

        coord._ever_tombstoned = True
        self._stacked = _g_tombstone(
            self._stacked, del_dev0, mesh=self.mesh
        )

        if rescue_plan is not None:
            t_pad, sibs = rescue_plan
            self._stacked, adopters = _g_rescue_round(
                self._stacked, jnp.asarray(t_pad), jnp.asarray(sibs),
                del_dev0, mesh=self.mesh, params=params,
            )
            self._stacked = _g_refresh(
                self._stacked, adopters, mesh=self.mesh, params=params
            )

        for r in present:
            coord.allocator.free(r)
        sr = coord._slot_rowids.copy()
        sr[del_slots] = INVALID_ROW_ID
        coord._slot_rowids = sr
        if coord.shadow_service is not None:
            coord.shadow_service.log_delete_batch(present)

        if coord.entry_slot in del_set:
            coord.entry_slot, coord.entry_rowid = (
                self._select_fallback_entry_distributed()
            )
        coord.dirty = True
        self._needs_repair = True
        return len(present)

    def update(self, rowid: int, vector) -> None:
        """Update = delete + re-insert (Coordinator::Update semantics,
        Coordinator.cpp:226-237), on whichever path the index is in."""
        self.delete([int(rowid)])
        self.insert([int(rowid)], np.atleast_2d(np.asarray(vector)))

    def _host_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(neighbors [C, R], valid [C]) pulled to HOST from the sharded
        arrays — used by the rare host-side passes (entry fallback, the
        reachability BFS). Host RAM holds the full tables comfortably at
        any single-machine scale; per-DEVICE HBM stays 1/S. Multi-process
        meshes reassemble via process_allgather (np.asarray on an array
        spanning non-addressable devices raises)."""
        nbrs = self._stacked.neighbors
        valid = self._stacked.valid
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            nbrs = multihost_utils.process_allgather(nbrs, tiled=True)
            valid = multihost_utils.process_allgather(valid, tiled=True)
        nbrs = np.asarray(nbrs)
        valid = np.asarray(valid)
        return nbrs.reshape(-1, nbrs.shape[-1]), valid.reshape(-1)

    def _select_fallback_entry_distributed(self) -> tuple[int, int]:
        """Coordinator._select_fallback_entry over the sharded arrays
        (shared planner: builder.select_fallback_entry)."""
        from ..core.builder import select_fallback_entry

        coord = self.coordinator
        if not coord.allocator.slot_to_rowid:
            return -1, INVALID_ROW_ID
        nbrs_h, valid_h = self._host_tables()
        return select_fallback_entry(
            coord.allocator.slot_to_rowid, nbrs_h, valid_h
        )

    def vacuum(self) -> int:
        """PerformVacuum for the distributed mode: recycle tombstoned slots
        + reachability repair (Coordinator.vacuum semantics)."""
        if not self._distributed:
            n = self.coordinator.vacuum()
            self._stacked = None
            return n
        coord = self.coordinator
        recycled = coord.allocator.process_deletion_queue()
        coord.dirty = coord.dirty or bool(recycled)
        if getattr(self, "_needs_repair", False):
            self.repair_reachability()
        return len(recycled)

    def repair_reachability(self, max_rounds: int = 8) -> int:
        """Coordinator.repair_reachability over the sharded arrays: host BFS
        on pulled tables, orphan nearest-reachable search through the
        sharded program, force-link + refresh through the sharded twins."""
        coord = self.coordinator
        params = coord.params
        if coord.count < 2 or coord.entry_slot < 0:
            self._needs_repair = False
            return 0
        from ..core.builder import choose_adopters, reachable_mask

        total = 0
        for _ in range(max_rounds):
            nbrs_h, valid_h = self._host_tables()
            reach = reachable_mask(nbrs_h, valid_h, coord.entry_slot)
            orphans = np.nonzero(valid_h & ~reach)[0].astype(np.int32)
            if len(orphans) == 0:
                break
            pad = _pow2_at_least(len(orphans), 64)
            o_pad = np.full(pad, -1, np.int32)
            o_pad[: len(orphans)] = orphans
            o_dev = jnp.asarray(o_pad)
            q = _g_gather_rows(
                self._stacked, jnp.maximum(o_dev, 0), mesh=self.mesh,
                field="vectors",
            ).astype(jnp.float32)
            tk, _ = global_sharded_search(
                self._stacked, q, jnp.int32(coord.entry_slot),
                mesh=self.mesh, params=params,
                l_search=max(16, params.r), k=4,
            )
            adopters = choose_adopters(orphans, np.asarray(tk), nbrs_h, pad)
            n_adopted = int((adopters >= 0).sum())
            if n_adopted == 0:
                break
            total += n_adopted
            a_dev = jnp.asarray(adopters)
            self._stacked = _g_force_links(
                self._stacked, a_dev, o_dev, mesh=self.mesh, params=params
            )
            self._stacked = _g_refresh(
                self._stacked, a_dev, mesh=self.mesh, params=params
            )
            coord.dirty = True
        self._needs_repair = False
        return total

    # ------------------------------------------------------------------ #
    # device-scaled build: graph memory 1/S per device at BUILD time too

    def distributed_build(
        self, rowids, vectors, max_batch: int = 1024
    ) -> None:
        """Bulk-build the single global graph directly into row-sharded
        arrays: per-device graph memory is capacity/S for the whole build
        (not just for search), so an index larger than one chip's HBM can
        be CONSTRUCTED, not only served. The ramp schedule, batch padding,
        reciprocal rounds, and entry/medoid policy mirror
        Coordinator.insert/bulk_build statement-for-statement, and every
        batch runs core/builder.insert_step unchanged over PsumRows — so
        the resulting graph (and every search over it) is identical to the
        single-chip build's."""
        coord = self.coordinator
        if coord.count or self._stacked is not None:
            raise RuntimeError("distributed_build requires an empty index")
        vectors = np.ascontiguousarray(
            np.atleast_2d(np.asarray(vectors)), np.float32
        )
        rowids = [int(r) for r in rowids]
        n = len(rowids)
        if vectors.shape[0] != n:
            raise ValueError("rowids/vectors length mismatch")
        if vectors.shape[1] != coord.config.dimensions:
            raise ValueError(
                f"vector dimensions {vectors.shape[1]} != index dimensions "
                f"{coord.config.dimensions}"
            )
        S = self.n_shards
        cap = _pow2_at_least(max(n, S, 1))
        if cap % S:
            cap = ((cap // S) + 1) * S
        stacked = _alloc_stacked(coord.params, cap, self.mesh)
        slots = coord.allocator.allocate_batch(rowids)
        try:
            stacked = self._sharded_insert_loop(
                stacked, slots, vectors, max_batch, graph_size=0
            )
        except Exception:
            for r in rowids:
                if r in coord.allocator.rowid_to_slot:
                    coord.allocator.free(r)
            raise
        sr = np.full(cap, INVALID_ROW_ID, np.int64)
        sr[slots] = np.asarray(rowids, np.int64)
        coord._slot_rowids = sr
        coord.entry_slot = int(slots[0])
        coord.entry_rowid = rowids[0]
        self._stacked = stacked
        self._distributed = True
        # Entry -> medoid, like bulk_build's set_entry_to_medoid.
        m = int(_medoid_stacked(stacked.vectors, stacked.valid))
        if m in coord.allocator.slot_to_rowid:
            coord.entry_slot = m
            coord.entry_rowid = coord.allocator.slot_to_rowid[m]
        coord.dirty = True

    def _sharded_insert_loop(
        self,
        stacked: GraphArrays,
        slots: np.ndarray,
        vectors: np.ndarray,
        max_batch: int,
        graph_size: int,
    ) -> GraphArrays:
        """The Coordinator.insert ramp loop (step = min(remaining,
        graph_size, max_batch)) + insert_batch's bulk padding, over the
        sharded program."""
        import jax.numpy as jnp  # local: keep module import-safe

        coord = self.coordinator
        n = len(slots)
        offset = 0
        entry = coord.entry_slot
        if entry < 0 and n:
            stacked = _global_store(
                stacked,
                jnp.asarray(slots[:1], jnp.int32),
                jnp.asarray(vectors[:1], jnp.float32),
                mesh=self.mesh,
            )
            entry = int(slots[0])
            coord.entry_slot = entry
            offset = 1
            graph_size = 1
        while offset < n:
            step = min(n - offset, graph_size, max_batch)
            # insert_batch's _pad_bulk shape pinning: every ramp batch pads
            # to ONE compiled width (floor 64 for multi-row batches).
            pad_to = max_batch
            if step > 1:
                pad_to = max(pad_to, 64)
            bs = np.concatenate(
                [
                    np.asarray(slots[offset : offset + step], np.int32),
                    np.full(pad_to - step, -1, np.int32),
                ]
            )
            bv = vectors[offset : offset + step]
            if pad_to > step:
                bv = np.concatenate(
                    [bv, np.broadcast_to(bv[:1], (pad_to - step, bv.shape[1]))]
                )
            stacked = _global_insert_step(
                stacked,
                jnp.asarray(bs, jnp.int32),
                jnp.asarray(bv, jnp.float32),
                jnp.int32(entry),
                mesh=self.mesh,
                params=coord.params,
                full_visited=step == 1,
                recip_rounds=1 if step == 1 else _RECIP_ROUNDS,
                all_valid=not coord._ever_tombstoned,
            )
            offset += step
            graph_size += step
        return stacked

    def _distributed_insert(self, rowids, vectors) -> None:
        """Incremental insert after a distributed build (fixed capacity:
        the sharded arrays are pre-sized; growth would need a stacked
        re-pad, deliberately not silent)."""
        coord = self.coordinator
        vectors = np.ascontiguousarray(
            np.atleast_2d(np.asarray(vectors)), np.float32
        )
        rowids = [int(r) for r in rowids]
        if vectors.shape[0] != len(rowids):
            raise ValueError("rowids/vectors length mismatch")
        cap = int(self._stacked.vectors.shape[0] * self._stacked.vectors.shape[1])
        if coord.allocator.high_water + len(rowids) > cap:
            raise RuntimeError(
                f"distributed index at capacity {cap}; pre-size "
                "distributed_build for the full expected row count"
            )
        slots = coord.allocator.allocate_batch(rowids)
        try:
            self._stacked = self._sharded_insert_loop(
                self._stacked,
                slots,
                vectors,
                coord.max_insert_batch,
                graph_size=coord.count - len(rowids),
            )
        except Exception as exc:
            # Mirror Coordinator.insert's rollback: earlier batches of
            # this call may have stored vectors / linked nodes already —
            # tombstone every touched slot so searches cannot surface
            # ghost rows; a mid-program failure after donation has no
            # recoverable state (one fused program per batch).
            for r in rowids:
                if r in coord.allocator.rowid_to_slot:
                    coord.allocator.free(r)
            try:
                lost = bool(self._stacked.vectors.is_deleted())
            except Exception:  # non-jax leaves: never deleted
                lost = False
            if lost:
                raise RuntimeError(
                    "distributed insert failed after buffer donation; "
                    "in-memory index state was lost — reload from the "
                    f"last checkpoint (original error: {exc})"
                ) from exc
            coord._ever_tombstoned = True
            self._stacked = _g_tombstone(
                self._stacked, jnp.asarray(slots, jnp.int32), mesh=self.mesh
            )
            raise
        sr = coord._slot_rowids.copy()
        sr[slots] = np.asarray(rowids, np.int64)
        coord._slot_rowids = sr
        if coord.shadow_service is not None:
            # Delta log for crash recovery, like the single-chip insert
            # (and this class's delete path).
            coord.shadow_service.log_insert_batch(rowids, slots.tolist())
        coord.dirty = True

    def distribute(self) -> GraphArrays:
        """Block-partition the coordinator's arrays across the mesh.

        Multi-process meshes (jax.distributed): a NamedSharding spanning
        other hosts' devices is not addressable from this process, so each
        process places only its LOCAL devices' row blocks and assembles the
        global array with jax.make_array_from_single_device_arrays — every
        process holds the same full Coordinator state (the build is
        deterministic), so the assembled shards agree without any host
        ever transferring another host's rows."""
        if self._stacked is not None:
            return self._stacked
        coord = self.coordinator
        S = self.n_shards
        cap = coord.capacity
        # Non-divisible capacities (non-pow2 meshes): pad host-side to the
        # next multiple of S with zero rows (valid=False, unreferenced) —
        # _ensure_capacity doubles to powers of two and can never make
        # e.g. 2048 divisible by 3.
        cap_pad = -(-cap // S) * S
        sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        mesh_devs = list(self.mesh.devices.flat)

        def put(a):
            a = np.asarray(a)
            if cap_pad != a.shape[0]:
                a = np.concatenate(
                    [a, np.zeros((cap_pad - a.shape[0],) + a.shape[1:],
                                 a.dtype)]
                )
            rows = _stack_rows(a, S)
            if jax.process_count() == 1:
                return jax.device_put(rows, sharding)
            local = [
                jax.device_put(rows[g][None], d)
                for g, d in enumerate(mesh_devs)
                if d.process_index == jax.process_index()
            ]
            return jax.make_array_from_single_device_arrays(
                rows.shape, sharding, local
            )

        stacked = GraphArrays(*(put(a) for a in coord.arrays))
        self._stacked = stacked
        return stacked

    # ------------------------------------------------------------------ #
    # persistence (VERDICT r3 item 3: the durability story must survive
    # indexes bigger than one chip)

    def save(self, directory, chunk_bytes: int = 64 << 20) -> dict:
        """Checkpoint the global index into a standard index directory —
        the SAME on-disk format as the single-chip engine
        (store/checkpoint.save_index: graph.lmd blocks + shadow commit), so
        a global-sharded checkpoint can be re-opened single-chip and vice
        versa (block_id == global slot; the row partition is derivable as
        slot // (C/S)).

        Replicated mode: the Coordinator holds the full arrays — delegate.
        Distributed-built mode: each shard's rows are pulled to HOST shard
        by shard (per-device HBM never holds more than its own 1/S; host
        RAM streams the encode in chunk_bytes pieces) and written through
        the unchanged block codec via a host-materialized facade.
        Multi-PROCESS meshes take the shard-parallel path instead
        (:meth:`_save_multiprocess`): per-process block scatter-writes
        over a shared filesystem + one proc-0 shadow commit.
        Reference: hnsw_index.cpp:502-546; Consolidated Proposal:188-211.
        """
        from ..store.checkpoint import save_index

        if not self._distributed:
            return save_index(self.coordinator, directory, chunk_bytes)
        if jax.process_count() > 1:
            return self._save_multiprocess(directory)
        coord = self.coordinator
        stacked = self._stacked
        def pull_host(f):
            # explicit first dim: -1 can't be inferred on zero-size
            # edge-cache placeholders ([S, C/S, 0, 0])
            a = np.asarray(f)
            return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])

        host = GraphArrays(*(pull_host(f) for f in stacked))
        saved = coord.arrays
        coord.arrays = host  # numpy-backed facade; save_index pulls by slice
        try:
            info = save_index(coord, directory, chunk_bytes)
        finally:
            coord.arrays = saved
        # Clear the device-side dirty flags the facade save consumed.
        sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        self._stacked = stacked._replace(
            dirty_rows=jax.device_put(
                np.zeros(stacked.dirty_rows.shape, bool), sharding
            )
        )
        return info

    def _save_multiprocess(self, directory) -> dict:
        """Shard-parallel checkpoint over a MULTI-PROCESS mesh: each
        process encodes + scatter-writes only the block rows of its own
        (addressable) shards into the shared ``graph.lmd``; process 0
        commits the shadow lookup/metadata once. Requires a shared
        filesystem (the normal checkpoint arrangement). Protocol:

          1. proc 0 creates/truncates the file, marks it dirty; barrier.
          2. every proc writes its owned block ranges (disjoint offsets)
             and drops a per-process CRC sidecar; barrier.
          3. proc 0 finalizes the header (truncate to high_water), merges
             the CRC sidecars, and runs the transactional shadow commit.

        Always a full (non-incremental) rewrite — the per-block dirty
        flags live shard-local and a cross-process dirty union is not
        worth the coordination for checkpoints.
        Reference: hnsw_index.cpp:502-546; Consolidated Proposal:188-211.
        """
        from pathlib import Path

        from jax.experimental import multihost_utils

        from ..store.block_codec import encode_blocks, resolve_layout
        from ..store.checkpoint import _config_to_dict as _save_config_dict
        from ..store.file_service import open_block_file
        from ..store.shadow import ShadowStorageService
        from ..ops.quantize import i4_packed_from_planar_np

        coord = self.coordinator
        directory = Path(directory)
        layout = resolve_layout(coord.config)
        hw = coord.allocator.high_water
        pidx = jax.process_index()
        stacked = self._stacked
        S = self.n_shards
        c_local = int(stacked.vectors.shape[1])
        et = coord.params.edge_type
        slot_rowids = coord._slot_rowids

        if pidx == 0:
            directory.mkdir(parents=True, exist_ok=True)
            bf = open_block_file(
                directory / "graph.lmd", layout.block_size, create=True
            )
            bf.mark_dirty(True)
            bf.truncate(hw)
            bf.sync()
            bf.close()
            # Drop any stale staged CRCs from a previous (crashed) save so
            # the staged table ends up holding exactly this save's blocks.
            shadow0 = ShadowStorageService(directory)
            try:
                shadow0.clear_staged_checksums()
            finally:
                shadow0.close()
        multihost_utils.sync_global_devices("gsi_save_created")

        # Owned shards: leading-dim index g of each addressable block.
        owned = sorted(
            int(s.index[0].start)
            for s in stacked.vectors.addressable_shards
        )
        local_of = {
            int(s.index[0].start): i
            for i, s in enumerate(stacked.vectors.addressable_shards)
        }

        def shard_rows(field, g):
            return np.asarray(
                field.addressable_shards[local_of[g]].data
            )[0]

        bf = open_block_file(
            directory / "graph.lmd", layout.block_size, create=False
        )
        # Every process stages its blocks' CRCs in the shared shadow store
        # (WAL sqlite; short disjoint-key transactions) BEFORE writing the
        # blocks — the per-block crash invariant: at any instant every
        # on-disk block matches its committed OR staged CRC, so a save
        # killed mid-write leaves a recoverable file, same as the
        # single-chip chunked staging.
        shadow_p = ShadowStorageService(directory)
        blocks_written = 0
        try:
            for g in owned:
                lo = g * c_local
                n_rows = min(hw - lo, c_local)
                if n_rows <= 0:
                    continue
                vectors = shard_rows(stacked.vectors, g)[:n_rows]
                neighbors = shard_rows(stacked.neighbors, g)[:n_rows]
                valid = shard_rows(stacked.valid, g)[:n_rows]
                nbr_rowids = np.where(
                    neighbors >= 0,
                    slot_rowids[np.maximum(neighbors, 0)],
                    np.int64(INVALID_ROW_ID),
                )
                nbr_rowids = np.where(
                    valid[:, None], nbr_rowids, np.int64(INVALID_ROW_ID)
                )
                kw = {}
                if et.name == "TERNARY":
                    kw["edge_pos"] = shard_rows(stacked.edge_pos, g)[:n_rows]
                    kw["edge_neg"] = shard_rows(stacked.edge_neg, g)[:n_rows]
                elif et.name == "INT8":
                    kw["edge_i8"] = shard_rows(stacked.edge_i8, g)[:n_rows]
                    kw["edge_scale"] = shard_rows(
                        stacked.edge_scale, g
                    )[:n_rows]
                elif et.name == "INT4":
                    kw["edge_i4"] = i4_packed_from_planar_np(
                        shard_rows(stacked.edge_i4, g)[:n_rows],
                        coord.config.dimensions,
                    )
                    kw["edge_scale"] = shard_rows(
                        stacked.edge_scale, g
                    )[:n_rows]
                elif et.name in ("FLOAT32", "FLOAT16"):
                    kw["edge_f32"] = shard_rows(stacked.edge_f32, g)[:n_rows]
                elif et.name == "FLOAT1BIT":
                    kw["edge_pos"] = shard_rows(stacked.edge_pos, g)[:n_rows]
                blocks = encode_blocks(
                    coord.config, vectors, nbr_rowids, **kw
                )
                blocks[~valid] = 0
                idx = np.arange(lo, lo + n_rows, dtype=np.int64)
                shadow_p.stage_checksums(idx, bf.crc32_rows(blocks))
                bf.write_blocks_at(idx, blocks)
                blocks_written += n_rows
            bf.sync()
        finally:
            bf.close()
            shadow_p.close()
        multihost_utils.sync_global_devices("gsi_save_written")

        if pidx == 0:
            bf = open_block_file(
                directory / "graph.lmd", layout.block_size, create=False
            )
            try:
                bf.truncate(hw)  # deterministic header after racing writers
                bf.sync()
                shadow = ShadowStorageService(directory)
                try:
                    # Every block was rewritten and staged by its owner:
                    # the staged table IS the new committed checksum set.
                    checksums = {
                        int(b): int(v)
                        for b, v in shadow.load_staged_checksums().items()
                    }
                    shadow.commit_checkpoint(
                        lookup=dict(coord.allocator.rowid_to_slot),
                        tombstones=coord.allocator.pending_deletion,
                        checksums=checksums,
                        metadata={
                            "format_version": 3,
                            "config": _save_config_dict(coord.config),
                            "entry_rowid": coord.entry_rowid,
                            "count": coord.count,
                            "high_water": hw,
                            "free_slots": coord.allocator.free_slots,
                            "broken": False,
                        },
                        incremental=False,
                    )
                finally:
                    shadow.close()
                bf.mark_dirty(False)
            finally:
                bf.close()
        multihost_utils.sync_global_devices("gsi_save_committed")
        coord.dirty = False
        return {
            "blocks_written": blocks_written,
            "incremental": False,
            "high_water": hw,
        }

    def search(
        self,
        queries: np.ndarray,
        k: int,
        l_search: int | None = None,
        beam_width: int = 1,
    ):
        """Exact single-graph top-k over the sharded arrays. Returns
        (rowids i64[B, k], dists f32[B, k]) — identical to
        ``Coordinator.search`` on the same index state."""
        coord = self.coordinator
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        B = queries.shape[0]
        if coord.count == 0 or coord.entry_slot < 0:
            return (
                np.full((B, k), INVALID_ROW_ID, np.int64),
                np.full((B, k), np.inf, np.float32),
            )
        L = max(l_search if l_search is not None else coord.config.l_search, k)
        slots, dists = global_sharded_search(
            self.distribute(),
            jnp.asarray(queries),
            jnp.int32(coord.entry_slot),
            mesh=self.mesh,
            params=coord.params,
            l_search=L,
            k=k,
            assume_all_valid=not coord._ever_tombstoned,
            beam_width=beam_width,
        )
        slots = np.asarray(slots)
        rowids = np.where(
            slots >= 0,
            coord._slot_rowids[np.maximum(slots, 0)],
            INVALID_ROW_ID,
        )
        return rowids, np.asarray(dists)


def load_global_sharded(
    directory, mesh=None, verify_checksums: bool = True
) -> GlobalShardedIndex:
    """Load a checkpoint directly into row-sharded arrays: the full graph
    never materializes on any one DEVICE (host RAM stages the decode; each
    device receives only its own C/S rows via per-shard device_put) — the
    load-side dual of distributed_build. The directory format is the
    standard single-chip one, so any index saved by save_index or
    GlobalShardedIndex.save opens here."""
    from ..store.checkpoint import (
        _host_graph_arrays,
        _load_host_state,
        _restore_coordinator_meta,
    )
    from .mesh import make_mesh as _make_mesh

    st = _load_host_state(directory, verify_checksums)
    config = st["config"]
    mesh = mesh if mesh is not None else _make_mesh()
    S = int(mesh.devices.size)

    # Replicated Coordinator stays at minimum capacity (no graph arrays on
    # one device); allocator/rowid state is fully restored.
    coord = Coordinator(config)
    cap = _pow2_at_least(max(st["hw"], 1024))
    if cap % S:
        cap = ((cap // S) + 1) * S
    _restore_coordinator_meta(coord, st, cap)

    host = _host_graph_arrays(coord.params, cap, st)
    gidx = GlobalShardedIndex(coord, mesh=mesh)
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    mesh_devs = list(mesh.devices.flat)

    def put(a):
        # Multi-process meshes: every process decodes the shared file but
        # places ONLY its local devices' row blocks (distribute()'s
        # assembly pattern) — no host ever transfers another host's rows.
        rows = _stack_rows(a, S)
        local = [
            jax.device_put(rows[g][None], d)
            for g, d in enumerate(mesh_devs)
            if jax.process_count() == 1
            or d.process_index == jax.process_index()
        ]
        return jax.make_array_from_single_device_arrays(
            rows.shape, sharding, local
        )

    gidx._stacked = GraphArrays(*(put(a) for a in host))
    gidx._distributed = True
    # Entry fallback needs the placed sharded arrays: restore it here.
    if st["entry_rowid"] not in st["lookup"] and st["lookup"]:
        coord.entry_slot, coord.entry_rowid = (
            gidx._select_fallback_entry_distributed()
        )
    return gidx

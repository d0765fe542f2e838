"""Coordinator: the orchestration facade over storage, graph, and search.

JAX re-design of ``core::Coordinator`` (core/Coordinator.{hpp,cpp}),
which owns the injected storage/graph/searcher/shadow services and implements
the operation workflows:

  - Search: L_search resolution + delegation (Coordinator.cpp:63-102)
  - Insert: add node -> search candidates -> RobustPrune -> shadow LogInsert
    -> mark dirty, with rollback FreeNode on error (:104-174)
  - Delete: LogDelete -> EnqueueDeletion -> HandleNodeDeletion -> FreeNode
    (:176-224); back-edges are removed eagerly like libSQL's diskAnnDelete
    (vectordiskann.c:1626-1700) rather than deferred
  - Update = delete + insert (:226-237, a stub there; real here)
  - PerformVacuum -> ProcessDeletionQueue (:353-368)
  - GetInMemorySize accounting (:370-389)
  - Load/Save orchestration lives in store/checkpoint.py

Where the reference serializes mutations under IndexLock, here every
mutation is a pure batched transform of the ``GraphArrays`` pytree; the
Coordinator is the single host-side owner of the current array state plus
the rowid<->slot map.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..common.types import INVALID_ROW_ID, MetricType, VectorType
from ..utils.tracing import SearchStats
from .builder import _pow2_at_least, insert_batch
from .config import LmDiskannConfig
from .graph import (
    GraphArrays,
    GraphParams,
    SlotAllocator,
    grow_graph_arrays,
    make_graph_arrays,
)
from .searcher import beam_search, beam_search_many, beam_search_stream

_MIN_CAPACITY = 1024

# Interactive-serving batch buckets (search(pad_to_bucket=True)): ad-hoc
# batch sizes pad up to one of these, bounding compiled-program count (XLA
# retraces per distinct static shape, and a first compile costs seconds —
# far beyond any interactive budget).
SERVING_BUCKETS = (1, 8, 64, 256, 1024)


class ReadView(NamedTuple):
    """Immutable point-in-time handle set for lock-free reads.

    The functional engine makes this nearly free: every mutation builds
    NEW device arrays and (since the concurrent-reads work) a NEW
    slot->rowid table, so a reader that captured these references sees a
    consistent index state no matter what writers do afterwards — the
    cheap analog of the reference's shared-lock readers
    (hnsw_index.cpp:191,301-303). The one hazard is buffer DONATION
    (mutations reuse HBM in place); the db adapter's reader gate disables
    donation while any view is live (LmDiskannIndex._state_lock).
    """

    arrays: GraphArrays
    entry_slot: int
    seeds: np.ndarray  # i32[S]
    slot_rowids: np.ndarray  # i64[capacity]
    count: int
    ever_tombstoned: bool


class Coordinator:
    """Owns the index state and implements the operation workflows."""

    def __init__(self, config: LmDiskannConfig, initial_capacity: int = _MIN_CAPACITY):
        config.validate()
        self.config = config
        self.params = GraphParams.from_config(config)
        self.allocator = SlotAllocator()
        # Power-of-two capacities: array shapes key every compiled program,
        # so arbitrary capacities would recompile the whole engine per
        # index size.
        capacity = _MIN_CAPACITY
        while capacity < initial_capacity:
            capacity *= 2
        self.arrays: GraphArrays = make_graph_arrays(self.params, capacity)
        # Entry point: first inserted node; random fallback on deletion
        # (GraphManager::SetEntryPoint / SelectEntryPointForSearch,
        # GraphManager.cpp:118-121, :564-621 — pinned deterministically to
        # the smallest live slot instead of a random node).
        self.entry_slot: int = -1
        self.entry_rowid: int = INVALID_ROW_ID
        # Dense slot -> rowid map mirrored on host for result translation.
        self._slot_rowids = np.full(capacity, INVALID_ROW_ID, np.int64)
        self.dirty: bool = False
        self.max_insert_batch: int = 1024
        self._pad_bulk: bool = False
        # (batch_rows, host_call_seconds) per insert dispatch; see insert().
        # Bounded: long-lived streaming inserters must not leak.
        self.build_timings: list[tuple[int, float]] = []
        self._needs_reachability_repair: bool = False
        # True once ANY slot has ever been tombstoned (delete, failed-insert
        # rollback, or loaded tombstones). While False, every edge target is
        # live and searches run with assume_all_valid=True, skipping the
        # per-hop neighbor-validity element gather — 65% of the hop cost at
        # 1M rows (see beam_search docstring). Never cleared: a vacuum
        # recycles slots but zombie in-edges into freed slots can persist.
        self._ever_tombstoned: bool = False
        self.last_search_stats: SearchStats | None = None
        # False while concurrent readers hold ReadViews of the current
        # buffers (set by the db adapter's reader gate): mutations then run
        # the non-donating kernel twins instead of reusing HBM in place.
        self.donate_buffers: bool = True
        # Optional services injected by the db/store layers (the ctor
        # injection of Coordinator.hpp:46-48).
        self.shadow_service = None  # store.shadow.ShadowStorageService

    # ------------------------------------------------------------------ #
    # properties / stats

    @property
    def count(self) -> int:
        return self.allocator.count

    @property
    def capacity(self) -> int:
        return self.arrays.capacity

    def get_in_memory_size(self) -> int:
        """Byte accounting over the device arrays
        (Coordinator::GetInMemorySize, Coordinator.cpp:370-389)."""
        total = 0
        for a in self.arrays:
            total += a.size * a.dtype.itemsize
        return total

    # ------------------------------------------------------------------ #
    # snapshots (MVCC / snapshot isolation, Consolidated Proposal:82-96)

    def snapshot(self) -> "Coordinator":
        """Point-in-time read-only view with snapshot-isolation semantics.

        The V2 design embeds commit_epoch / origin_txn_id MVCC fields in
        every node block and filters visibility per search (Consolidated
        Proposal:82-96: "queries should see the index state as of their
        transaction's snapshot"). In the functional design the guarantee is
        structural: mutations build NEW arrays, so a snapshot simply
        retains the superseded state — no per-block epoch checks in the hot
        loop. The one subtlety is buffer donation (insert_batch reuses HBM
        buffers in place), so the snapshot takes a device-side copy: the
        cost of keeping two versions resident is paid once at snapshot()
        time. Mutating the snapshot raises; searches on it never see later
        inserts/deletes (no phantom reads), and vacuum slot-recycling in
        the live index cannot corrupt it.
        """
        snap = Coordinator.__new__(Coordinator)
        snap.config = self.config
        snap.params = self.params
        snap.allocator = SlotAllocator()
        snap.allocator.rowid_to_slot = dict(self.allocator.rowid_to_slot)
        snap.allocator.slot_to_rowid = dict(self.allocator.slot_to_rowid)
        snap.allocator.free_slots = list(self.allocator.free_slots)
        snap.allocator.pending_deletion = list(self.allocator.pending_deletion)
        snap.allocator.high_water = self.allocator.high_water
        snap.arrays = GraphArrays(*(a.copy() for a in self.arrays))
        snap.entry_slot = self.entry_slot
        snap.entry_rowid = self.entry_rowid
        snap._slot_rowids = self._slot_rowids.copy()
        snap.dirty = False
        snap.max_insert_batch = self.max_insert_batch
        snap._pad_bulk = False
        snap.build_timings = []
        snap._needs_reachability_repair = False
        snap._ever_tombstoned = self._ever_tombstoned
        snap.last_search_stats = None
        snap.shadow_service = None
        snap.donate_buffers = False  # never donate a snapshot's buffers
        snap._frozen = True
        return snap

    def _check_mutable(self) -> None:
        if getattr(self, "_frozen", False):
            raise RuntimeError(
                "index snapshot is read-only (snapshot isolation, "
                "Consolidated Proposal:82-96)"
            )

    # ------------------------------------------------------------------ #
    # capacity management

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        self.arrays = grow_graph_arrays(self.arrays, new_cap)
        grown = np.full(new_cap, INVALID_ROW_ID, np.int64)
        grown[: len(self._slot_rowids)] = self._slot_rowids
        self._slot_rowids = grown

    # ------------------------------------------------------------------ #
    # insert (Coordinator::Insert, Coordinator.cpp:104-174)

    def insert(self, rowids: Sequence[int], vectors: np.ndarray) -> None:
        """Insert a batch of (rowid, vector) pairs."""
        self._check_mutable()
        vectors = np.atleast_2d(np.asarray(vectors))
        rowids = [int(r) for r in rowids]
        if len(rowids) != vectors.shape[0]:
            raise ValueError("rowids/vectors length mismatch")
        if vectors.shape[1] != self.config.dimensions:
            raise ValueError(
                f"vector dimensions {vectors.shape[1]} != index dimensions "
                f"{self.config.dimensions}"
            )
        # Compute flows in f32; store_vectors quantizes back to the storage
        # dtype (int8 round+clamp — identity for TINYINT-column values).
        vectors = np.ascontiguousarray(vectors, np.float32)

        self._ensure_capacity(self.allocator.high_water + len(rowids))
        graph_size = self.count  # nodes already connected into the graph
        slots = self.allocator.allocate_batch(rowids)
        try:
            offset = 0
            # The very first node bootstraps alone (entry point, no edges).
            if self.entry_slot < 0 and len(slots):
                self.arrays = insert_batch(
                    self.arrays, slots[:1], vectors[:1], -1, self.params
                )
                self.entry_slot = int(slots[0])
                self.entry_rowid = rowids[0]
                offset = 1
                graph_size = 1
            while offset < len(slots):
                # Batch width never exceeds the current graph size: a batch
                # searches the pre-batch graph, so wider batches against a
                # tiny graph would all pick the same few candidates and
                # degrade connectivity. This self-ramps 1,1,2,4,... like the
                # build schedule.
                step = min(len(slots) - offset, graph_size, self.max_insert_batch)
                t0 = time.perf_counter()
                self.arrays = insert_batch(
                    self.arrays,
                    slots[offset : offset + step],
                    vectors[offset : offset + step],
                    self.entry_slot,
                    self.params,
                    # Bulk builds pad every (ramp) batch to one pinned shape
                    # so the whole build compiles the search/prune programs
                    # exactly once.
                    pad_to=self.max_insert_batch if self._pad_bulk else None,
                    all_valid=not self._ever_tombstoned,
                    donate=self.donate_buffers,
                )
                # Host-call duration: ~compile time on first-seen shapes
                # (XLA compiles synchronously at dispatch), ~dispatch cost
                # otherwise. bench.py splits build time into compile vs
                # steady-state from this log.
                if self._pad_bulk:
                    # Fence the dispatch queue with a 4-byte host pull:
                    # bulk batches are TWO donated programs (insert_step_
                    # fused + apply_edge_writes), and the fence keeps the
                    # host from queueing hundreds of alternating
                    # executions ahead of the device.
                    np.asarray(self.arrays.neighbors[0, :1])
                self.build_timings.append((step, time.perf_counter() - t0))
                if len(self.build_timings) > 8192:
                    del self.build_timings[:4096]
                offset += step
                graph_size += step
        except Exception as exc:
            # Rollback FreeNode on error (Coordinator.cpp:160-172): clear the
            # valid mask for every slot this batch touched (store_vectors may
            # have marked them live) and leave the slots in the pending
            # deletion queue — immediate recycling would bypass the
            # zombie-edge protection the queue exists to provide; vacuum
            # reclaims them like any other delete.
            #
            # insert_batch donates self.arrays' buffers; if it failed AFTER
            # the donation it attaches the last-good intermediate state —
            # restore it so the rollback below operates on live buffers
            # (touching the donated handle would raise and mask the real
            # error, leaving the coordinator bricked).
            partial = getattr(exc, "partial_arrays", None)
            if partial is not None:
                self.arrays = partial
            touched = [
                self.allocator.rowid_to_slot[r]
                for r in rowids
                if r in self.allocator.rowid_to_slot
            ]
            from .builder import _buffers_deleted

            lost = _buffers_deleted(self.arrays)
            if touched and not lost:
                self._ever_tombstoned = True
                self.arrays = self.arrays._replace(
                    valid=self.arrays.valid.at[
                        jnp.asarray(touched, jnp.int32)
                    ].set(False)
                )
            for r in rowids:
                if r in self.allocator.rowid_to_slot:
                    self.allocator.free(r)
            # The rolled-back batch may have held the bootstrap entry
            # point (first-ever insert): a stale entry_slot >= 0 with an
            # empty graph would skip the bootstrap on the next insert and
            # brick the ramp (step = min(n, count=0, ...) = 0).
            if (
                self.entry_slot >= 0
                and self.entry_rowid not in self.allocator.rowid_to_slot
            ):
                if self.allocator.slot_to_rowid and not lost:
                    self.entry_slot, self.entry_rowid = (
                        self._select_fallback_entry()
                    )
                else:
                    self.entry_slot, self.entry_rowid = -1, INVALID_ROW_ID
            if lost:
                # The fused insert program donated the buffers and failed
                # mid-flight: there is no last-good intermediate state to
                # roll back onto (the unfused chain attaches partial_arrays;
                # one fused program cannot). Say so explicitly instead of
                # letting the next operation fail on deleted buffers.
                raise RuntimeError(
                    "insert failed after buffer donation; in-memory index "
                    "state was lost — reload from the last checkpoint "
                    f"(original error: {exc})"
                ) from exc
            raise
        # Copy-on-write: live ReadViews keep the pre-mutation table.
        sr = self._slot_rowids.copy()
        sr[slots] = np.asarray(rowids, np.int64)
        self._slot_rowids = sr
        if self.shadow_service is not None:
            self.shadow_service.log_insert_batch(rowids, slots.tolist())
        self.dirty = True
        self._needs_reachability_repair = True

    def bulk_build(
        self,
        rowids: Sequence[int],
        vectors: np.ndarray,
        max_batch: int = 1024,
    ) -> None:
        """CREATE INDEX bulk path: ramped batched insertion — the analog of
        the reference's parallel construct tasks
        (hnsw_index_physical_create.cpp:231-306); LM-DiskANN's own Append
        loops row-by-row over Insert (db/LmDiskannIndex.cpp:350-376), which
        batch ramping generalizes."""
        old = self.max_insert_batch
        self.max_insert_batch = max_batch
        self._pad_bulk = True
        try:
            self.insert(rowids, np.atleast_2d(vectors))
        finally:
            self.max_insert_batch = old
            self._pad_bulk = False
        self.set_entry_to_medoid()

    def refine(
        self,
        max_batch: int | None = None,
        repair: bool = True,
    ) -> int:
        """Post-build refine pass — the classic Vamana second pass
        (vectordiskann.c:1493-1623's insert structure re-applied to built
        nodes): every live node re-searches the FINAL
        graph for its L_insert candidate set and RobustPrunes its out-edges
        over (current neighborhood ∪ visited set) with the final alpha.
        Early-inserted nodes chose edges when the graph was a fraction of
        its final size; re-pruning against the finished graph gives them
        the same edge quality late arrivals get.

        Out-edge re-pruning can evict a node's LAST in-link (exactly the
        failure round 4 measured when it tried a naive second pass:
        reciprocal/force-linked in-links erased, recall DOWN 2%); with
        ``repair`` the reachability fixpoint (repair_reachability) restores
        an in-link for every stranded node afterwards, which is the missing
        half of the naive pass. Returns the number of rows refined."""
        from .builder import batched_robust_prune, write_neighbor_rows
        from .searcher import search_for_initial_candidates

        self._check_mutable()
        if self.count < 2 or self.entry_slot < 0:
            return 0
        mb = max_batch or self.max_insert_batch
        live = np.asarray(
            sorted(self.allocator.slot_to_rowid.keys()), np.int32
        )
        all_valid = not self._ever_tombstoned
        done = 0
        for off in range(0, len(live), mb):
            chunk = live[off : off + mb]
            if len(chunk) < mb:  # pad to the pinned shape (-1 rows drop)
                chunk = np.concatenate(
                    [chunk, np.full(mb - len(chunk), -1, np.int32)]
                )
            slots = jnp.asarray(chunk)
            vecs = self.arrays.vectors[jnp.maximum(slots, 0)].astype(
                jnp.float32
            )
            res = search_for_initial_candidates(
                self.arrays,
                vecs,
                jnp.int32(self.entry_slot),
                params=self.params,
                l_insert=self.config.l_insert,
                beam_width=self.params.insert_beam_width,
                assume_all_valid=all_valid,
            )
            cands = jnp.concatenate(
                [
                    self.arrays.neighbors[jnp.maximum(slots, 0)],
                    res.visited_slots,
                ],
                axis=1,
            )
            cands = jnp.where((slots >= 0)[:, None], cands, -1)
            sel = batched_robust_prune(
                self.arrays, vecs, cands, slots, params=self.params
            )
            self.arrays = write_neighbor_rows(
                self.arrays, slots, sel, params=self.params
            )
            done += int((chunk >= 0).sum())
        self.dirty = True
        self._needs_reachability_repair = True
        if repair:
            self.repair_reachability()
        return done

    # ------------------------------------------------------------------ #
    # search (Coordinator::Search, Coordinator.cpp:63-102)

    def capture_view(self, n_seeds: int = 1) -> ReadView:
        """Capture an immutable read view (see ReadView). Callers that may
        race writers must capture under the adapter's state lock."""
        return ReadView(
            arrays=self.arrays,
            entry_slot=self.entry_slot,
            seeds=self._seed_slots(n_seeds),
            slot_rowids=self._slot_rowids,
            count=self.count,
            ever_tombstoned=self._ever_tombstoned,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int,
        l_search: int | None = None,
        beam_width: int = 1,
        n_seeds: int = 1,
        allowed_rowids: "np.ndarray | None" = None,
        view: "ReadView | None" = None,
        batch_size: int | None = None,
        adaptive_seeds: int = 0,
        seed_sample: int = 4096,
        stream: bool = False,
        lanes: int = 1024,
        pad_to_bucket: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k search. Returns (rowids i64[B, k], dists f32[B, k]);
        empty slots are (-1, +inf) — fewer than k results happens only when
        the index holds fewer than k rows.

        ``allowed_rowids`` restricts RESULTS to those rows (filtered search:
        traversal still routes through all nodes; see beam_search).

        ``batch_size``: when set and B > batch_size, queries run as
        ceil(B/batch_size) device-side pipelined batches in ONE dispatch
        (searcher.beam_search_many) — the throughput path; per-dispatch
        host round-trips are paid once per call, not once per batch.
        Results are bit-identical to the single-dispatch path. SearchStats caveat for this path: ``hops``
        sums the per-batch lock-step hop counts (pad lanes, which repeat
        query 0, can extend the last batch's loop), and visited/
        distance_ops count only the B real lanes — so stats are not
        directly comparable with a single-dispatch run of the same
        queries.

        ``adaptive_seeds``: when > 0, each query's beam is seeded with its
        ``adaptive_seeds`` nearest nodes among a ``seed_sample``-node
        stratified live sample (searcher.pick_adaptive_seeds) instead of
        the global entry point — the IVF-style entry fix for clustered
        corpora (+2.4% recall@10 on the HARD corpus at the same visit
        budget). Off by default: the reference semantics (single global
        entry) stay the parity-pinned behavior; overrides ``n_seeds``.

        ``stream``: run through searcher.beam_search_stream — ``lanes``
        device lanes with continuous refill from the query queue (the
        skew-aware rebatching path; result-identical, beam_width must be
        1). Preferred for large query sets on skewed corpora where the
        lock-step batch waits on stragglers.

        ``pad_to_bucket``: interactive serving — pad the query count up to
        the nearest of SERVING_BUCKETS (1, 8, 64, 256, 1024) with repeats
        of the first query (computed, discarded), so ad-hoc batch sizes
        reuse at most len(SERVING_BUCKETS) compiled programs instead of
        retracing per distinct B (XLA static shapes)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.config.dimensions:
            raise ValueError(
                f"query dimensions {queries.shape[1]} != index dimensions "
                f"{self.config.dimensions}"
            )
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        B = queries.shape[0]
        # Everything below reads ONLY the captured view, never live self
        # state: with a view captured under the adapter's state lock this
        # search is safe against concurrent writers (lock-free reads).
        L = max(l_search if l_search is not None else self.config.l_search, k)
        if view is None:
            view = self.capture_view(min(n_seeds, L))
        if view.count == 0 or view.entry_slot < 0:
            return (
                np.full((B, k), INVALID_ROW_ID, np.int64),
                np.full((B, k), np.inf, np.float32),
            )
        # L_search = max(explicit param or config default, k)
        # (Coordinator.cpp:63-102 / Searcher::Search :256-272).
        seeds = view.seeds
        capacity = view.arrays.capacity
        allowed = None
        if allowed_rowids is not None:
            # Slot-space predicate mask: slot allowed iff its rowid is in
            # the allowed set (vectorized over the slot->rowid table).
            allowed = jnp.asarray(
                np.isin(
                    view.slot_rowids[:capacity],
                    np.asarray(allowed_rowids, np.int64),
                )
            )
        n_real = B
        if pad_to_bucket and not stream and (
            batch_size is None or B <= batch_size
        ):
            bucket = next((b for b in SERVING_BUCKETS if b >= B), None)
            if bucket is not None and bucket != B:
                padded = np.broadcast_to(
                    queries[:1], (bucket, queries.shape[1])
                ).copy()
                padded[:B] = queries
                queries = padded
                B = bucket
        t0 = time.perf_counter()
        if stream:
            if beam_width != 1:
                raise ValueError("stream search supports beam_width=1 only")
            entry = (
                self._pick_adaptive(
                    view, jnp.asarray(queries), adaptive_seeds, seed_sample, L
                )
                if adaptive_seeds > 0
                else jnp.asarray(seeds)
            )
            sres = beam_search_stream(
                view.arrays,
                jnp.asarray(queries),
                entry,
                params=self.params,
                l_search=L,
                k=k,
                lanes=lanes,
                allowed=allowed,
                assume_all_valid=not view.ever_tombstoned,
            )
            slots = np.asarray(sres.topk_slots)
            dists = np.asarray(sres.topk_dists)
            visited = int(np.asarray(sres.visited_count).sum())
            hops = int(sres.hops)
        elif batch_size is not None and B > batch_size:
            # Pipelined multi-batch path: pad B to a multiple of batch_size
            # (repeating the first query — results for pad lanes are
            # computed and discarded) and scan batches inside one dispatch.
            nb = -(-B // batch_size)
            padded = np.broadcast_to(
                queries[:1], (nb * batch_size, queries.shape[1])
            ).copy()
            padded[:B] = queries
            q_dev = jnp.asarray(padded).reshape(nb, batch_size, -1)
            if adaptive_seeds > 0:
                entry = self._pick_adaptive(
                    view, q_dev.reshape(nb * batch_size, -1),
                    adaptive_seeds, seed_sample, L,
                ).reshape(nb, batch_size, -1)
            else:
                entry = jnp.asarray(seeds)
            mres = beam_search_many(
                view.arrays,
                q_dev,
                entry,
                params=self.params,
                l_search=L,
                k=k,
                beam_width=beam_width,
                allowed=allowed,
                assume_all_valid=not view.ever_tombstoned,
            )
            slots = np.asarray(mres.topk_slots).reshape(-1, k)[:B]
            dists = np.asarray(mres.topk_dists).reshape(-1, k)[:B]
            visited = int(np.asarray(mres.visited_count).reshape(-1)[:B].sum())
            hops = int(np.asarray(mres.hops).sum())
        else:
            q_dev = jnp.asarray(queries)
            entry = (
                self._pick_adaptive(view, q_dev, adaptive_seeds, seed_sample, L)
                if adaptive_seeds > 0
                else jnp.asarray(seeds)
            )
            res = beam_search(
                view.arrays,
                q_dev,
                entry,
                params=self.params,
                l_search=L,
                k=k,
                beam_width=beam_width,
                allowed=allowed,
                assume_all_valid=not view.ever_tombstoned,
            )
            slots = np.asarray(res.topk_slots)
            dists = np.asarray(res.topk_dists)
            visited = int(np.asarray(res.visited_count).sum())
            hops = int(res.hops)
        wall = time.perf_counter() - t0  # after device sync (np.asarray)
        self.last_search_stats = SearchStats(
            queries=B,
            hops=hops,
            nodes_visited=visited,
            l_search=L,
            k=k,
            # R edge-code scores + 1 exact per visit, plus the seed scores.
            distance_ops=visited * (self.params.r + 1) + B * len(seeds),
            wall_time_s=wall,
        )
        slots, dists = slots[:n_real], dists[:n_real]  # drop bucket pads
        rowids = np.where(
            slots >= 0,
            view.slot_rowids[np.maximum(slots, 0)],
            INVALID_ROW_ID,
        )
        return rowids, dists

    # ------------------------------------------------------------------ #
    # delete / vacuum (Coordinator.cpp:176-224, :353-368)

    def delete(self, rowids: Sequence[int]) -> int:
        """Delete rows. Eagerly unlinks back-edges from each deleted node's
        neighbors (diskAnnDelete, vectordiskann.c:1626-1700); edges *into*
        the deleted node from elsewhere become zombies filtered by the valid
        mask at search time. Returns the number of rows actually deleted —
        missing rowids are skipped silently (vectordiskann.c:1646-1650)."""
        self._check_mutable()
        rowids = [int(r) for r in rowids]
        # Dedup preserving order: a rowid listed twice in one batch is one
        # delete (the second occurrence is a skip like any missing row —
        # without this, the second free() pops an unmapped rowid).
        seen: set[int] = set()
        present = [
            r
            for r in rowids
            if r in self.allocator.rowid_to_slot
            and not (r in seen or seen.add(r))
        ]
        if not present:
            return 0
        del_slots = np.asarray(
            [self.allocator.rowid_to_slot[r] for r in present], np.int32
        )
        del_set = set(int(s) for s in del_slots)

        # Back-edge unlink + connectivity repair: each deleted node's
        # neighbors drop their edge to it AND inherit its remaining
        # out-edges as prune candidates (the FreshDiskANN-style local repair
        # the V2 design defers to merge time, Consolidated Proposal:171-186;
        # libSQL only unlinks, vectordiskann.c:1666-1686, and relies on a
        # random entry point to paper over lost in-links).
        #
        # Batched: ALL (target, deleted) repair pairs of the delete batch
        # are grouped with numpy (no per-node Python loops); round r repairs
        # each target against its r-th adjacent deleted node with ONE fused
        # RobustPrune + neighbor write over every target in the round —
        # round count = max adjacency multiplicity (1 for almost all rows),
        # so a 1k-row delete costs one or two device dispatches, vs one per
        # deleted row in round 1 (the paper's per-row delete is ~45 ms,
        # Table IV; see bench.py delete_ms_per_row).
        from .builder import (
            delete_repair_round,
            delete_repair_round_nodonate,
            delete_repair_scan,
            delete_repair_scan_nodonate,
            group_repair_rounds,
            plan_delete_repair,
        )

        repair_fn = (
            delete_repair_round
            if self.donate_buffers
            else delete_repair_round_nodonate
        )
        scan_fn = (
            delete_repair_scan
            if self.donate_buffers
            else delete_repair_scan_nodonate
        )

        R = self.params.r
        nbr_rows = np.asarray(self.arrays.neighbors[jnp.asarray(del_slots)])
        Dn = len(del_slots)
        # Deleted-slot mask, padded for compile reuse across batches.
        dpad = _pow2_at_least(Dn, 256)
        del_pad = np.full(dpad, -1, np.int32)
        del_pad[:Dn] = del_slots
        del_dev = jnp.asarray(del_pad)
        rounds, rescue_plan = plan_delete_repair(nbr_rows, del_slots, R)
        for kind, t_pad, extra in group_repair_rounds(rounds):
            # Fused donated dispatches: gather current neighbors + mask
            # deleted + RobustPrune + write, never duplicating the graph
            # arrays in HBM. Equal-width round runs (the multiplicity
            # tail) are lax.scan'ed into one dispatch — same op order,
            # ~90 dispatches -> <10 for a 1k-row delete.
            step = repair_fn if kind == "one" else scan_fn
            self.arrays = step(
                self.arrays,
                jnp.asarray(t_pad),
                jnp.asarray(extra),
                del_dev,
                params=self.params,
            )

        # Tombstone + unmap + enqueue (EnqueueDeletion + FreeNode).
        del_idx = jnp.asarray(del_slots)
        self._ever_tombstoned = True  # searches now pay the validity gather
        self.arrays = self.arrays._replace(
            valid=self.arrays.valid.at[del_idx].set(False),
            dirty_rows=self.arrays.dirty_rows.at[del_idx].set(True),
        )

        # Orphan rescue (in-link guarantee at delete time): after the
        # repair rounds and tombstoning, any affected node left with ZERO
        # in-links is force-linked from its nearest live ex-sibling —
        # otherwise it is permanently unreachable (the reference inherits
        # this from libSQL's unlink-only delete, vectordiskann.c:1666-1686).
        if rescue_plan is not None:
            from .builder import (
                refresh_edge_codes,
                refresh_edge_codes_nodonate,
                rescue_orphans_round,
                rescue_orphans_round_nodonate,
            )

            rescue_fn = (
                rescue_orphans_round
                if self.donate_buffers
                else rescue_orphans_round_nodonate
            )
            refresh_fn = (
                refresh_edge_codes
                if self.donate_buffers
                else refresh_edge_codes_nodonate
            )

            t_pad, sibs = rescue_plan
            self.arrays, adopters = rescue_fn(
                self.arrays,
                jnp.asarray(t_pad),
                jnp.asarray(sibs),
                del_dev,
                params=self.params,
            )
            self.arrays = refresh_fn(
                self.arrays, adopters, params=self.params
            )

        for r in present:
            self.allocator.free(r)
        # Copy-on-write: live ReadViews keep the pre-mutation table.
        sr = self._slot_rowids.copy()
        sr[del_slots] = INVALID_ROW_ID
        self._slot_rowids = sr
        if self.shadow_service is not None:
            self.shadow_service.log_delete_batch(present)

        # Entry-point fallback (HandleNodeDeletion, GraphManager.cpp:476-487).
        # The reference re-selects a *random* node (:564-621); we pin a
        # deterministic, connectivity-aware choice: the live slot with the
        # most live out-neighbors, ties to the smallest slot — same recovery
        # behavior, reproducible results.
        if self.entry_slot in del_set:
            self.entry_slot, self.entry_rowid = self._select_fallback_entry()
        self.dirty = True
        self._needs_reachability_repair = True
        return len(present)

    def _pick_adaptive(
        self,
        view: ReadView,
        q_dev: "jnp.ndarray",
        s_count: int,
        seed_sample: int,
        l_search: int,
    ) -> "jnp.ndarray":
        """Per-query adaptive seeds i32[B, S]: nearest of a stratified live
        sample (searcher.pick_adaptive_seeds)."""
        from .searcher import pick_adaptive_seeds

        cap = view.arrays.capacity
        live = np.nonzero(view.slot_rowids[:cap] != INVALID_ROW_ID)[0]
        m = max(min(seed_sample, len(live)), 1)
        # Even coverage over the WHOLE live range: live[(i*len)//m] — a
        # fixed-stride slice (len//m) leaves the insertion-order tail
        # (whole clusters, on clustered corpora) permanently unsampled.
        sample = live[(np.arange(m, dtype=np.int64) * len(live)) // m].astype(
            np.int32
        )
        return pick_adaptive_seeds(
            view.arrays.vectors,
            q_dev,
            jnp.asarray(sample),
            metric=self.params.metric,
            s_count=max(1, min(s_count, len(sample), l_search)),
        )

    def _seed_slots(self, n_seeds: int) -> np.ndarray:
        """Pinned seed set for multi-seed search: the entry point plus
        (n-1) live slots stratified over insertion order — the deterministic
        analog of libSQL's random start row (vectordiskann.c:1450),
        recovering regions weakly connected to any single entry point."""
        if n_seeds <= 1:
            return np.asarray([self.entry_slot], np.int32)
        live = sorted(self.allocator.slot_to_rowid)
        if not live:
            return np.asarray([self.entry_slot], np.int32)
        picks = [self.entry_slot]
        step = max(len(live) // n_seeds, 1)
        for i in range(n_seeds - 1):
            picks.append(live[(i * step + step // 2) % len(live)])
        return np.asarray(picks, np.int32)

    def set_entry_to_medoid(self) -> None:
        """Move the entry point to the medoid (closest live node to the
        dataset mean) — the classic DiskANN entry choice, improving
        long-range navigability over first-inserted-node. The reference
        keeps first-node/random entry (GraphManager.cpp:118-121, :564-621);
        medoid is a strict quality improvement and stays deterministic."""
        if self.count == 0:
            return
        import jax.numpy as jnp

        valid = self.arrays.valid
        vecs = self.arrays.vectors.astype(jnp.float32)
        cnt = jnp.maximum(jnp.sum(valid), 1)
        mean = jnp.sum(
            jnp.where(valid[:, None], vecs, 0.0), axis=0
        ) / cnt.astype(jnp.float32)
        d = jnp.sum((vecs - mean[None, :]) ** 2, axis=-1)
        d = jnp.where(valid, d, jnp.inf)
        slot = int(jnp.argmin(d))
        if slot in self.allocator.slot_to_rowid:
            self.entry_slot = slot
            self.entry_rowid = self.allocator.slot_to_rowid[slot]

    def _select_fallback_entry(self) -> tuple[int, int]:
        """Deterministic entry re-selection after the entry point dies
        (builder.select_fallback_entry, shared with the sharded engine)."""
        from .builder import select_fallback_entry

        return select_fallback_entry(
            self.allocator.slot_to_rowid,
            np.asarray(self.arrays.neighbors),
            np.asarray(self.arrays.valid),
        )

    def update(self, rowid: int, vector: np.ndarray) -> None:
        """Update = delete + re-insert (Coordinator::Update, :226-237)."""
        self._check_mutable()
        self.delete([rowid])
        self.insert([rowid], np.atleast_2d(vector))

    def vacuum(self) -> int:
        """PerformVacuum -> ProcessDeletionQueue (Coordinator.cpp:353-368):
        recycle tombstoned slots into the free list, then repair
        reachability (merge-time graph hygiene, the V2 design's compaction
        duty, Consolidated Proposal:171-186). Returns slots recycled."""
        self._check_mutable()
        recycled = self.allocator.process_deletion_queue()
        self.dirty = self.dirty or bool(recycled)
        # Reachability repair only when the graph mutated since the last
        # repair: a no-op vacuum on a clean index must not pull the full
        # neighbor table to host for a BFS (≈256 MB at 1M x R=64) while
        # holding the IndexLock.
        if self._needs_reachability_repair:
            self.repair_reachability()
        return len(recycled)

    def repair_reachability(self, max_rounds: int = 8) -> int:
        """Force an in-link for every live node unreachable from the entry
        point. Replace/prune edge maintenance can evict a node's last
        in-link long after its insert-time in-link guarantee fired, and
        whole mutually-linked islands can detach — at small R a bulk build
        can strand several percent of rows this way (the reference inherits
        the same hole from libSQL and papers over it with random entry
        points, vectordiskann.c:1450). Each round: host BFS over live
        out-edges (the verify_graph traversal), one batched beam search
        for the stranded nodes' nearest REACHABLE neighbors (beam search
        only ever returns reachable nodes), one force-link pass; a relinked
        island member exposes its whole island to the next round's BFS, and
        force-eviction can strand a different node, so iterate to a
        fixpoint (bounded). Returns nodes relinked."""
        from .builder import (
            force_edge_lists,
            refresh_edge_codes,
            refresh_edge_codes_nodonate,
        )

        self._check_mutable()
        refresh_fn = (
            refresh_edge_codes
            if self.donate_buffers
            else refresh_edge_codes_nodonate
        )

        if self.count < 2 or self.entry_slot < 0:
            self._needs_reachability_repair = False
            return 0
        from .builder import choose_adopters, reachable_mask

        total = 0
        for _ in range(max_rounds):
            nbrs_h = np.asarray(self.arrays.neighbors)
            valid_h = np.asarray(self.arrays.valid)
            reach = reachable_mask(nbrs_h, valid_h, self.entry_slot)
            orphans = np.nonzero(valid_h & ~reach)[0].astype(np.int32)
            if len(orphans) == 0:
                break
            pad = _pow2_at_least(len(orphans), 64)
            o_pad = np.full(pad, -1, np.int32)
            o_pad[: len(orphans)] = orphans
            o_dev = jnp.asarray(o_pad)
            q = self.arrays.vectors[jnp.maximum(o_dev, 0)].astype(jnp.float32)
            res = beam_search(
                self.arrays,
                q,
                jnp.int32(self.entry_slot),
                params=self.params,
                l_search=max(16, self.params.r),
                k=4,
            )
            adopters = choose_adopters(
                orphans, np.asarray(res.topk_slots), nbrs_h, pad
            )
            n_adopted = int((adopters >= 0).sum())
            if n_adopted == 0:
                break  # no orphan could be adopted; further rounds stall
            total += n_adopted
            a_dev = jnp.asarray(adopters)
            self.arrays = self.arrays._replace(
                neighbors=force_edge_lists(
                    self.arrays.vectors,
                    self.arrays.neighbors,
                    a_dev,
                    jnp.where(a_dev >= 0, o_dev, -1),
                    self.params,
                )[0],
                dirty_rows=self.arrays.dirty_rows.at[
                    jnp.where(a_dev >= 0, a_dev, self.capacity)
                ].set(True, mode="drop"),
            )
            self.arrays = refresh_fn(
                self.arrays, a_dev, params=self.params
            )
            self.dirty = True
        self._needs_reachability_repair = False
        return total

    def handle_commit_drop(self) -> None:
        """HandleCommitDrop (Coordinator.cpp:319-351): drop all state."""
        self.allocator = SlotAllocator()
        self.arrays = make_graph_arrays(self.params, _MIN_CAPACITY)
        self._slot_rowids = np.full(_MIN_CAPACITY, INVALID_ROW_ID, np.int64)
        self.entry_slot = -1
        self.entry_rowid = INVALID_ROW_ID
        self.dirty = False

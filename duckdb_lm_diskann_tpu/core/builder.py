"""Vamana graph construction: batched RobustPrune + batched incremental insert.

JAX re-design of the reference's build path:

  - GraphManager::RobustPrune (GraphManager.cpp:259-378): distance-sort
    candidates, dedup by id, drop self, greedy alpha-filter
    "exists selected r with alpha*d(p,r) < d(node,p) => prune p", cap R.
    Here the O(R^2) scalar loop becomes one batched candidate-vs-candidate
    distance matrix (one batched matmul) plus R masked argmax selection steps
    (SURVEY §7.1 "RobustPrune -> vectorized alpha-prune").
  - GraphManager::AddNode (GraphManager.cpp:65-203): allocate, store vector,
    search for L_insert candidates, RobustPrune, write neighbor list, then
    the reciprocal interconnect pass re-pruning every chosen neighbor with
    the new node as a candidate (:161-200) — the two-pass structure of
    libsql/vectordiskann.c:1571-1606.
  - PhysicalCreateHNSWIndex's parallel bulk build (one task per scheduler
    thread, hnsw_index_physical_create.cpp:231-306) becomes batched insert:
    a whole batch of new nodes searches the pre-batch graph in lock-step,
    prunes in one batched kernel, and reciprocal updates are grouped by
    target and applied as one more batched prune. Batch size 1 reproduces
    the reference's sequential semantics exactly (validated vs the oracle);
    larger batches are the standard batched-Vamana relaxation in which
    same-batch nodes see each other only through the reciprocal pass.

Determinism: candidate order is the pinned (distance, slot) sort; reciprocal
groups are sorted by target slot and candidates by slot, so rebuilding from
the same input stream yields an identical graph on any backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..common.types import EdgeType
from ..ops import topk as topk_ops
from ..ops.distance import batched_all_pairs_distance, pairwise_distance
from ..ops.quantize import encode_int4, encode_int8
from ..ops.ternary import encode_ternary
from .graph import GraphArrays, GraphParams
from .searcher import search_for_initial_candidates

# Python float, not a device array: modules must be import-safe so
# jax.distributed.initialize() can run before any backend init
# (parallel/multihost.py entry path).
INF = float("inf")


@functools.partial(jax.jit, static_argnames=("params",))
def batched_robust_prune(
    arrays: GraphArrays,
    node_vecs: jnp.ndarray,  # f32[T, D]
    cand_slots: jnp.ndarray,  # i32[T, C] candidate node slots (-1 invalid)
    self_slots: jnp.ndarray,  # i32[T] slot of the node being pruned (-1 ok)
    *,
    params: GraphParams,
) -> jnp.ndarray:
    """Vectorized RobustPrune. Returns selected neighbor slots i32[T, R],
    -1 padded, ordered by selection (= ascending distance), matching the
    order the reference writes neighbor ids (GraphManager.cpp:150-152 writes
    final_selected in selection order)."""
    T, C = cand_slots.shape
    R = params.r

    safe = jnp.maximum(cand_slots, 0)
    valid = (
        (cand_slots >= 0)
        & arrays.valid[safe]
        & (cand_slots != self_slots[:, None])
    )
    # Gather in storage dtype (int8 rows cost 1/4 the HBM bandwidth), widen
    # in-register.
    cand_vecs = arrays.vectors[safe].astype(jnp.float32)  # [T, C, D]
    d_node = pairwise_distance(
        node_vecs[:, None, :], cand_vecs, params.prune_metric
    )
    d_node, slot_key = topk_ops.mask_invalid(d_node, cand_slots, valid)

    # Sort by (distance, slot) — GraphManager.cpp:300 — carrying the original
    # candidate index to re-gather vectors afterwards.
    order0 = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (T, C))
    d_sorted, slot_sorted, perm = topk_ops.sort_by_distance_id(
        d_node, slot_key, order0
    )
    # Dedup by slot (duplicates share a distance, hence adjacent) —
    # GraphManager.cpp:302-305.
    d_sorted, slot_sorted = topk_ops.dedup_sorted_ids(d_sorted, slot_sorted)
    vec_sorted = jnp.take_along_axis(cand_vecs, perm[..., None], axis=1)

    ok = slot_sorted >= 0  # [T, C]
    # Candidate-vs-candidate distances: one batched matmul.
    d_pair = batched_all_pairs_distance(vec_sorted, params.prune_metric)  # [T,C,C]

    def step(s, state):
        pruned, selected, sel_idx = state
        avail = ok & ~pruned & ~selected  # [T, C]
        has = jnp.any(avail, axis=-1)  # [T]
        first = jnp.argmax(avail, axis=-1)  # [T] first in sorted order
        sel_idx = sel_idx.at[:, s].set(
            jnp.where(has, first.astype(jnp.int32), -1)
        )
        onehot = jax.nn.one_hot(first, C, dtype=jnp.bool_) & has[:, None]
        selected = selected | onehot
        # alpha * d(p, r_new) < d(node, p)  => prune p
        # (GraphManager.cpp:357-361, strict '<').
        d_row = jnp.take_along_axis(d_pair, first[:, None, None], axis=1)[:, 0, :]
        pruned = pruned | (
            (params.alpha * d_row < d_sorted) & has[:, None]
        )
        return pruned, selected, sel_idx

    init = (
        ~ok,  # invalid candidates start pruned
        jnp.zeros((T, C), jnp.bool_),
        jnp.full((T, R), -1, jnp.int32),
    )
    _, _, sel_idx = jax.lax.fori_loop(0, R, step, init)

    sel_ok = sel_idx >= 0
    sel_slots = jnp.take_along_axis(
        slot_sorted, jnp.maximum(sel_idx, 0), axis=1
    )
    return jnp.where(sel_ok, sel_slots, -1)


@functools.partial(jax.jit, static_argnames=("params",))
def write_neighbor_rows(
    arrays: GraphArrays,
    target_slots: jnp.ndarray,  # i32[T] (-1 rows are dropped)
    nbr_slots: jnp.ndarray,  # i32[T, R] (-1 padded)
    *,
    params: GraphParams,
) -> GraphArrays:
    """Set the neighbor list + cached edge codes of each target row — the
    analog of writing a node block's id array and compressed-edge planes
    (GraphNode accessors + the edge-compression write path the reference
    stubs at GraphManager.cpp:402-444, implemented here for real)."""
    C = arrays.capacity
    # Out-of-range index + mode='drop' skips padded targets (-1 would wrap).
    tgt = jnp.where(target_slots >= 0, target_slots, C)

    nbr_ok = nbr_slots >= 0
    safe_nbr = jnp.maximum(nbr_slots, 0)
    nbr_vecs = arrays.vectors[safe_nbr].astype(jnp.float32)  # [T, R, D]

    new = {
        "neighbors": arrays.neighbors.at[tgt].set(nbr_slots, mode="drop"),
        "dirty_rows": arrays.dirty_rows.at[tgt].set(True, mode="drop"),
    }
    et = params.edge_type
    if et is EdgeType.TERNARY:
        pos, neg = encode_ternary(nbr_vecs)  # [T, R, W]
        zero = jnp.uint32(0)
        pos = jnp.where(nbr_ok[..., None], pos, zero)
        neg = jnp.where(nbr_ok[..., None], neg, zero)
        new["edge_pos"] = arrays.edge_pos.at[tgt].set(pos, mode="drop")
        new["edge_neg"] = arrays.edge_neg.at[tgt].set(neg, mode="drop")
    elif et is EdgeType.INT8:
        codes, scale = encode_int8(nbr_vecs)  # [T, R, D], [T, R]
        codes = jnp.where(nbr_ok[..., None], codes, jnp.int8(0))
        scale = jnp.where(nbr_ok, scale, 0.0)
        new["edge_i8"] = arrays.edge_i8.at[tgt].set(codes, mode="drop")
        new["edge_scale"] = arrays.edge_scale.at[tgt].set(scale, mode="drop")
    elif et is EdgeType.INT4:
        codes, scale = encode_int4(nbr_vecs)  # planar u32 [T, R, Dw], [T, R]
        codes = jnp.where(nbr_ok[..., None], codes, jnp.uint32(0))
        scale = jnp.where(nbr_ok, scale, 0.0)
        new["edge_i4"] = arrays.edge_i4.at[tgt].set(codes, mode="drop")
        new["edge_scale"] = arrays.edge_scale.at[tgt].set(scale, mode="drop")
    elif et is EdgeType.FLOAT32:
        vecs = jnp.where(nbr_ok[..., None], nbr_vecs, 0.0)
        new["edge_f32"] = arrays.edge_f32.at[tgt].set(vecs, mode="drop")
    elif et is EdgeType.FLOAT16:
        vecs = jnp.where(nbr_ok[..., None], nbr_vecs, 0.0).astype(jnp.float16)
        new["edge_f32"] = arrays.edge_f32.at[tgt].set(vecs, mode="drop")
    elif et is EdgeType.FLOAT1BIT:
        # libSQL FLOAT1BIT: one sign bit per dimension (lm_diskann.hpp:61).
        # The sign plane equals TERNARY's positive plane (bit set iff v > 0).
        pos, _ = encode_ternary(nbr_vecs)  # [T, R, W]
        pos = jnp.where(nbr_ok[..., None], pos, jnp.uint32(0))
        new["edge_pos"] = arrays.edge_pos.at[tgt].set(pos, mode="drop")
    # EdgeType.NONE: nothing cached.
    return arrays._replace(**new)


@functools.partial(
    jax.jit, static_argnames=("params",), donate_argnums=(0,)
)
def delete_repair_round(
    arrays: GraphArrays,
    tgt_slots: jnp.ndarray,  # i32[T] repair targets (-1 padded)
    extra_cands: jnp.ndarray,  # i32[T, R] adjacent deleted node's out-edges
    del_slots: jnp.ndarray,  # i32[Dp] slots being deleted (-1 padded)
    *,
    params: GraphParams,
) -> GraphArrays:
    """One fused delete-repair round: for every target (a live neighbor of a
    deleted node) re-prune its CURRENT neighbor list plus the deleted node's
    out-edges, with all deleted slots masked out, and write the result.

    ``arrays`` is donated — at 1M scale an undonated neighbor/edge-cache
    write would briefly double the ~4-9 GB graph state in HBM (the round-2
    bench OOM); donation lets XLA alias the untouched buffers in place."""
    safe_t = jnp.maximum(tgt_slots, 0)
    cur = arrays.neighbors[safe_t]  # [T, R]
    cand = jnp.concatenate([cur, extra_cands], axis=1)  # [T, 2R]
    gone = jnp.any(
        cand[:, :, None] == del_slots[None, None, :], axis=-1
    ) | (cand == tgt_slots[:, None])
    cand = jnp.where(gone, -1, cand)
    sel = batched_robust_prune(
        arrays,
        arrays.vectors[safe_t].astype(jnp.float32),
        cand,
        tgt_slots,
        params=params,
    )
    return write_neighbor_rows(arrays, tgt_slots, sel, params=params)


@functools.partial(
    jax.jit, static_argnames=("params",), donate_argnums=(0,)
)
def delete_repair_scan(
    arrays: GraphArrays,
    tgt_stack: jnp.ndarray,  # i32[G, T] G stacked equal-size rounds
    extra_stack: jnp.ndarray,  # i32[G, T, R]
    del_slots: jnp.ndarray,  # i32[Dp] slots being deleted (-1 padded)
    *,
    params: GraphParams,
) -> GraphArrays:
    """G stacked delete-repair rounds in ONE dispatch: lax.scan carries the
    donated arrays through G sequential delete_repair_round bodies — the
    exact op order of G separate dispatches, minus the per-dispatch host
    round-trip. Motivation (benchmarks/profile_delete.py): round count =
    max adjacency multiplicity, measured 72-99 rounds per 1k-row delete at
    200k nodes, of which ~70 are 256-padded tail rounds whose ~21 ms
    dispatch overhead IS the whole delete budget. All-(-1) padding rounds
    (group size rounded up for compile reuse) are no-ops by the same
    mode="drop" scatter rule that already handles -1-padded targets."""

    def body(arr, xs):
        t, e = xs
        return (
            delete_repair_round.__wrapped__(
                arr, t, e, del_slots, params=params
            ),
            None,
        )

    arrays, _ = jax.lax.scan(body, arrays, (tgt_stack, extra_stack))
    return arrays


def group_repair_rounds(rounds):
    """Host-side dispatch plan for plan_delete_repair's rounds: consecutive
    rounds with the same padded width T are stacked into one scan group
    (("scan", t[G, T], extra[G, T, R]) with G pow2-padded by all-(-1)
    no-op rounds for compile reuse); width-singletons stay per-round
    dispatches (("one", t, extra)) — scanning a lone 32k-wide head round
    would pay pow2 padding in pure compute. Shared by the single-chip
    Coordinator and the row-sharded GlobalShardedIndex so both engines
    batch dispatches identically."""
    out = []
    i = 0
    while i < len(rounds):
        width = len(rounds[i][0])
        j = i
        while j < len(rounds) and len(rounds[j][0]) == width:
            j += 1
        group = rounds[i:j]
        if len(group) == 1:
            out.append(("one",) + group[0])
        else:
            g_pad = _pow2_at_least(len(group), 2)
            r = group[0][1].shape[1]
            t_stack = np.full((g_pad, width), -1, np.int32)
            e_stack = np.full((g_pad, width, r), -1, np.int32)
            for g, (t, e) in enumerate(group):
                t_stack[g] = t
                e_stack[g] = e
            out.append(("scan", t_stack, e_stack))
        i = j
    return out


def inlink_histogram(neighbors, valid, cap: int) -> jnp.ndarray:
    """Global in-link histogram: hist[s] = number of edges into slot s from
    valid source rows (hist has cap+1 bins; the last is the -1 sentinel
    dump). Two implementations behind one call:

      - plain arrays: one scatter-add over the flattened neighbor table;
      - row-sharded arrays (parallel.global_graph.PsumRows, duck-typed via
        ``.local``): each shard histograms its LOCAL rows — edge targets
        are global slot ids already — and a ``psum`` over the mesh axis
        reassembles the exact global histogram. This is the one op that
        blocked DELETE on distributed-built global graphs (the whole-table
        scan below is meaningless on a 1/S-per-device layout).
    """
    local_n = getattr(neighbors, "local", None)
    if local_n is not None:
        flat = local_n.reshape(-1)
        src_ok = jnp.repeat(valid.local, local_n.shape[1])
        cnt = jnp.where(src_ok & (flat >= 0), 1, 0).astype(jnp.int32)
        hist = jnp.zeros((cap + 1,), jnp.int32).at[
            jnp.where(flat >= 0, flat, cap)
        ].add(cnt)
        return jax.lax.psum(hist, neighbors.axis)
    flat = neighbors.reshape(-1)
    src_ok = jnp.repeat(valid, neighbors.shape[1])
    cnt = jnp.where(src_ok & (flat >= 0), 1, 0).astype(jnp.int32)
    return jnp.zeros((cap + 1,), jnp.int32).at[
        jnp.where(flat >= 0, flat, cap)
    ].add(cnt)


@functools.partial(
    jax.jit, static_argnames=("params",), donate_argnums=(0,)
)
def rescue_orphans_round(
    arrays: GraphArrays,
    tgt_slots: jnp.ndarray,  # i32[T] affected nodes (-1 padded, unique)
    sib_slots: jnp.ndarray,  # i32[T, R] each node's ex-sibling candidates
    del_slots: jnp.ndarray,  # i32[Dp] slots being deleted (-1 padded)
    *,
    params: GraphParams,
) -> tuple[GraphArrays, jnp.ndarray]:
    """In-link guarantee for the DELETE path. A node whose only in-links
    came from deleted rows becomes unreachable after repair (the alpha
    prune may reject it at every repaired target) — the reference inherits
    the same failure mode from libSQL's unlink-only delete
    (vectordiskann.c:1666-1686) and papers over it with random entry
    points. Here: count in-links over the whole (valid-source) neighbor
    table with one scatter-add histogram; every affected node with zero
    remaining in-links is force-linked from its nearest live ex-sibling
    (the insert path's in-link guarantee, applied at delete time).

    Returns (arrays, adopters i32[T], deduped) — the caller refreshes the
    adopters' cached edge codes (refresh_edge_codes), mirroring
    insert_batch's deferred refresh; duplicates (two orphans adopted by
    the same node) are masked to -1 so the refresh scatter never hits the
    same row twice (write_neighbor_rows' stated invariant)."""
    cap = arrays.capacity
    T, R = sib_slots.shape

    # Global in-link histogram (valid sources only; deleted rows are
    # already tombstoned valid=False by the caller).
    hist = inlink_histogram(arrays.neighbors, arrays.valid, cap)

    t_ok = (tgt_slots >= 0) & arrays.valid[jnp.maximum(tgt_slots, 0)]
    orphan = t_ok & (hist[jnp.clip(tgt_slots, 0, cap)] == 0)

    # Nearest live, non-deleted, non-self ex-sibling per orphan.
    sib_ok = (sib_slots >= 0) & arrays.valid[jnp.maximum(sib_slots, 0)]
    sib_ok &= ~jnp.any(
        sib_slots[:, :, None] == del_slots[None, None, :], axis=-1
    )
    sib_ok &= sib_slots != tgt_slots[:, None]
    t_vec = arrays.vectors[jnp.maximum(tgt_slots, 0)].astype(jnp.float32)
    s_vec = arrays.vectors[jnp.maximum(sib_slots, 0)].astype(jnp.float32)
    d = jnp.where(
        sib_ok,
        pairwise_distance(t_vec[:, None, :], s_vec, params.prune_metric),
        INF,
    )
    best = jnp.argmin(d, axis=-1)
    has_sib = jnp.any(sib_ok, axis=-1)
    adopter = jnp.where(
        orphan & has_sib,
        jnp.take_along_axis(sib_slots, best[:, None], axis=1)[:, 0],
        -1,
    )

    # Duplicate adopters resolve by rank; orphans are rare, so two rounds
    # cover all realistic multiplicities (later ranks drop, next delete or
    # search-repair gets another chance).
    big = jnp.int32(cap + 1)
    a_key = jnp.where(adopter >= 0, adopter, big)
    a_s, t_s = jax.lax.sort((a_key, jnp.where(adopter >= 0, tgt_slots, -1)),
                            num_keys=1)
    rank = _rank_within_group(a_s, big)
    a_s = jnp.where(a_s < big, a_s, -1)

    def force_round(r, nbrs_tbl):
        active = (a_s >= 0) & (rank == r)
        return jax.lax.cond(
            jnp.any(active),
            lambda tbl: force_edge_lists(
                arrays.vectors,
                tbl,
                jnp.where(active, a_s, -1),
                jnp.where(active, t_s, -1),
                params,
            )[0],
            lambda tbl: tbl,
            nbrs_tbl,
        )

    nbrs_tbl = jax.lax.cond(
        jnp.any(adopter >= 0),
        lambda tbl: jax.lax.fori_loop(0, 2, force_round, tbl),
        lambda tbl: tbl,
        arrays.neighbors,
    )
    dirty = jax.lax.cond(
        jnp.any(adopter >= 0),
        lambda dr: dr.at[jnp.where(a_s >= 0, a_s, cap)].set(
            True, mode="drop"
        ),
        lambda dr: dr,
        arrays.dirty_rows,
    )
    # a_s is sorted ascending: mask non-first duplicates for the refresh.
    a_prev = jnp.concatenate([jnp.full_like(a_s[:1], -2), a_s[:-1]])
    a_refresh = jnp.where((a_s != a_prev) & (a_s >= 0), a_s, -1)
    return arrays._replace(neighbors=nbrs_tbl, dirty_rows=dirty), a_refresh


@jax.jit
def store_vectors(
    arrays: GraphArrays, slots: jnp.ndarray, vecs: jnp.ndarray
) -> GraphArrays:
    """Store node vectors + mark slots live (AddNode steps 1-3,
    GraphManager.cpp:73-113, minus the reference's int8 placeholder cast
    quirk — SURVEY Appendix B). Slots < 0 are dropped (shape padding).

    INT8 storage quantizes with round + clamp (identity for genuine
    TINYINT-column data, whose values are already int8-integral); all
    compute then reads the stored values, so search/build/persistence are
    self-consistent."""
    idx = jnp.where(slots >= 0, slots, arrays.capacity)
    if arrays.vectors.dtype == jnp.int8:
        stored = jnp.clip(jnp.round(vecs), -128, 127).astype(jnp.int8)
    else:
        stored = vecs.astype(arrays.vectors.dtype)
    return arrays._replace(
        vectors=arrays.vectors.at[idx].set(stored, mode="drop"),
        valid=arrays.valid.at[idx].set(True, mode="drop"),
        neighbors=arrays.neighbors.at[idx].set(-1, mode="drop"),
        dirty_rows=arrays.dirty_rows.at[idx].set(True, mode="drop"),
    )


def _pow2_at_least(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _rank_within_group(keys: jnp.ndarray, big: jnp.ndarray) -> jnp.ndarray:
    """Given ascending-sorted keys [P] (invalid == big at the tail), return
    each element's 0-based rank within its run of equal keys. Pure device
    code (iota + cummax), no host round-trip."""
    P = keys.shape[0]
    idx = jnp.arange(P, dtype=jnp.int32)
    is_first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), keys[1:] != keys[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_first, idx, 0))
    return idx - run_start


def replace_edge_lists(
    vectors: jnp.ndarray,  # f32[C, D]
    neighbors: jnp.ndarray,  # i32[C, R] the neighbor TABLE
    tgt: jnp.ndarray,  # i32[U] target slots (-1 padded)
    new_c: jnp.ndarray,  # i32[U] ONE new candidate per target
    params: GraphParams,
    compact: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """libSQL's incremental edge insertion, vectorized over U targets,
    operating on the neighbor table only (edge-code refresh happens once
    after all rounds — see insert_step; carrying the multi-GB edge caches
    through the round loop would double-buffer them in HBM):

      diskAnnReplaceEdgeIdx (vectordiskann.c:1176-1224):
        - if the candidate is already an edge, overwrite in place
          (zombie-edge dedup, :1202-1205)
        - skip if any existing edge e dominates it:
          d(t,c) > alpha * d(e,c)  (:1211-1213)
        - insert into the first empty slot, else replace the edge
          maximizing d(t,e) among those with d(t,e) > d(t,c) (:1215-1222)
      diskAnnPruneEdges (vectordiskann.c:1229-1280):
        - after inserting c, evict edges e with d(t,e) > alpha * d(c,e)

    This maintenance is MONOTONE: it never shrinks a neighbor list except
    by domination. The C++ core's reciprocal full re-prune
    (GraphManager.cpp:161-200, self-described as a "basic placeholder")
    re-derives the alpha-stable set on every touch, which at scale erodes
    degrees and disconnects the graph — measured 54% reachability at 50k
    nodes vs 99%+ with this rule.

    Distances use prune_metric (non-negative; see GraphParams.prune_metric).
    Tie-break for the replacement slot: first (lowest index) maximal d(t,e).
    Returns (updated neighbor table, accepted mask [U], written slot [U]).

    ``compact``: left-pack the list after eviction (libSQL's
    nodeBinDeleteEdge contiguity — the sequential/parity behavior). The
    batched build passes False: holes stay in place (every consumer masks
    on ``nbr >= 0``), which keeps the written slot index stable so the
    caller can write the ONE new cached edge code directly instead of
    re-encoding the target's whole R-row — the dominant cost of the
    reciprocal pass at bulk-build scale. The edge SET is identical either
    way; only slot layout differs (and with it, rare exact-tie eviction
    choices, which the batched path — already a documented relaxation —
    does not pin).
    """
    R = params.r
    valid_t = (tgt >= 0) & (new_c >= 0) & (tgt != new_c)
    t_safe = jnp.maximum(tgt, 0)
    c_safe = jnp.maximum(new_c, 0)
    t_vec = vectors[t_safe].astype(jnp.float32)  # [U, D]
    c_vec = vectors[c_safe].astype(jnp.float32)  # [U, D]
    nbr = neighbors[t_safe]  # [U, R]
    present = nbr >= 0
    nbr_vecs = vectors[jnp.maximum(nbr, 0)].astype(jnp.float32)  # [U, R, D]

    pm = params.prune_metric
    d_tc = pairwise_distance(t_vec, c_vec, pm)  # [U]
    d_te = jnp.where(
        present, pairwise_distance(t_vec[:, None, :], nbr_vecs, pm), INF
    )  # [U, R]
    d_ec = jnp.where(
        present, pairwise_distance(c_vec[:, None, :], nbr_vecs, pm), INF
    )  # [U, R]

    already = jnp.any(nbr == new_c[:, None], axis=-1)
    already_idx = jnp.argmax(nbr == new_c[:, None], axis=-1)
    dominated = jnp.any(present & (d_tc[:, None] > params.alpha * d_ec), axis=-1)
    empty = ~present
    has_empty = jnp.any(empty, axis=-1)
    first_empty = jnp.argmax(empty, axis=-1)
    repl_ok = present & (d_te > d_tc[:, None])
    repl_has = jnp.any(repl_ok, axis=-1)
    repl_idx = jnp.argmax(jnp.where(repl_ok, d_te, -INF), axis=-1)

    slot = jnp.where(
        already,
        already_idx,
        jnp.where(has_empty, first_empty, repl_idx),
    ).astype(jnp.int32)
    do = valid_t & (already | (~dominated & (has_empty | repl_has)))

    cols = jnp.arange(R, dtype=jnp.int32)[None, :]
    at_slot = cols == slot[:, None]
    evict = (
        present
        & ~at_slot
        & (d_te > params.alpha * d_ec)
        & do[:, None]
    )
    new_nbr = jnp.where(evict, -1, nbr)
    new_nbr = jnp.where(at_slot & do[:, None], new_c[:, None], new_nbr)

    if compact:
        # Compact: libSQL's nodeBinDeleteEdge keeps edges contiguous
        # (vectordiskann.c); stable left-pack preserving order.
        empty_key = (new_nbr < 0).astype(jnp.int32)
        pos_key = jnp.broadcast_to(cols, new_nbr.shape)
        _, _, new_nbr = jax.lax.sort(
            (empty_key, pos_key, new_nbr), dimension=-1, num_keys=2
        )

    write_tgt = jnp.where(do, tgt, neighbors.shape[0])
    neighbors = neighbors.at[write_tgt].set(new_nbr, mode="drop")
    return neighbors, do, slot


def force_edge_lists(
    vectors: jnp.ndarray,  # f32[C, D]
    neighbors: jnp.ndarray,  # i32[C, R]
    tgt: jnp.ndarray,  # i32[U] (-1 padded)
    new_c: jnp.ndarray,  # i32[U]
    params: GraphParams,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unconditional edge insertion: first empty slot, else replace the
    farthest edge. Used as the in-link guarantee for nodes every regular
    replace/prune target rejected (dense regions can reject a newcomer at
    all of its visited nodes, leaving it with zero in-links — permanently
    unreachable; the reference inherits this failure mode from libSQL and
    papers over it with random entry points). Neighbor-table level, like
    replace_edge_lists. Returns (table, written slot [U], applied [U])."""
    R = params.r
    valid_t = (tgt >= 0) & (new_c >= 0) & (tgt != new_c)
    t_safe = jnp.maximum(tgt, 0)
    nbr = neighbors[t_safe]
    present = nbr >= 0
    already = jnp.any(nbr == new_c[:, None], axis=-1)
    nbr_vecs = vectors[jnp.maximum(nbr, 0)].astype(jnp.float32)
    d_te = jnp.where(
        present,
        pairwise_distance(
            vectors[t_safe].astype(jnp.float32)[:, None, :],
            nbr_vecs,
            params.prune_metric,
        ),
        -INF,
    )
    empty = ~present
    has_empty = jnp.any(empty, axis=-1)
    first_empty = jnp.argmax(empty, axis=-1)
    worst = jnp.argmax(d_te, axis=-1)
    slot = jnp.where(has_empty, first_empty, worst).astype(jnp.int32)
    do = valid_t & ~already
    cols = jnp.arange(R, dtype=jnp.int32)[None, :]
    new_nbr = jnp.where(
        (cols == slot[:, None]) & do[:, None], new_c[:, None], nbr
    )
    write_tgt = jnp.where(do, tgt, neighbors.shape[0])
    return neighbors.at[write_tgt].set(new_nbr, mode="drop"), slot, do


def write_single_edge_codes(
    arrays: GraphArrays,
    tgts: jnp.ndarray,  # i32[P] target slots (mask off with ok)
    slots: jnp.ndarray,  # i32[P] edge slot within the target's row
    cand_vecs: jnp.ndarray,  # f32[P, D] the new edge's vector
    ok: jnp.ndarray,  # bool[P]
    *,
    params: GraphParams,
) -> GraphArrays:
    """Write ONE cached edge code per (target, slot) pair — the batched
    reciprocal pass's replacement for whole-row refresh (re-encoding all R
    codes of a target when exactly one slot changed was the dominant
    refresh cost). Same encoders as write_neighbor_rows, scattered at
    (target, slot). (t, slot) pairs must be unique within one call — the
    caller applies rounds sequentially."""
    cap = arrays.capacity
    t = jnp.where(ok, tgts, cap)  # row cap = out of bounds -> dropped
    s = jnp.maximum(slots, 0)
    et = params.edge_type
    v = cand_vecs[:, None, :]  # [P, 1, D] (encoders take [T, R, D])
    new = {
        "dirty_rows": arrays.dirty_rows.at[t].set(True, mode="drop"),
    }
    if et is EdgeType.TERNARY:
        pos, neg = encode_ternary(v)
        new["edge_pos"] = arrays.edge_pos.at[t, s].set(pos[:, 0], mode="drop")
        new["edge_neg"] = arrays.edge_neg.at[t, s].set(neg[:, 0], mode="drop")
    elif et is EdgeType.INT8:
        codes, scale = encode_int8(v)
        new["edge_i8"] = arrays.edge_i8.at[t, s].set(codes[:, 0], mode="drop")
        new["edge_scale"] = arrays.edge_scale.at[t, s].set(
            scale[:, 0], mode="drop"
        )
    elif et is EdgeType.INT4:
        codes, scale = encode_int4(v)
        new["edge_i4"] = arrays.edge_i4.at[t, s].set(codes[:, 0], mode="drop")
        new["edge_scale"] = arrays.edge_scale.at[t, s].set(
            scale[:, 0], mode="drop"
        )
    elif et is EdgeType.FLOAT32:
        new["edge_f32"] = arrays.edge_f32.at[t, s].set(
            cand_vecs, mode="drop"
        )
    elif et is EdgeType.FLOAT16:
        new["edge_f32"] = arrays.edge_f32.at[t, s].set(
            cand_vecs.astype(jnp.float16), mode="drop"
        )
    elif et is EdgeType.FLOAT1BIT:
        pos, _ = encode_ternary(v)
        new["edge_pos"] = arrays.edge_pos.at[t, s].set(pos[:, 0], mode="drop")
    # EdgeType.NONE: nothing cached.
    return arrays._replace(**new)


# Reciprocal-pass width for bulk batches: each new node reciprocates with
# its RECIP_K closest visited nodes (res.topk_slots) rather than all of
# them — distant targets overwhelmingly reject the newcomer via the
# domination test (d(t,c) > alpha*d(e,c) with e near c), so all-visited
# reciprocation (vectordiskann.c:1588) spends ~10x the work on rejected
# insertions. Batch size 1 keeps the full visited set for exact
# oracle/libSQL parity. Per-target candidate *caps* proved unsafe in round
# 1 (coverage holes; recall 0.80 -> 0.12) — RECIP_ROUNDS below caps only
# how many same-batch newcomers ONE target accepts, with the in-link
# guarantee as the backstop for the dropped sources.
_RECIP_K = 32
_RECIP_ROUNDS = 8
_FORCE_ROUNDS = 2

# Pair-chunk budget: one reciprocal/refresh step gathers [CH, R, D] f32
# neighbor vectors; cap that at ~256 MB so the compiled program fits HBM
# alongside the index arrays at any (R, D) — at 960d an unchunked 32k-pair
# gather is ~8 GB and the XLA compile itself exceeds the chip.
_PAIR_GATHER_BYTES = 256 * 1024 * 1024


def _pair_chunk(p: int, r: int, d: int) -> int:
    rows = max(_PAIR_GATHER_BYTES // max(r * d * 4, 1), 256)
    ch = 256
    while ch * 2 <= rows:
        ch *= 2
    return min(ch, _pow2_at_least(p))


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "full_visited", "recip_rounds", "all_valid",
        "defer_edge_writes",
    ),
    donate_argnums=(0,),
)
def insert_step(
    arrays: GraphArrays,
    new_slots: jnp.ndarray,  # i32[M] pre-allocated slots (-1 padded)
    new_vecs: jnp.ndarray,  # f32[M, D]
    entry_slot: jnp.ndarray,  # i32[]
    *,
    params: GraphParams,
    full_visited: bool,
    recip_rounds: int,
    all_valid: bool = False,
    defer_edge_writes: bool = False,
):
    """One whole batched insert as a single device program — store vectors,
    candidate search, RobustPrune, neighbor write, reciprocal replace/prune
    rounds, and the orphan in-link guarantee — with zero host round-trips.
    (Round 1 grouped the reciprocal pairs in a Python dict loop and
    dispatched one kernel per round; the host grouping + per-round
    serialization bound the build at ~520 inserts/s.)

    Pass 1 — candidate search with L = L_insert
    (SearchForInitialCandidates, Searcher.cpp:275-294), then RobustPrune
    over the FULL visited set — libSQL's ground-truth rule ("first pass -
    add all visited nodes as potential neighbours", vectordiskann.c:
    1571-1586). The visited set includes the far-away path nodes from the
    entry point, which is what lets the alpha-prune keep long-range edges
    at every distance scale. The search runs on the pre-batch graph: new
    slots are unreachable.

    Pass 2 — reciprocal interconnect (vectordiskann.c:1588-1606) with
    libSQL's replace/prune edge insertion, applied per target. Duplicate
    targets are resolved by on-device rank-within-group (sort by
    (target, source) + cummax): round r applies each target's r-th
    candidate, so within a round targets are unique and pairs commute;
    ranks beyond ``recip_rounds`` are dropped (the target already accepted
    that many same-batch in-links). Candidate order per target is ascending
    source slot — deterministic on every backend.

    The arrays argument is DONATED: at 1M x R=64 x 128d the edge cache
    alone is ~8 GB, and functional updates without donation would double
    the HBM footprint.
    """
    M = new_slots.shape[0]
    arrays = store_vectors(arrays, new_slots, new_vecs)
    res = search_for_initial_candidates(
        arrays,
        new_vecs,
        entry_slot,
        params=params,
        l_insert=params.l_insert,
        # Batched builds amortize the per-hop fixed cost over W visits; the
        # sequential (full_visited) path pins width 1 so batch-1 inserts
        # keep exact libSQL visit-order parity.
        beam_width=1 if full_visited else params.insert_beam_width,
        # new slots are unreachable during this search (edges to them are
        # written below), so the caller's no-tombstones assertion holds.
        assume_all_valid=all_valid,
    )
    sel = batched_robust_prune(
        arrays, new_vecs, res.visited_slots, new_slots, params=params
    )
    # Padded rows carry slot -1 -> dropped by write_neighbor_rows.
    arrays = write_neighbor_rows(arrays, new_slots, sel, params=params)

    # --- reciprocal pairs ---
    if full_visited:
        recip = res.visited_slots  # [M, V] (sequential/libSQL parity)
    else:
        recip = res.topk_slots[:, : min(_RECIP_K, params.l_insert)]
    K = recip.shape[1]
    src = jnp.repeat(new_slots, K)  # [P]
    tgt = recip.reshape(-1)  # [P]
    ok = (tgt >= 0) & (src >= 0) & (tgt != src)
    big = jnp.int32(arrays.capacity + 1)
    tgt_key = jnp.where(ok, tgt, big)
    tgt_s, src_s = jax.lax.sort((tgt_key, src), num_keys=2)
    rank = _rank_within_group(tgt_s, big)
    pair_ok = tgt_s < big
    tgt_s = jnp.where(pair_ok, tgt_s, -1)
    src_s = jnp.where(pair_ok, src_s, -1)
    if not full_visited:
        # Rank-major pair layout: round r's active pairs become one
        # CONTIGUOUS range, so the round loop's lax.cond skips every
        # (round, chunk) combo outside it — in target-major order rank-1+
        # pairs are sprinkled across ALL chunks and every round touches
        # every chunk's [CH, R, D] neighbor gather. Pure scheduling:
        # within a round targets are unique and updates commute, so
        # results are bit-identical. (The sequential/parity path keeps
        # target-major order — its refresh dedup relies on duplicate
        # targets being adjacent.)
        bigr = jnp.int32(2**30)
        rkey = jnp.where(pair_ok, rank, bigr)
        rkey, tgt_s, src_s = jax.lax.sort(
            (rkey, tgt_s, src_s), num_keys=2
        )
        pair_ok = rkey < bigr
        rank = jnp.where(pair_ok, rkey, -1)
        tgt_s = jnp.where(pair_ok, tgt_s, -1)
        src_s = jnp.where(pair_ok, src_s, -1)

    # The round loops carry ONLY (neighbor table, acceptance) — carrying the
    # full arrays pytree would make XLA double-buffer the multi-GB edge
    # caches across loop iterations (OOM at 1M x R=64 x 128d). Edge codes of
    # every touched target are refreshed once afterwards (see insert_batch),
    # which also encodes each target once instead of once per round. Pairs
    # are processed in fixed-size chunks so the per-step neighbor-vector
    # gather stays bounded at any dimensionality (at 960d an unchunked 32k
    # pair gather is ~8 GB and the XLA compile itself exceeds HBM).
    cap = arrays.capacity
    accepted0 = jnp.zeros((cap + 1,), jnp.int32)
    # Per-target "neighbor list actually changed" mark (row cap = scratch
    # for masked writes): the deferred edge-code refresh re-encodes ONLY
    # changed targets — replace_edge_lists rejects ~half its candidates
    # (domination/full-list), and refreshing a rejected target is an
    # expensive no-op ([CH, R, D] gather + encode per chunk).
    changed0 = jnp.zeros((cap + 1,), jnp.bool_)
    vectors = arrays.vectors

    P = tgt_s.shape[0]
    CH = _pair_chunk(P, params.r, params.dims)
    nch = (P + CH - 1) // CH
    pad_p = nch * CH - P
    if pad_p:
        tgt_s = jnp.pad(tgt_s, (0, pad_p), constant_values=-1)
        src_s = jnp.pad(src_s, (0, pad_p), constant_values=-1)
        rank = jnp.pad(rank, (0, pad_p), constant_values=-1)
        pair_ok = jnp.pad(pair_ok, (0, pad_p), constant_values=False)

    def recip_step(i, carry):
        nbrs_tbl, accepted, changed, pairslot = carry
        r = i // nch
        c = i % nch

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, c * CH, CH)

        active = sl(pair_ok) & (sl(rank) == r)

        # Ranks are per-target in-link counts: most targets accept one or
        # two same-batch newcomers, so rounds >= 2 are nearly empty — and
        # lax.cond executes only the taken branch, so an inactive
        # (round, chunk) combo skips its [CH, R, D] neighbor-vector
        # gathers entirely instead of computing a fully-masked no-op.
        def do_step(carry):
            nbrs_tbl, accepted, changed, pairslot = carry
            t_r = jnp.where(active, sl(tgt_s), -1)
            c_r = jnp.where(active, sl(src_s), -1)
            nbrs_tbl, do, w_slot = replace_edge_lists(
                vectors, nbrs_tbl, t_r, c_r, params,
                # Sequential/parity inserts keep libSQL's left-packed
                # lists; batched builds keep holes in place so the written
                # slot stays valid for the single-edge code write below.
                compact=full_visited,
            )
            at = jnp.where(do & (c_r >= 0), c_r, cap)
            accepted = accepted.at[at].max(jnp.ones_like(at))
            changed = changed.at[jnp.where(do, t_r, cap)].set(True)
            merged = jnp.where(do, w_slot, jax.lax.dynamic_slice_in_dim(
                pairslot, c * CH, CH))
            pairslot = jax.lax.dynamic_update_slice_in_dim(
                pairslot, merged, c * CH, 0
            )
            return nbrs_tbl, accepted, changed, pairslot

        return jax.lax.cond(
            jnp.any(active), do_step, lambda carry: carry,
            (nbrs_tbl, accepted, changed, pairslot),
        )

    pairslot0 = jnp.full((tgt_s.shape[0],), -1, jnp.int32)
    nbrs_tbl, accepted, changed, pairslot = jax.lax.fori_loop(
        0, recip_rounds * nch, recip_step,
        (arrays.neighbors, accepted0, changed0, pairslot0),
    )

    # --- in-link guarantee: force-link rejected newcomers at their nearest
    # selected neighbor (first selection = closest by construction). Dense
    # regions can reject a newcomer at all of its visited nodes, leaving it
    # with zero in-links — permanently unreachable; the reference inherits
    # this failure mode from libSQL and papers over it with random entry
    # points. Duplicate force-targets resolve by the same rank trick.
    acc_new = (accepted[jnp.clip(new_slots, 0, cap)] > 0) | (new_slots < 0)
    nearest = sel[:, 0]
    orphan = (~acc_new) & (nearest >= 0) & (new_slots >= 0)
    t_f = jnp.where(orphan, nearest, big)
    t_fs, c_fs = jax.lax.sort((t_f, new_slots), num_keys=2)
    rank_f = _rank_within_group(t_fs, big)
    f_ok = t_fs < big

    def force_round(r, carry):
        nbrs_tbl, fslot = carry
        active = f_ok & (rank_f == r)

        def do_force(carry):
            nbrs_tbl, fslot = carry
            nbrs_tbl, w_slot, f_do = force_edge_lists(
                vectors,
                nbrs_tbl,
                jnp.where(active, t_fs, -1),
                jnp.where(active, c_fs, -1),
                params,
            )
            fslot = jnp.where(active & f_do, w_slot, fslot)
            return nbrs_tbl, fslot

        return jax.lax.cond(
            jnp.any(active), do_force, lambda c: c, (nbrs_tbl, fslot)
        )

    fslot0 = jnp.full((t_fs.shape[0],), -1, jnp.int32)
    nbrs_tbl, fslot = jax.lax.fori_loop(
        0, min(_FORCE_ROUNDS, M), force_round, (nbrs_tbl, fslot0)
    )
    arrays = arrays._replace(neighbors=nbrs_tbl)

    if not full_visited:
        # Batched path: the neighbor lists kept slot positions stable
        # (compact=False above), so the cached edge codes are patched with
        # ONE write per applied (target, slot) pair — whole-row refresh is
        # only needed on the sequential/parity path. All recip + force
        # writes collapse into a SINGLE deduplicated scatter: sort by
        # (target, slot, application order) and keep each (t, slot)'s LAST
        # write — a slot rewritten by a later round (or by the force pass,
        # which runs after all recip rounds) wins, exactly matching the
        # sequential application order. (One scatter over all rounds in
        # place of one per round.)
        all_t = jnp.concatenate([tgt_s, t_fs])
        all_s = jnp.concatenate([pairslot, fslot])
        all_c = jnp.concatenate([src_s, c_fs])
        all_ok = jnp.concatenate(
            [pair_ok & (pairslot >= 0), f_ok & (fslot >= 0)]
        )
        all_ord = jnp.concatenate([rank, rank_f + recip_rounds])
        t_key = jnp.where(all_ok, all_t, big)
        s_key = jnp.where(all_ok, all_s, 0)
        t_srt, s_srt, _, c_srt = jax.lax.sort(
            (t_key, s_key, all_ord, all_c), num_keys=3
        )
        same = (t_srt[1:] == t_srt[:-1]) & (s_srt[1:] == s_srt[:-1])
        is_last = jnp.concatenate([~same, jnp.ones((1,), jnp.bool_)])
        ok2 = is_last & (t_srt < big)
        if defer_edge_writes:
            # Hand the write plan back for a separate donated dispatch:
            # inside one huge fused program XLA may fail to alias the
            # multi-GB edge-code scatters and materialize temp copies
            # (measured 263 MB over HBM at the 1M headline shape); a
            # standalone donated program aliases them by construction.
            write_plan = (t_srt, s_srt, c_srt, ok2)
        else:
            w_vecs = vectors[jnp.maximum(c_srt, 0)].astype(jnp.float32)
            arrays = write_single_edge_codes(
                arrays, t_srt, s_srt, w_vecs, ok2, params=params
            )
            write_plan = None
    else:
        write_plan = None

    # --- refresh target list (sequential/parity path only: compacted
    # lists shuffle slot positions, so every CHANGED target re-encodes its
    # whole row; the batched path patched codes per-slot above and needs
    # no refresh). tgt_s is sorted by target, so duplicates are adjacent:
    # keep first occurrences (the refresh scatter must never hit the same
    # row twice), keep only targets whose neighbor list a replace round
    # actually rewrote (skipping an unchanged target is bit-identical —
    # its codes already match its neighbors), and COMPACT the survivors to
    # a prefix so the caller's fixed-size refresh chunks can skip
    # all-empty tails via lax.cond (insert_step_fused).
    if full_visited:
        first_t = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), tgt_s[1:] != tgt_s[:-1]]
        ) & pair_ok & changed[jnp.minimum(tgt_s, cap)]
        refresh_key = jnp.where(first_t, tgt_s, big)
        refresh_key = jax.lax.sort(refresh_key)
        refresh_t = jnp.where(refresh_key < big, refresh_key, -1)
        first_f = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), t_fs[1:] != t_fs[:-1]]
        ) & f_ok
        refresh_f = jnp.where(first_f, t_fs, -1)
    else:
        refresh_t = jnp.full_like(tgt_s, -1)
        refresh_f = jnp.full_like(t_fs, -1)
    return arrays, refresh_t, refresh_f, write_plan


@functools.partial(jax.jit, static_argnames=("params",), donate_argnums=(0,))
def apply_edge_writes(
    arrays: GraphArrays,
    tgts: jnp.ndarray,  # i32[P] deduplicated write plan (insert_step)
    slots: jnp.ndarray,  # i32[P]
    cands: jnp.ndarray,  # i32[P] candidate (source) slots
    ok: jnp.ndarray,  # bool[P]
    *,
    params: GraphParams,
) -> GraphArrays:
    """The deferred single-edge code writes as their own donated program:
    donation guarantees the multi-GB edge-code scatters alias in place
    (fused into insert_step at 1M scale, XLA materialized a temp copy and
    overflowed HBM by ~263 MB)."""
    vecs = arrays.vectors[jnp.maximum(cands, 0)].astype(jnp.float32)
    return write_single_edge_codes(
        arrays, tgts, slots, vecs, ok, params=params
    )


apply_edge_writes_nodonate = jax.jit(
    apply_edge_writes.__wrapped__, static_argnames=("params",)
)


@functools.partial(
    jax.jit,
    static_argnames=("params", "full_visited", "recip_rounds", "all_valid"),
    donate_argnums=(0,),
)
def insert_step_fused(
    arrays: GraphArrays,
    new_slots: jnp.ndarray,
    new_vecs: jnp.ndarray,
    entry_slot: jnp.ndarray,
    *,
    params: GraphParams,
    full_visited: bool,
    recip_rounds: int,
    all_valid: bool = False,
):
    """insert_step + the deferred edge-code refresh chunks as ONE device
    program (the construction _global_insert_step already uses per shard).
    A bulk batch is insert_step + ~3-5 refresh dispatches, so fusing
    removes their per-dispatch overhead. The refresh still
    runs in _pair_chunk-bounded pieces INSIDE the program, so the gather
    working set stays bounded; XLA aliases the donated arrays through the
    chain. Graph results are identical to the unfused path (same ops, same
    order)."""
    arrays, refresh_t, refresh_f, write_plan = insert_step.__wrapped__(
        arrays,
        new_slots,
        new_vecs,
        entry_slot,
        params=params,
        full_visited=full_visited,
        recip_rounds=recip_rounds,
        all_valid=all_valid,
        # Batched: the single-edge code writes run as their OWN donated
        # dispatch (apply_edge_writes) — fusing them here overflowed HBM
        # at the 1M headline shape (unaliased scatter temp copies).
        defer_edge_writes=not full_visited,
    )
    CH = _pair_chunk(refresh_t.shape[0], params.r, params.dims)
    for off in range(0, refresh_t.shape[0], CH):
        chunk = refresh_t[off : off + CH]
        # The changed-target list is compacted to a prefix (insert_step):
        # all-empty tail chunks skip their [CH, R, D] gather+encode whole.
        arrays = jax.lax.cond(
            jnp.any(chunk >= 0),
            lambda a, c=chunk: refresh_edge_codes.__wrapped__(
                a, c, params=params
            ),
            lambda a: a,
            arrays,
        )
    arrays = jax.lax.cond(
        jnp.any(refresh_f >= 0),
        lambda a: refresh_edge_codes.__wrapped__(a, refresh_f, params=params),
        lambda a: a,
        arrays,
    )
    return arrays, write_plan


@functools.partial(jax.jit, static_argnames=("params",), donate_argnums=(0,))
def refresh_edge_codes(
    arrays: GraphArrays,
    tgts: jnp.ndarray,  # i32[U] (-1 padded, unique real targets)
    *,
    params: GraphParams,
) -> GraphArrays:
    """Re-encode the cached edge codes of ``tgts`` from their current
    neighbor lists (the deferred second half of the reciprocal pass)."""
    return write_neighbor_rows(
        arrays,
        tgts,
        arrays.neighbors[jnp.maximum(tgts, 0)],
        params=params,
    )


def insert_batch(
    arrays: GraphArrays,
    new_slots: np.ndarray,  # i32[M] pre-allocated slots
    new_vecs: np.ndarray,  # f32[M, D]
    entry_slot: int,
    params: GraphParams,
    pad_to: int | None = None,
    all_valid: bool = False,
    donate: bool = True,
) -> GraphArrays:
    """Insert a batch of nodes into the graph (functional device update).
    Caller owns slot allocation and capacity growth. Thin host shim over
    :func:`insert_step`: pads the batch, picks the reciprocal mode.

    ``pad_to`` pads the batch with masked dummy rows so repeated calls share
    ONE compiled shape (ramp batches during bulk build would otherwise each
    trigger a multi-second XLA compile of the search loop).
    """
    M = len(new_slots)
    # Floor the padded shape at 64 (except the special M==1 parity path):
    # each distinct padded shape is a full XLA compile of the insert
    # program, while the masked dummy rows cost microseconds of device
    # time.
    # Ramp shapes become {1, 64, 128, ..., max_batch} instead of every pow2.
    pad_to = pad_to or _pow2_at_least(M)
    if M > 1:
        pad_to = max(pad_to, 64)
    pad = pad_to - M
    new_slots = np.concatenate(
        [np.asarray(new_slots, np.int32), np.full(pad, -1, np.int32)]
    )
    new_vecs = np.asarray(new_vecs, np.float32)
    if pad:
        new_vecs = np.concatenate(
            [new_vecs, np.broadcast_to(new_vecs[:1], (pad, new_vecs.shape[1]))]
        )
    new_slots_d = jnp.asarray(new_slots, jnp.int32)
    new_vecs_d = jnp.asarray(new_vecs, jnp.float32)
    if entry_slot < 0:
        # First batch bootstrap: node 0 of the batch becomes the entry point
        # with no neighbors (AddNode first-node path, GraphManager.cpp:118-121).
        if M == 1:
            return store_vectors(arrays, new_slots_d, new_vecs_d)
        raise ValueError("first insert into an empty graph must be a single node")
    # Batch 1 keeps sequential/libSQL parity: full visited set, every
    # target applied (visited sets are duplicate-free, so one round covers
    # all pairs).
    full = M == 1
    import os

    fused = donate and os.environ.get("LMD_FUSE_REFRESH", "1") != "0"
    try:
        if fused:
            # One device program per batch: insert + refresh chunks fused
            # (removes ~3-5 per-batch dispatches). Identical graph results.
            arrays, write_plan = insert_step_fused(
                arrays,
                new_slots_d,
                new_vecs_d,
                jnp.int32(entry_slot),
                params=params,
                full_visited=full,
                recip_rounds=1 if full else _RECIP_ROUNDS,
                all_valid=all_valid,
            )
            if write_plan is not None:
                arrays = apply_edge_writes(
                    arrays, *write_plan, params=params
                )
            return arrays
        step_fn = insert_step if donate else insert_step_nodonate
        refresh_fn = (
            refresh_edge_codes if donate else refresh_edge_codes_nodonate
        )
        write_fn = (
            apply_edge_writes if donate else apply_edge_writes_nodonate
        )
        arrays, refresh_t, refresh_f, write_plan = step_fn(
            arrays,
            new_slots_d,
            new_vecs_d,
            jnp.int32(entry_slot),
            params=params,
            full_visited=full,
            recip_rounds=1 if full else _RECIP_ROUNDS,
            all_valid=all_valid,
            defer_edge_writes=not full,
        )
        if write_plan is not None:
            arrays = write_fn(arrays, *write_plan, params=params)
        # Deferred edge-code refresh, in bounded chunks (still zero host
        # syncs: chunk boundaries are static, slices stay on device; each
        # call donates arrays so the update chain is in-place).
        CH = _pair_chunk(refresh_t.shape[0], params.r, params.dims)
        for off in range(0, refresh_t.shape[0], CH):
            arrays = refresh_fn(
                arrays, refresh_t[off : off + CH], params=params
            )
        arrays = refresh_fn(arrays, refresh_f, params=params)
    except Exception as exc:
        # The chain donates its input buffers: once insert_step has run,
        # the caller's handle is dead, and a failure in a LATER step would
        # otherwise leave the coordinator pointing at deleted buffers
        # (bricking it and masking the real error when rollback touches
        # them). Hand the last-good intermediate state back on the
        # exception so the caller can restore a live handle and roll back.
        if not _buffers_deleted(arrays):
            exc.partial_arrays = arrays  # type: ignore[attr-defined]
        raise
    return arrays


# --------------------------------------------------------------------- #
# Non-donating twins (concurrent lock-free reads): while any ReadView is
# live (db adapter reader gate), mutations must NOT reuse the old buffers
# in place — a reader's dispatched search would read freed HBM. The twins
# share the traced bodies via jit(fn.__wrapped__) minus donate_argnums;
# cost = one extra transient copy of the touched arrays during the
# mutation, paid only when reads actually overlap writes.

delete_repair_round_nodonate = jax.jit(
    delete_repair_round.__wrapped__, static_argnames=("params",)
)
delete_repair_scan_nodonate = jax.jit(
    delete_repair_scan.__wrapped__, static_argnames=("params",)
)
rescue_orphans_round_nodonate = jax.jit(
    rescue_orphans_round.__wrapped__, static_argnames=("params",)
)
insert_step_nodonate = jax.jit(
    insert_step.__wrapped__,
    static_argnames=(
        "params", "full_visited", "recip_rounds", "all_valid",
        "defer_edge_writes",
    ),
)
refresh_edge_codes_nodonate = jax.jit(
    refresh_edge_codes.__wrapped__, static_argnames=("params",)
)


def _buffers_deleted(arrays: GraphArrays) -> bool:
    try:
        return bool(arrays.vectors.is_deleted())
    except Exception:  # non-jax.Array leaves (never deleted)
        return False


def build_schedule(n: int, max_batch: int = 1024) -> list[int]:
    """Ramped batch sizes 1,1,2,4,... so early nodes are inserted with
    near-sequential semantics (graph quality) while the bulk of the build
    runs at full batch width."""
    out = []
    b = 1
    remaining = n
    while remaining > 0:
        step = min(b, remaining, max_batch)
        out.append(step)
        remaining -= step
        if b < max_batch:
            b *= 2
    return out


# --------------------------------------------------------------------- #
# Host-side maintenance planning, shared by the single-chip Coordinator
# and the row-sharded GlobalShardedIndex (whose DML is a mirror of the
# Coordinator's with the device calls swapped for sharded twins). Keeping
# the numpy planning here makes the two engines parity-by-construction —
# round 4's review found the first drift (a hardcoded all_valid) in the
# copied version of exactly this logic.


def plan_delete_repair(
    nbr_rows: np.ndarray,  # [Dn, R] each deleted node's out-edges
    del_slots: np.ndarray,  # i32[Dn]
    r: int,
):
    """Group the (target, deleted-node) repair pairs of one delete batch:
    round k repairs each target against its k-th adjacent deleted node
    (round count = max adjacency multiplicity), plus the orphan-rescue
    inputs. Returns (rounds, rescue) where rounds is a list of
    (t_pad i32[P], extra i32[P, R]) and rescue is (t_pad, sibs) or None
    — all pow2>=256 padded for compile reuse."""
    Dn = len(del_slots)
    tgt = nbr_rows.ravel()
    di = np.repeat(np.arange(Dn, dtype=np.int32), r)
    keep = (tgt >= 0) & ~np.isin(tgt, del_slots)
    tgt, di = tgt[keep], di[keep]
    rounds = []
    rescue = None
    if len(tgt):
        order = np.lexsort((di, tgt))
        tgt, di = tgt[order], di[order]
        first = np.concatenate([[True], tgt[1:] != tgt[:-1]])
        starts = np.maximum.accumulate(
            np.where(first, np.arange(len(tgt)), 0)
        )
        ranks = np.arange(len(tgt)) - starts
        for rr in range(int(ranks.max()) + 1):
            m = ranks == rr
            t_r, d_r = tgt[m], di[m]  # unique targets this round
            u = len(t_r)
            pad = _pow2_at_least(u, 256)
            t_pad = np.full(pad, -1, np.int32)
            t_pad[:u] = t_r
            extra = np.full((pad, r), -1, np.int32)
            extra[:u] = nbr_rows[d_r]
            rounds.append((t_pad, extra))
        uniq, uidx = np.unique(tgt, return_index=True)
        upad = _pow2_at_least(len(uniq), 256)
        t_pad = np.full(upad, -1, np.int32)
        t_pad[: len(uniq)] = uniq
        sibs = np.full((upad, r), -1, np.int32)
        sibs[: len(uniq)] = nbr_rows[di[uidx]]
        rescue = (t_pad, sibs)
    return rounds, rescue


def reachable_mask(
    nbrs_h: np.ndarray, valid_h: np.ndarray, entry: int
) -> np.ndarray:
    """Host BFS over live out-edges from the entry point (the
    repair_reachability traversal)."""
    reach = np.zeros(len(valid_h), bool)
    frontier = np.asarray([entry])
    reach[frontier] = True
    while len(frontier):
        nxt = nbrs_h[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = nxt[valid_h[nxt] & ~reach[nxt]]
        nxt = np.unique(nxt)
        reach[nxt] = True
        frontier = nxt
    return reach


def choose_adopters(
    orphans: np.ndarray,  # i32[n]
    tk: np.ndarray,  # i32[n, k] nearest-reachable candidates per orphan
    nbrs_h: np.ndarray,  # [C, R]
    pad: int,
) -> np.ndarray:
    """Adopter choice for orphan rescue: nearest reachable candidate,
    preferring ones with a free neighbor slot (force-link into a full row
    evicts its farthest edge, which can strand a DIFFERENT node and stall
    the fixpoint); distinct adopters per pass, falling back through the
    top-k alternatives on collision."""
    has_free = (nbrs_h < 0).any(axis=1)
    adopters = np.full(pad, -1, np.int32)
    seen: set[int] = set()
    for prefer_free in (True, False):
        for i in range(len(orphans)):
            if adopters[i] >= 0:
                continue
            for s in tk[i]:
                if (
                    s >= 0
                    and s != orphans[i]
                    and int(s) not in seen
                    and (not prefer_free or has_free[s])
                ):
                    adopters[i] = s
                    seen.add(int(s))
                    break
    return adopters


def select_fallback_entry(
    slot_to_rowid: dict, nbrs_h: np.ndarray, valid_h: np.ndarray
) -> tuple[int, int]:
    """Deterministic entry re-selection after the entry point dies: the
    live slot with the most live out-neighbors, ties to the smallest slot
    (the reference re-selects randomly, GraphManager.cpp:564-621)."""
    from ..common.types import INVALID_ROW_ID

    if not slot_to_rowid:
        return -1, INVALID_ROW_ID
    live = np.asarray(sorted(slot_to_rowid), np.int32)
    nbrs = nbrs_h[live]
    degree = ((nbrs >= 0) & valid_h[np.maximum(nbrs, 0)]).sum(axis=1)
    slot = int(live[int(np.argmax(degree))])  # argmax ties -> smallest
    return slot, slot_to_rowid[slot]

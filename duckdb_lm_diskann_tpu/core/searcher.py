"""Batched LM-DiskANN beam search as a single jitted fixed-point loop.

JAX re-design of the reference's search path:

  - core/Searcher.cpp:45-246 (``PerformSearch``): candidate beam + top set +
    visited set, entry-point seed, pop-best loop, final re-rank
  - libsql/vectordiskann.c:1283-1400 (``diskAnnSearchInternal``): the ground
    truth this engine reproduces — per-visited-node *approximate* distances
    to all edges from the in-block compressed vectors (:1370-1396), exact
    distance recomputed only at visit time (:1366-1370). (The C++ Searcher
    computes exact distances during traversal, flagged as a deviation in
    SURVEY Appendix B; that behavior is available here as EdgeType.NONE.)

Re-design, per SURVEY §7.1: pointer-chasing becomes batched frontier
expansion. A whole batch of queries advances in lock-step inside one
``lax.while_loop``; each iteration visits ``beam_width`` nodes per query:

    gather node rows -> score all R cached neighbor codes at once ->
    masked sorted merge into the beam -> dedup via membership masks

The priority queue becomes a (distance, slot)-sorted fixed-size beam; the
per-query early exit becomes a convergence mask; heap pop order becomes the
pinned deterministic tie-break (sort by (distance, slot) — SURVEY §7.3).

``beam_width`` (E): E=1 (default) reproduces the reference's strict
one-visit-per-iteration order exactly (validated against tests/oracle.py,
exact visit-order match). E>1 expands the E closest unvisited candidates
per iteration — the classic DiskANN beam-width generalization — which
amortizes the fixed per-hop cost (gather issue + sort + masks) over E
visits; results remain deterministic under the same tie-break.

Semantics contract (E=1, validated against tests/oracle.py):
  * beam insert-and-evict-worst == diskAnnSearchCtxInsertCandidate
    (vectordiskann.c:1136-1148) under the pinned tie-break
  * "skip if visited or already a candidate" == :1379 via membership masks
  * termination when no unvisited candidate remains == :1325
  * top-k = k best (exact_dist, slot) over *visited* nodes == the
    aTopCandidates buffer (:1091-1110)
  * zombie edges (deleted rows) are skipped via the ``valid`` mask at
    candidate-insertion time; libSQL discovers them at blob-read time
    (:1349-1354) because checking earlier would cost an I/O — on device the
    validity gather is cheap, so we filter eagerly (deviation documented).

Fixed bounds: the loop is capped so at most ``max_visits`` nodes are
visited per query and the visited buffer holds ``max_visits`` entries (XLA
needs static shapes); the cap defaults to 4*L which is far above observed
visit counts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..common.types import EdgeType, MetricType
from ..ops import topk as topk_ops
from ..ops.distance import (
    pairwise_distance,
    similarity_to_distance,
)
from ..ops.quantize import decode_int4
from ..ops.ternary import encode_ternary, ternary_dot
from .graph import GraphArrays, GraphParams

# Python float, not a device array: modules must be import-safe so
# jax.distributed.initialize() can run before any backend init
# (parallel/multihost.py entry path).
INF = float("inf")


class SearchResult(NamedTuple):
    topk_slots: jnp.ndarray  # i32[B, K]  (-1 padded)
    topk_dists: jnp.ndarray  # f32[B, K]  (+inf padded)
    visited_slots: jnp.ndarray  # i32[B, V] in visit order (-1 padded)
    visited_dists: jnp.ndarray  # f32[B, V] exact distances (+inf padded)
    visited_count: jnp.ndarray  # i32[B]
    hops: jnp.ndarray  # i32[] total loop iterations (tracing counter)


class _BeamState(NamedTuple):
    beam_dist: jnp.ndarray  # f32[B, L] sorted by (dist, slot)
    beam_slot: jnp.ndarray  # i32[B, L] -1 = empty
    beam_vis: jnp.ndarray  # bool[B, L]
    seed_vis: jnp.ndarray  # bool[B, S] seed slot has been visited
    vis_slot: jnp.ndarray  # i32[B, V]
    vis_dist: jnp.ndarray  # f32[B, V]
    vis_cnt: jnp.ndarray  # i32[B]
    it: jnp.ndarray  # i32[]


def _score_edges(
    arrays: GraphArrays,
    params: GraphParams,
    cur: jnp.ndarray,  # i32[B, E] current node slots
    queries: jnp.ndarray,  # f32[B, D]
    q_pos: jnp.ndarray,
    q_neg: jnp.ndarray,
    nbrs: jnp.ndarray,  # i32[B, E, R]
) -> jnp.ndarray:
    """Approximate distances [B, E, R] from the visited nodes' cached edge
    codes — the LM-DiskANN property: no second gather for frontier scoring
    (vectordiskann.c:1370-1396).

    Plain jnp gather-then-score forms; XLA fuses each codec's decode and
    distance into the gather's consumer. The reference's per-CPU SIMD
    dispatch (GetDotKernel, ternary_quantization.hpp:562-602) has no
    analog: one expression per codec serves every backend."""
    et = params.edge_type
    if et is EdgeType.TERNARY:
        e_pos = arrays.edge_pos[cur]  # [B, E, R, W]
        e_neg = arrays.edge_neg[cur]
        sim = ternary_dot(
            q_pos[:, None, None, :], q_neg[:, None, None, :], e_pos, e_neg
        ).astype(jnp.float32)
        return similarity_to_distance(sim, params.metric)
    if et is EdgeType.INT8:
        codes = arrays.edge_i8[cur]  # [B, E, R, D]
        scale = arrays.edge_scale[cur]  # [B, E, R]
        vecs = codes.astype(jnp.float32) * scale[..., None]
        return pairwise_distance(queries[:, None, None, :], vecs, params.metric)
    if et is EdgeType.INT4:
        packed = arrays.edge_i4[cur]  # planar u32 [B, E, R, Dw] — half INT8's bytes
        scale = arrays.edge_scale[cur]  # [B, E, R]
        vecs = decode_int4(packed, scale, params.dims)
        return pairwise_distance(queries[:, None, None, :], vecs, params.metric)
    if et is EdgeType.FLOAT32 or et is EdgeType.FLOAT16:
        return pairwise_distance(
            queries[:, None, None, :],
            arrays.edge_f32[cur].astype(jnp.float32),
            params.metric,
        )
    if et is EdgeType.FLOAT1BIT:
        # Binarized signed dot (the distance libSQL's monolithic port left a
        # FIXME, lm_diskann.cpp:900-902): with sign bits qb/vb (bit = v > 0),
        # dot over +/-1 values = D - 2*pop(qb XOR vb). Padding bits are zero
        # in both planes, so XOR over whole words is exact. Cosine-only
        # (vectordiskann.c:518); the monotone 1 - dot map preserves ordering
        # and the final pass re-ranks exactly, same as TERNARY.
        e_pos = arrays.edge_pos[cur]  # [B, E, R, W]
        mismatch = jnp.sum(
            jax.lax.population_count(q_pos[:, None, None, :] ^ e_pos).astype(
                jnp.int32
            ),
            axis=-1,
        )
        sim = (params.dims - 2 * mismatch).astype(jnp.float32)
        return similarity_to_distance(sim, params.metric)
    # EdgeType.NONE: exact traversal — gather the neighbors' own vectors
    # (the C++ Searcher behavior, core/Searcher.cpp:168-173).
    safe_nbrs = jnp.maximum(nbrs, 0)
    vecs = arrays.vectors[safe_nbrs].astype(jnp.float32)  # [B, E, R, D]
    return pairwise_distance(queries[:, None, None, :], vecs, params.metric)


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "l_search", "k", "max_visits", "beam_width",
        "assume_all_valid",
    ),
)
def beam_search(
    arrays: GraphArrays,
    queries: jnp.ndarray,  # f32[B, D]
    entry_slot: jnp.ndarray,  # i32[] or i32[B]
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    max_visits: int = 0,
    beam_width: int = 1,
    allowed: jnp.ndarray | None = None,  # bool[capacity] predicate mask
    assume_all_valid: bool = False,
) -> SearchResult:
    """Batched beam search. Returns top-k and the visited set (the insert
    path consumes visited, Searcher::SearchForInitialCandidates semantics).

    ``allowed`` enables FILTERED search (the V2 design's filtered-search
    plan, Consolidated Proposal:419): traversal routes through every node
    (disallowed nodes still conduct the walk — excluding them would
    disconnect the graph under selective filters), but the final top-k is
    taken over visited AND allowed nodes only. This is the filtered-DiskANN
    recipe, and strictly dominates post-filtering the k results: the
    candidate pool is the full visited set (~max_visits rows), not k.

    ``assume_all_valid`` (static): the caller asserts every edge target is
    a live node — true whenever the index has never tombstoned a slot
    (fresh builds, append-only serving; Coordinator tracks it). The hop
    then skips the neighbor-validity element gather
    ``arrays.valid[nbrs]``: [B*E*R] random element lookups per hop. With
    no invalid slots the mask is the identity, so results are
    bit-identical; with tombstones present callers must pass False and
    pay the gather (zombie-edge filtering, the deviation documented in
    the module docstring)."""
    B = queries.shape[0]
    L = l_search
    E = beam_width
    V = max_visits if max_visits > 0 else params.max_visits
    R = params.r
    queries = queries.astype(jnp.float32)
    # entry_slot: scalar (one shared entry point, the reference behavior),
    # i32[S] — a pinned seed SET shared by all queries — or i32[B, S]
    # PER-QUERY seeds (query-adaptive seeding: the Coordinator picks each
    # query's nearest sampled nodes, so routing starts inside the query's
    # own region — decisive on clustered corpora where a global entry
    # point strands tail clusters). Multi-seeding is the deterministic
    # analog of libSQL drawing a random start row per search
    # (diskAnnSelectRandomShadowRow, vectordiskann.c:1450).
    seeds = jnp.atleast_1d(jnp.asarray(entry_slot, jnp.int32))  # [S]|[B,S]
    S = seeds.shape[-1]
    if S > L:
        raise ValueError("seed count exceeds l_search")

    if params.edge_type in (EdgeType.TERNARY, EdgeType.FLOAT1BIT):
        q_pos, q_neg = encode_ternary(queries)
    else:  # placeholders keep the pytree static
        q_pos = q_neg = jnp.zeros((B, 1), jnp.uint32)

    # --- Seed: entry point(s) with exact distance (vectordiskann.c:1306-1322).
    if seeds.ndim == 2:
        seeds_b = seeds  # [B, S] per-query
        seed_vec = arrays.vectors[jnp.maximum(seeds_b, 0)].astype(
            jnp.float32
        )  # [B, S, D]
        seed_dist = pairwise_distance(
            queries[:, None, :], seed_vec, params.metric
        )  # [B, S]
    else:
        seeds_b = jnp.broadcast_to(seeds[None, :], (B, S))
        seed_vec = arrays.vectors[jnp.maximum(seeds, 0)].astype(jnp.float32)
        seed_dist = pairwise_distance(
            queries[:, None, :], seed_vec[None, :, :], params.metric
        )  # [B, S]
    if assume_all_valid:
        seed_ok = seeds_b >= 0
    else:
        seed_ok = (seeds_b >= 0) & arrays.valid[jnp.maximum(seeds_b, 0)]
    sd, ss = topk_ops.mask_invalid(seed_dist, seeds_b, seed_ok)
    sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    if S > 1:  # duplicate seeds collapse to one beam entry; restore order
        sd, ss = topk_ops.dedup_sorted_ids(sd, ss)
        sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    beam_dist = jnp.concatenate([sd, jnp.full((B, L - S), INF)], axis=-1)
    beam_slot = jnp.concatenate(
        [ss, jnp.full((B, L - S), -1, jnp.int32)], axis=-1
    )
    state = _BeamState(
        beam_dist=beam_dist,
        beam_slot=beam_slot,
        beam_vis=jnp.zeros((B, L), jnp.bool_),
        seed_vis=jnp.zeros((B, S), jnp.bool_),
        vis_slot=jnp.full((B, V), -1, jnp.int32),
        vis_dist=jnp.full((B, V), INF),
        vis_cnt=jnp.zeros((B,), jnp.int32),
        it=jnp.int32(0),
    )

    def has_unvisited(s: _BeamState) -> jnp.ndarray:
        return (~s.beam_vis) & (s.beam_slot >= 0)

    def cond(s: _BeamState) -> jnp.ndarray:
        return jnp.any(has_unvisited(s)) & (s.it * E < V)

    def body(s: _BeamState) -> _BeamState:
        unvis = has_unvisited(s)  # [B, L]
        # The beam is sorted, so the E first unvisited positions are the E
        # closest unvisited candidates
        # (diskAnnSearchCtxFindClosestCandidateIdx, vectordiskann.c:1152-1167).
        pos_key = jnp.where(unvis, jnp.arange(L, dtype=jnp.int32)[None, :], L)
        if E == 1:
            idx_e = jnp.argmax(unvis, axis=-1)[:, None]  # [B, 1]
        else:
            _, idx_e = jax.lax.top_k(-pos_key, E)  # [B, E] smallest positions
            idx_e = idx_e.astype(jnp.int32)
        active_e = jnp.take_along_axis(unvis, idx_e, axis=-1)  # [B, E]
        cur = jnp.take_along_axis(s.beam_slot, idx_e, axis=-1)  # [B, E]
        cur = jnp.where(active_e, cur, 0)

        # Visit: exact distance to each node's full-precision vector
        # (vectordiskann.c:1366-1370).
        node_vec = arrays.vectors[cur].astype(jnp.float32)  # [B, E, D]
        exact = pairwise_distance(queries[:, None, :], node_vec, params.metric)

        # Mark the beam entries visited (scatter-max: inactive lanes write
        # False, a no-op; their idx_e points at position 0 of an all-visited
        # or empty beam either way).
        rows_e = jnp.arange(B, dtype=jnp.int32)[:, None]
        beam_vis = s.beam_vis.at[rows_e, idx_e].max(active_e)
        # Track which SEEDS have been visited (see candidate mask below).
        seed_vis = s.seed_vis | jnp.any(
            (cur[:, :, None] == seeds_b[:, None, :]) & active_e[:, :, None],
            axis=1,
        )

        # Append the E visits to the visited log (disjoint positions
        # vis_cnt, vis_cnt+1, ... for the active ones) as one batched
        # scatter. (A one-hot formulation materializes [B, E, V] masks —
        # ~10 MB of HBM traffic per hop at B=1024, V=4L — where the scatter
        # writes E values per row; inactive lanes get the out-of-bounds
        # position V — dropped, never wrapped: jnp normalizes NEGATIVE
        # indices to size+i, so -1 would clobber the log's last slot.)
        order_e = jnp.cumsum(active_e.astype(jnp.int32), axis=-1) - 1
        pos_e = jnp.where(active_e, s.vis_cnt[:, None] + order_e, V)  # [B,E]
        vis_slot = s.vis_slot.at[rows_e, pos_e].set(cur, mode="drop")
        vis_dist = s.vis_dist.at[rows_e, pos_e].set(exact, mode="drop")
        vis_cnt = s.vis_cnt + jnp.sum(active_e.astype(jnp.int32), axis=-1)

        # Frontier: all R neighbor slots + cached codes of each visited node.
        nbrs = arrays.neighbors[cur]  # [B, E, R]
        if assume_all_valid:
            nbr_live = nbrs >= 0  # the validity gather is the identity
        else:
            nbr_live = (nbrs >= 0) & arrays.valid[jnp.maximum(nbrs, 0)]
        nbr_live = nbr_live & active_e[:, :, None]
        with jax.named_scope("edge_score"):
            edge_dist = _score_edges(
                arrays, params, cur, queries, q_pos, q_neg, nbrs
            )

        nbrs_f = nbrs.reshape(B, E * R)
        live_f = nbr_live.reshape(B, E * R)
        dist_f = edge_dist.reshape(B, E * R)

        # Skip neighbors already in the beam (vectordiskann.c:1379's
        # "already a candidate"). The reference ALSO scans its full visited
        # list there; that scan is redundant for every non-seed node under
        # insert-and-evict-worst: a non-seed's beam key (its cached-code
        # approx distance) is identical on every encounter, the beam's
        # worst (dist, slot) key is monotone non-increasing, so a visited
        # node still good enough to be in the beam IS in the beam (caught
        # here) and one that was evicted re-arrives with the same key and
        # is dropped by the sorted merge again. The ONE exception is the
        # seed set: seeds enter with their EXACT distance
        # (vectordiskann.c:1306-1322) but re-arrive via an edge with their
        # approx distance, which can be lower — so an evicted visited seed
        # could re-enter and be visited twice. Blocking just the visited
        # seeds (O(S), S tiny) replaces the O(B*R*V) visited scan (~50% of
        # hop time at B=1024) result-identically, validated by the oracle
        # visit-order parity suite.
        in_beam = jnp.any(
            (nbrs_f[:, :, None] == s.beam_slot[:, None, :])
            & (s.beam_slot >= 0)[:, None, :],
            axis=-1,
        )
        in_vis_seed = jnp.any(
            (nbrs_f[:, :, None] == seeds_b[:, None, :])
            & seed_vis[:, None, :],
            axis=-1,
        )
        # Edges pointing at this round's own visits: those targets are in
        # the beam (just marked visited), so in_beam covers them too.
        cand_ok = live_f & ~in_beam & ~in_vis_seed
        cand_dist = jnp.where(cand_ok, dist_f, INF)
        cand_slot = jnp.where(cand_ok, nbrs_f, -1)

        # Sorted merge, keep best L: insert-and-evict-worst for the whole
        # edge set at once (vectordiskann.c:1136-1148 + :1077-1088).
        # E > 1: two visited nodes may share a neighbor; the sort-stable
        # dedup inside merge_beams keeps the first occurrence (identical
        # cached-code distance either way) — replacing the O((E*R)^2)
        # pairwise duplicate mask this path used before, which at W=4,
        # B=1024 materialized a 67 MB [B, ER, ER] tensor per hop and made
        # wider beams measure SLOWER than W=1.
        new_dist, new_slot, new_vis = topk_ops.merge_beams(
            s.beam_dist,
            s.beam_slot,
            cand_dist,
            cand_slot,
            L,
            extras_a=(beam_vis.astype(jnp.int32),),
            extras_b=(jnp.zeros_like(cand_slot),),
            dedup=E > 1,
            # E == 1: the beam is sorted and in_beam masked the candidates
            # disjoint -> bitonic fast path.
            a_sorted=E == 1,
            bitonic=params.bitonic,
        )
        # Entries that sorted to +inf are empty; normalize their slot to -1.
        new_slot = jnp.where(jnp.isinf(new_dist), -1, new_slot)

        return _BeamState(
            beam_dist=new_dist,
            beam_slot=new_slot,
            beam_vis=new_vis.astype(jnp.bool_),
            seed_vis=seed_vis,
            vis_slot=vis_slot,
            vis_dist=vis_dist,
            vis_cnt=vis_cnt,
            it=s.it + 1,
        )

    final = jax.lax.while_loop(cond, body, state)

    # Final pass: top-k = k best (exact dist, slot) among visited nodes —
    # the aTopCandidates buffer (vectordiskann.c:1091-1110) / the exact
    # re-rank of Searcher.cpp:189-245 in one deterministic sort. The log
    # is deduped first: a slot CAN be visited twice when a stale cached
    # edge code (zombie in-edge into a vacuum-recycled slot) re-offers an
    # evicted node with a different approx key than its live edges; both
    # visits carry the same exact distance, so duplicates are adjacent
    # after the sort and one truncation-safe mask removes them.
    vis_dist = final.vis_dist
    if allowed is not None:
        ok = allowed[jnp.maximum(final.vis_slot, 0)] & (final.vis_slot >= 0)
        vis_dist = jnp.where(ok, vis_dist, INF)
    sd, ss = topk_ops.sorted_dedup_topk(
        vis_dist, final.vis_slot, bitonic=params.bitonic
    )
    topk_dists, topk_slots = sd[..., :k], ss[..., :k]
    topk_slots = jnp.where(jnp.isinf(topk_dists), -1, topk_slots)
    return SearchResult(
        topk_slots=topk_slots,
        topk_dists=topk_dists,
        visited_slots=final.vis_slot,
        visited_dists=final.vis_dist,
        visited_count=final.vis_cnt,
        hops=final.it,
    )


class StreamSearchResult(NamedTuple):
    topk_slots: jnp.ndarray  # i32[NQ, K] (-1 padded)
    topk_dists: jnp.ndarray  # f32[NQ, K] (+inf padded)
    visited_count: jnp.ndarray  # i32[NQ]
    hops: jnp.ndarray  # i32[] total lock-step iterations


class _StreamState(NamedTuple):
    beam_dist: jnp.ndarray  # f32[B, L]
    beam_slot: jnp.ndarray  # i32[B, L]
    beam_vis: jnp.ndarray  # bool[B, L]
    seed_slots: jnp.ndarray  # i32[B, S] this lane's (sorted) seed set
    seed_vis: jnp.ndarray  # bool[B, S]
    top_dist: jnp.ndarray  # f32[B, K] running exact top-k, sorted
    top_slot: jnp.ndarray  # i32[B, K]
    q_lane: jnp.ndarray  # f32[B, D] lane's current query
    lane_q: jnp.ndarray  # i32[B] query index (-1 = dead lane)
    vis_cnt: jnp.ndarray  # i32[B] visits for the lane's current query
    next_q: jnp.ndarray  # i32[] queue head
    out_slot: jnp.ndarray  # i32[NQ, K]
    out_dist: jnp.ndarray  # f32[NQ, K]
    out_vis: jnp.ndarray  # i32[NQ]
    it: jnp.ndarray  # i32[]


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "l_search", "k", "lanes", "max_visits", "assume_all_valid",
    ),
)
def beam_search_stream(
    arrays: GraphArrays,
    queries: jnp.ndarray,  # f32[NQ, D]
    entry_slot: jnp.ndarray,  # i32[] | i32[S] | i32[NQ, S]
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    lanes: int = 1024,
    max_visits: int = 0,
    allowed: jnp.ndarray | None = None,
    assume_all_valid: bool = False,
) -> StreamSearchResult:
    """Streaming beam search with continuous lane refill — the skew-aware
    dynamic query rebatching of SURVEY §7.3 / BASELINE config #5.

    The lock-step paths (:func:`beam_search` / :func:`beam_search_many`) run
    a whole batch until its SLOWEST query converges: on the clustered HARD
    corpus most lanes of a batch sit idle while the tail converges. Here
    the batch dimension becomes ``lanes`` of a device-resident work queue:
    the moment a lane's beam has no unvisited candidate, the lane writes its
    result and is re-seeded with the next query — all inside one
    ``lax.while_loop``, so total hops ≈ ceil(total_visits / lanes) instead of sum-of-batch-maxima, and the
    per-hop fixed cost of the loop skeleton is amortized over a *full*
    lane array every iteration.

    Per-query traversal is bit-identical to :func:`beam_search` (lane
    packing cannot affect an individual query's beam): same seeding, same
    hop math at E=1, and the final exact re-rank over the visited set
    (vectordiskann.c:1091-1110) is maintained incrementally — each visit's
    (exact_dist, slot) is shift-inserted into a sorted running top-k, with
    a membership guard standing in for the visited-log dedup. Verified
    id-and-distance-exact against beam_search in tests/test_beam_search.py.

    Differences from the batch paths: ``beam_width`` is fixed at 1 (the
    serving width) and per-query visited logs are not returned (the insert
    path, which needs them, has its own stream variant). NQ is a traced
    shape: serving should bucket NQ as usual to bound retraces.
    """
    NQ, D = queries.shape
    B = min(lanes, NQ)
    L = l_search
    V = max_visits if max_visits > 0 else params.max_visits
    R = params.r
    K = k
    queries = queries.astype(jnp.float32)
    ternary_q = params.edge_type in (EdgeType.TERNARY, EdgeType.FLOAT1BIT)

    # ---- Pre-compute every query's seeded beam prefix [NQ, S] (one
    # vectorized pass; identical math to beam_search's seed block).
    seeds = jnp.atleast_1d(jnp.asarray(entry_slot, jnp.int32))
    if seeds.ndim == 2:
        seeds_all = seeds  # [NQ, S] per-query (adaptive seeding)
    else:
        seeds_all = jnp.broadcast_to(seeds[None, :], (NQ, seeds.shape[0]))
    S = seeds_all.shape[-1]
    if S > L:
        raise ValueError("seed count exceeds l_search")
    seed_vec = arrays.vectors[jnp.maximum(seeds_all, 0)].astype(jnp.float32)
    seed_dist = pairwise_distance(queries[:, None, :], seed_vec, params.metric)
    if assume_all_valid:
        seed_ok = seeds_all >= 0
    else:
        seed_ok = (seeds_all >= 0) & arrays.valid[jnp.maximum(seeds_all, 0)]
    sd_all, ss_all = topk_ops.mask_invalid(seed_dist, seeds_all, seed_ok)
    sd_all, ss_all = topk_ops.sort_by_distance_id(sd_all, ss_all)
    if S > 1:
        sd_all, ss_all = topk_ops.dedup_sorted_ids(sd_all, ss_all)
        sd_all, ss_all = topk_ops.sort_by_distance_id(sd_all, ss_all)

    state = _StreamState(
        beam_dist=jnp.full((B, L), INF),
        beam_slot=jnp.full((B, L), -1, jnp.int32),
        beam_vis=jnp.zeros((B, L), jnp.bool_),
        seed_slots=jnp.full((B, S), -1, jnp.int32),
        seed_vis=jnp.zeros((B, S), jnp.bool_),
        top_dist=jnp.full((B, K), INF),
        top_slot=jnp.full((B, K), -1, jnp.int32),
        q_lane=jnp.zeros((B, D), jnp.float32),
        lane_q=jnp.full((B,), -1, jnp.int32),
        vis_cnt=jnp.zeros((B,), jnp.int32),
        next_q=jnp.int32(0),
        out_slot=jnp.full((NQ, K), -1, jnp.int32),
        out_dist=jnp.full((NQ, K), INF),
        out_vis=jnp.zeros((NQ,), jnp.int32),
        it=jnp.int32(0),
    )
    # Generous static cap: perfect packing needs ~NQ*V/B iterations; the
    # slack covers ragged refill tails. The cap never binds in practice
    # (each query's visits are bounded by V).
    max_iters = (NQ * V) // B + 2 * V + 8

    def cond(s: _StreamState) -> jnp.ndarray:
        return ((s.next_q < NQ) | jnp.any(s.lane_q >= 0)) & (s.it < max_iters)

    def body(s: _StreamState) -> _StreamState:
        rows = jnp.arange(B, dtype=jnp.int32)
        unvis = (~s.beam_vis) & (s.beam_slot >= 0)  # [B, L]
        needs = ~jnp.any(unvis, axis=-1)  # [B] converged or idle lanes

        # -- Finalize: converged live lanes write their running top-k.
        fin = needs & (s.lane_q >= 0)
        w = jnp.where(fin, s.lane_q, NQ)  # NQ = dropped
        out_slot = s.out_slot.at[w].set(s.top_slot, mode="drop")
        out_dist = s.out_dist.at[w].set(s.top_dist, mode="drop")
        out_vis = s.out_vis.at[w].set(s.vis_cnt, mode="drop")

        # -- Refill: converged lanes take the next queue entries.
        rank = jnp.cumsum(needs.astype(jnp.int32)) - 1  # [B]
        cand_q = s.next_q + rank
        assign = needs & (cand_q < NQ)
        new_q = jnp.where(assign, cand_q, 0)
        q_rows = queries[new_q]  # [B, D] row gather
        sd_rows = sd_all[new_q]  # [B, S]
        ss_rows = ss_all[new_q]
        a1, a2 = assign[:, None], assign[:, None]
        q_lane = jnp.where(a1, q_rows, s.q_lane)
        seed_slots = jnp.where(a1, ss_rows, s.seed_slots)
        seed_vis = jnp.where(a1, False, s.seed_vis)
        pos_l = jnp.arange(L, dtype=jnp.int32)[None, :]
        beam_dist = jnp.where(
            a1, jnp.where(pos_l < S, jnp.pad(sd_rows, ((0, 0), (0, L - S)),
                                             constant_values=INF), INF),
            s.beam_dist,
        )
        beam_slot = jnp.where(
            a1, jnp.where(pos_l < S, jnp.pad(ss_rows, ((0, 0), (0, L - S)),
                                             constant_values=-1), -1),
            s.beam_slot,
        )
        beam_vis = jnp.where(a1, False, s.beam_vis)
        top_dist = jnp.where(a2, INF, s.top_dist)
        top_slot = jnp.where(a2, -1, s.top_slot)
        vis_cnt = jnp.where(assign, 0, s.vis_cnt)
        lane_q = jnp.where(assign, new_q, jnp.where(needs, -1, s.lane_q))
        n_taken = jnp.minimum(jnp.sum(needs.astype(jnp.int32)), NQ - s.next_q)
        next_q = s.next_q + jnp.maximum(n_taken, 0)

        # -- Hop: identical to beam_search's E=1 body over the live lanes
        # (refilled lanes make their first visit in this same iteration).
        unvis = (~beam_vis) & (beam_slot >= 0)
        idx_e = jnp.argmax(unvis, axis=-1)[:, None]  # [B, 1]
        active_e = jnp.take_along_axis(unvis, idx_e, axis=-1)  # [B, 1]
        cur = jnp.take_along_axis(beam_slot, idx_e, axis=-1)
        cur = jnp.where(active_e, cur, 0)

        node_vec = arrays.vectors[cur].astype(jnp.float32)  # [B, 1, D]
        exact = pairwise_distance(q_lane[:, None, :], node_vec, params.metric)

        beam_vis = beam_vis.at[rows[:, None], idx_e].max(active_e)
        seed_vis = seed_vis | jnp.any(
            (cur[:, :, None] == seed_slots[:, None, :]) & active_e[:, :, None],
            axis=1,
        )
        vis_cnt = vis_cnt + jnp.sum(active_e.astype(jnp.int32), axis=-1)

        # Running top-k: shift-insert the visit's (exact, slot) pair into
        # the sorted [B, K] buffer — replaces the visited log + final-pass
        # sort result-identically (same (dist, slot) order; the membership
        # guard drops the rare duplicate visit the log path dedups).
        d_new = exact[:, 0]
        s_new = cur[:, 0]
        ins_ok = active_e[:, 0]
        if allowed is not None:
            ins_ok = ins_ok & allowed[jnp.maximum(s_new, 0)]
        ins_ok = ins_ok & ~jnp.any(top_slot == s_new[:, None], axis=-1)
        d_new = jnp.where(ins_ok, d_new, INF)
        s_new = jnp.where(ins_ok, s_new, jnp.int32(2**31 - 1))
        better = (top_dist < d_new[:, None]) | (
            (top_dist == d_new[:, None]) & (top_slot < s_new[:, None])
        )
        pos = jnp.sum(better.astype(jnp.int32), axis=-1, keepdims=True)
        pos_k = jnp.arange(K, dtype=jnp.int32)[None, :]
        shift_d = jnp.concatenate([top_dist[:, :1], top_dist[:, :-1]], axis=-1)
        shift_s = jnp.concatenate([top_slot[:, :1], top_slot[:, :-1]], axis=-1)
        top_dist = jnp.where(
            pos_k < pos, top_dist,
            jnp.where(pos_k == pos, d_new[:, None], shift_d),
        )
        top_slot = jnp.where(
            pos_k < pos, top_slot,
            jnp.where(pos_k == pos, s_new[:, None], shift_s),
        )
        top_slot = jnp.where(jnp.isinf(top_dist), -1, top_slot)

        nbrs = arrays.neighbors[cur]  # [B, 1, R]
        if assume_all_valid:
            nbr_live = nbrs >= 0
        else:
            nbr_live = (nbrs >= 0) & arrays.valid[jnp.maximum(nbrs, 0)]
        nbr_live = nbr_live & active_e[:, :, None]
        if ternary_q:
            q_pos, q_neg = encode_ternary(q_lane)
        else:
            q_pos = q_neg = jnp.zeros((B, 1), jnp.uint32)
        with jax.named_scope("edge_score"):
            edge_dist = _score_edges(
                arrays, params, cur, q_lane, q_pos, q_neg, nbrs
            )
        nbrs_f = nbrs.reshape(B, R)
        live_f = nbr_live.reshape(B, R)
        dist_f = edge_dist.reshape(B, R)
        in_beam = jnp.any(
            (nbrs_f[:, :, None] == beam_slot[:, None, :])
            & (beam_slot >= 0)[:, None, :],
            axis=-1,
        )
        in_vis_seed = jnp.any(
            (nbrs_f[:, :, None] == seed_slots[:, None, :])
            & seed_vis[:, None, :],
            axis=-1,
        )
        cand_ok = live_f & ~in_beam & ~in_vis_seed
        cand_dist = jnp.where(cand_ok, dist_f, INF)
        cand_slot = jnp.where(cand_ok, nbrs_f, -1)
        new_dist, new_slot, new_vis = topk_ops.merge_beams(
            beam_dist,
            beam_slot,
            cand_dist,
            cand_slot,
            L,
            extras_a=(beam_vis.astype(jnp.int32),),
            extras_b=(jnp.zeros_like(cand_slot),),
            dedup=False,
            a_sorted=True,
            bitonic=params.bitonic,
        )
        new_slot = jnp.where(jnp.isinf(new_dist), -1, new_slot)

        return _StreamState(
            beam_dist=new_dist,
            beam_slot=new_slot,
            beam_vis=new_vis.astype(jnp.bool_),
            seed_slots=seed_slots,
            seed_vis=seed_vis,
            top_dist=top_dist,
            top_slot=top_slot,
            q_lane=q_lane,
            lane_q=lane_q,
            vis_cnt=vis_cnt,
            next_q=next_q,
            out_slot=out_slot,
            out_dist=out_dist,
            out_vis=out_vis,
            it=s.it + 1,
        )

    final = jax.lax.while_loop(cond, body, state)
    return StreamSearchResult(
        topk_slots=final.out_slot,
        topk_dists=final.out_dist,
        visited_count=final.out_vis,
        hops=final.it,
    )


class ManySearchResult(NamedTuple):
    topk_slots: jnp.ndarray  # i32[NB, B, K]
    topk_dists: jnp.ndarray  # f32[NB, B, K]
    visited_count: jnp.ndarray  # i32[NB, B]
    hops: jnp.ndarray  # i32[NB]


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "l_search", "k", "max_visits", "beam_width",
        "assume_all_valid",
    ),
)
def beam_search_many(
    arrays: GraphArrays,
    queries: jnp.ndarray,  # f32[NB, B, D] — NB batches of B queries
    entry_slot: jnp.ndarray,
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    max_visits: int = 0,
    beam_width: int = 1,
    allowed: jnp.ndarray | None = None,
    assume_all_valid: bool = False,
) -> ManySearchResult:
    """Pipelined serving: ``lax.scan`` of :func:`beam_search` over NB query
    batches inside ONE dispatch.

    A batched engine's throughput path should not pay a host round-trip per
    batch: the reference's join operator batches all RHS queries through one
    ExecuteMultiScan call (hnsw_optimize_join.cpp:137-152) for the same
    reason. Results are bit-identical to NB
    separate :func:`beam_search` calls (the scan body IS beam_search); only
    the per-batch visited logs are dropped from the return value to keep
    the output O(NB*B*k) instead of O(NB*B*max_visits).

    Retrace caveat: NB is a traced dimension of ``queries``, so every
    distinct ceil(B/batch_size) compiles a fresh program. Serving loops
    with varying total B should pad NB to a small set of bucket sizes
    (pad lanes repeat a real query and are discarded on the host —
    exactly what Coordinator.search(batch_size=...) does within one NB)."""
    ent = jnp.asarray(entry_slot, jnp.int32)

    def step(carry, xs):
        qb, eb = xs
        res = beam_search(
            arrays,
            qb,
            eb,
            params=params,
            l_search=l_search,
            k=k,
            max_visits=max_visits,
            beam_width=beam_width,
            allowed=allowed,
            assume_all_valid=assume_all_valid,
        )
        return carry, (
            res.topk_slots, res.topk_dists, res.visited_count, res.hops
        )

    if ent.ndim == 3:
        # Per-query seeds, [NB, B, S] — scanned alongside the batches
        # (query-adaptive seeding; see beam_search's entry_slot doc).
        xs = (queries, ent)
    else:
        xs = (queries, jnp.broadcast_to(ent, (queries.shape[0],) + ent.shape))
    _, outs = jax.lax.scan(step, 0, xs)
    return ManySearchResult(*outs)


@functools.partial(jax.jit, static_argnames=("metric", "s_count"))
def pick_adaptive_seeds(
    vectors: jnp.ndarray,  # [C, D] node vectors (storage dtype)
    queries: jnp.ndarray,  # f32[B, D]
    sample_slots: jnp.ndarray,  # i32[M] live sample slots
    *,
    metric: MetricType,
    s_count: int,
) -> jnp.ndarray:
    """Query-adaptive seed selection: each query's ``s_count`` nearest
    nodes among a small live sample — one [B, M] distance block plus a
    top-k. Seeding the beam inside the query's own region is the
    IVF-style entry fix for clustered corpora, where a single global entry
    point (or insertion-order-stratified seed set) strands Zipf-tail
    clusters. Returns i32[B, S]
    per-query seeds for beam_search/beam_search_many."""
    sv = vectors[sample_slots].astype(jnp.float32)  # [M, D]
    d = pairwise_distance(queries[:, None, :], sv[None, :, :], metric)
    _, idx = jax.lax.top_k(-d, s_count)  # [B, S]
    return sample_slots[idx]


@functools.partial(
    jax.jit,
    static_argnames=("params", "l_insert", "beam_width", "assume_all_valid"),
)
def search_for_initial_candidates(
    arrays: GraphArrays,
    queries: jnp.ndarray,
    entry_slot: jnp.ndarray,
    *,
    params: GraphParams,
    l_insert: int,
    beam_width: int = 1,
    assume_all_valid: bool = False,
) -> SearchResult:
    """Insert-path candidate search: beam search with L=k=L_insert
    (Searcher::SearchForInitialCandidates, core/Searcher.cpp:275-294).
    Visit budget defaults to 2*L_insert — a documented throughput deviation
    from libSQL's capless insert search (config.insert_max_visits raises it;
    tests verify a raised cap never binds, so parity is capless-real).
    ``beam_width`` > 1 (batched builds, params.insert_beam_width) amortizes
    the fixed per-hop cost over multiple visits; sequential parity inserts
    keep the default width 1."""
    return beam_search(
        arrays,
        queries,
        entry_slot,
        params=params,
        l_search=l_insert,
        k=l_insert,
        max_visits=(
            params.insert_max_visits
            if params.insert_max_visits > 0
            else 2 * l_insert
        ),
        beam_width=beam_width,
        assume_all_valid=assume_all_valid,
    )

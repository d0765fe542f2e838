"""Pure-NumPy oracle implementation of the LM-DiskANN algorithm.

This is the executable specification the JAX engine is validated against
— the role SURVEY §4 assigns to "graph-semantics tests against a NumPy/pure-
JAX oracle implementing the libSQL algorithm".

Semantics are pinned to the reference ground truth:

  - beam search: diskAnnSearchInternal (libsql/vectordiskann.c:1283-1400):
    sorted candidate array of capacity L, pick first unvisited, visit it
    (exact distance into the top set), score its cached edge codes, insert
    candidates evicting the worst; terminate when no unvisited candidate
    remains in the beam.
  - RobustPrune: GraphManager::RobustPrune (GraphManager.cpp:259-378):
    distance-sort candidates, dedup by id, drop self, greedy alpha filter
    "exists selected r with alpha * d(p, r) < d(node, p) => prune p", cap R.
  - insert: GraphManager::AddNode (GraphManager.cpp:65-203): search for
    L_insert candidates, RobustPrune to pick neighbors, then the reciprocal
    interconnect pass re-pruning each chosen neighbor with the new node as a
    candidate.
  - delete: diskAnnDelete (vectordiskann.c:1626-1700): eagerly remove
    back-edges from all neighbors, then drop the node.

Deterministic tie-break everywhere: (distance, id) ascending — the pinned
traversal spec (SURVEY §7.3) that both this oracle and the device engine
implement so their results match exactly.

Edge scoring uses the same cached-code approximation as the engine
(ternary popcount dot or int8 dequantized exact), computed via the shared
NumPy codecs, so approximate distances are bit-identical between oracle and
device for identical inputs.
"""

from __future__ import annotations

import numpy as np

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
from duckdb_lm_diskann_tpu.ops.quantize import (
    decode_int4_np,
    decode_int8_np,
    encode_int4_np,
    encode_int8_np,
)
from duckdb_lm_diskann_tpu.ops.ternary import encode_ternary_np, ternary_dot_np


def exact_distance(a: np.ndarray, b: np.ndarray, metric: MetricType) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if metric is MetricType.L2:
        d = np.float32(np.sum((a - b) ** 2, dtype=np.float32))
        return float(np.sqrt(max(d, np.float32(0.0))))
    if metric is MetricType.IP:
        return float(-np.dot(a, b))
    if metric is MetricType.COSINE:
        na = float(np.dot(a, a))
        nb = float(np.dot(b, b))
        if na <= 0.0 or nb <= 0.0:
            return 1.0
        cos = float(np.dot(a, b)) / (np.sqrt(na) * np.sqrt(nb))
        return 1.0 - max(-1.0, min(1.0, cos))
    raise ValueError(metric)


class OracleGraph:
    """Host-side LM-DiskANN graph with per-node cached edge codes."""

    def __init__(self, dims: int, r: int, metric: MetricType,
                 edge_type: EdgeType, alpha: float, l_insert: int,
                 l_search: int):
        self.dims = dims
        self.r = r
        self.metric = metric
        self.edge_type = edge_type
        self.alpha = alpha
        self.l_insert = l_insert
        self.l_search = l_search
        self.vectors: dict[int, np.ndarray] = {}
        self.neighbors: dict[int, list[int]] = {}
        # Cached edge codes, parallel to neighbors: the self-contained-block
        # property (one "block" = vector + neighbor ids + neighbor codes).
        self.edge_codes: dict[int, list] = {}
        self.entry_point: int | None = None

    # --- edge code handling (the in-block compressed neighbor vectors) ---

    def encode_edge(self, vec: np.ndarray):
        if self.edge_type is EdgeType.TERNARY:
            p, n = encode_ternary_np(vec[None, :])
            return (p[0], n[0])
        if self.edge_type is EdgeType.INT8:
            c, s = encode_int8_np(vec[None, :])
            return (c[0], s[0])
        if self.edge_type is EdgeType.INT4:
            c, s = encode_int4_np(vec[None, :])
            return (c[0], s[0])
        if self.edge_type is EdgeType.FLOAT16:
            return np.asarray(vec, np.float16).copy()
        if self.edge_type is EdgeType.FLOAT1BIT:
            return encode_ternary_np(vec[None, :])[0][0]  # sign plane only
        if self.edge_type in (EdgeType.FLOAT32, EdgeType.NONE):
            return np.asarray(vec, np.float32).copy()
        raise ValueError(self.edge_type)

    def edge_distance(self, query: np.ndarray, code) -> float:
        """Approximate distance from cached code — matches the device path."""
        if self.edge_type is EdgeType.TERNARY:
            qp, qn = encode_ternary_np(query[None, :])
            sim = float(ternary_dot_np(qp[0], qn[0], code[0], code[1]))
            if self.metric is MetricType.IP:
                return -sim
            if self.metric is MetricType.COSINE:
                return 1.0 - sim
            raise ValueError("ternary edges invalid for L2")
        if self.edge_type is EdgeType.INT8:
            vec = decode_int8_np(code[0][None, :], np.asarray([code[1]]))[0]
            return exact_distance(query, vec, self.metric)
        if self.edge_type is EdgeType.INT4:
            vec = decode_int4_np(
                code[0][None, :], np.asarray([code[1]]), self.dims
            )[0]
            return exact_distance(query, vec, self.metric)
        if self.edge_type is EdgeType.FLOAT16:
            return exact_distance(query, code.astype(np.float32), self.metric)
        if self.edge_type is EdgeType.FLOAT1BIT:
            # Signed binarized dot: D - 2*popcount(q_bits XOR v_bits)
            # (cosine only, vectordiskann.c:518; distance = 1 - dot, the
            # same monotone map the device path uses).
            qp = encode_ternary_np(query[None, :])[0][0]
            x = qp ^ code
            mism = sum(bin(int(w)).count("1") for w in x)
            return 1.0 - float(self.dims - 2 * mism)
        return exact_distance(query, code, self.metric)

    # --- search (diskAnnSearchInternal, vectordiskann.c:1283-1400) ---

    def search(self, query: np.ndarray, k: int, l_search: int | None = None,
               entry: int | None = None, max_visits: int | None = None):
        """Returns (topk_ids, topk_dists, visited_ids_in_visit_order,
        visited_exact_dists)."""
        query = np.asarray(query, np.float32)
        L = l_search or self.l_search
        V = max_visits or 4 * L  # fixed loop bound, same cap as the device
        if entry is None:
            entry = self.entry_point
        if entry is None or entry not in self.vectors:
            return [], [], [], []

        # Beam: list of [dist, id, visited] kept sorted by (dist, id).
        start_dist = exact_distance(query, self.vectors[entry], self.metric)
        beam: list[list] = [[start_dist, entry, False]]
        visited_ids: list[int] = []
        visited_dists: list[float] = []
        visited_set: set[int] = set()

        while len(visited_ids) < V:
            cur = next((e for e in beam if not e[2]), None)
            if cur is None:
                break
            dist, node, _ = cur
            cur[2] = True
            # Exact distance at visit time (the aTopCandidates insert,
            # vectordiskann.c:1366-1370).
            exact = exact_distance(query, self.vectors[node], self.metric)
            visited_ids.append(node)
            visited_dists.append(exact)
            visited_set.add(node)

            beam_ids = {e[1] for e in beam}
            for j, nbr in enumerate(self.neighbors[node]):
                # Zombie edges (deleted rows) are filtered eagerly at
                # candidate-insertion time, matching the device engine's
                # valid-mask gather; libSQL discovers them lazily at
                # blob-read time (vectordiskann.c:1349-1354) only because
                # checking earlier would cost an I/O there.
                if nbr in visited_set or nbr in beam_ids or nbr not in self.vectors:
                    continue
                code = self.edge_codes[node][j]
                nd = self.edge_distance(query, code)
                # Insert iff better than the current worst or beam not full
                # (diskAnnSearchCtxShouldAddCandidate, :1077-1088); pinned
                # tie-break: sort by (dist, id).
                beam.append([nd, nbr, False])
                beam.sort(key=lambda e: (e[0], e[1]))
                if len(beam) > L:
                    beam.pop()
                beam_ids.add(nbr)

        order = sorted(range(len(visited_ids)),
                       key=lambda i: (visited_dists[i], visited_ids[i]))[:k]
        return ([visited_ids[i] for i in order],
                [visited_dists[i] for i in order],
                visited_ids, visited_dists)

    # --- RobustPrune (GraphManager.cpp:259-378) ---

    @property
    def prune_metric(self) -> MetricType:
        """IP distances are negative and invert the alpha rule; prune in
        cosine geometry for IP (see GraphParams.prune_metric)."""
        return (MetricType.COSINE if self.metric is MetricType.IP
                else self.metric)

    def robust_prune(self, node_vec: np.ndarray, candidate_ids: list[int],
                     self_id: int | None = None) -> list[int]:
        cands = []
        for cid in candidate_ids:
            if cid == self_id or cid not in self.vectors:
                continue
            d = exact_distance(node_vec, self.vectors[cid], self.prune_metric)
            cands.append((d, cid))
        cands.sort()
        # dedup by id, keep first (GraphManager.cpp:302-305)
        seen = set()
        uniq = []
        for d, cid in cands:
            if cid not in seen:
                seen.add(cid)
                uniq.append((d, cid))
        selected: list[int] = []
        for d_node_p, p in uniq:
            if len(selected) >= self.r:
                break
            pruned = False
            for r_id in selected:
                d_p_r = exact_distance(self.vectors[p], self.vectors[r_id],
                                       self.prune_metric)
                if self.alpha * d_p_r < d_node_p:
                    pruned = True
                    break
            if not pruned:
                selected.append(p)
        return selected

    def _set_neighbors(self, node: int, nbr_ids: list[int]):
        self.neighbors[node] = list(nbr_ids)
        self.edge_codes[node] = [self.encode_edge(self.vectors[n])
                                 for n in nbr_ids]

    # --- insert (GraphManager::AddNode, GraphManager.cpp:65-203) ---

    def insert(self, node_id: int, vec: np.ndarray):
        return self.insert_with_budget(node_id, vec,
                                       max_visits=2 * self.l_insert)

    def insert_with_budget(self, node_id: int, vec: np.ndarray,
                           max_visits: int):
        """Insert with an explicit visit budget. libSQL's insert search is
        capless (vectordiskann.c:1493-1623); a budget high enough to never
        bind reproduces that exactly (test_build asserts non-binding), while
        the default 2*L_insert mirrors the device's throughput setting."""
        vec = np.asarray(vec, np.float32)
        self.vectors[node_id] = vec
        if self.entry_point is None:
            self.entry_point = node_id
            self._set_neighbors(node_id, [])
            return
        # SearchForInitialCandidates with L = L_insert, then prune over the
        # FULL visited set — libSQL's "all visited nodes as potential
        # neighbours" (vectordiskann.c:1571-1586), which preserves the
        # long-range path edges.
        _, _, visited, _ = self.search(vec, self.l_insert,
                                       l_search=self.l_insert,
                                       max_visits=max_visits)
        nbrs = self.robust_prune(vec, visited, self_id=node_id)
        self._set_neighbors(node_id, nbrs)
        # Reciprocal pass: add the new node as a candidate edge of EVERY
        # visited node via libSQL's replace/prune insertion
        # (vectordiskann.c:1588-1606); targets in ascending order, matching
        # the device's deterministic grouping.
        accepted = False
        for v in sorted(set(visited)):
            if v != node_id:
                accepted |= self.replace_edge(v, node_id)
        # In-link guarantee (matches the device force_edge_round): if every
        # target rejected the newcomer, force-link it at its nearest
        # selected neighbor.
        if not accepted and nbrs:
            self.force_edge(nbrs[0], node_id)

    # --- replace/prune edge insertion (diskAnnReplaceEdgeIdx +
    #     diskAnnPruneEdges, vectordiskann.c:1176-1280) ---

    def replace_edge(self, t: int, c: int) -> bool:
        """Insert c as a candidate edge of t: overwrite if present; skip if
        dominated (d(t,c) > alpha*d(e,c)); else append when room or replace
        the farthest edge with d(t,e) > d(t,c); afterwards evict edges with
        d(t,e) > alpha*d(c,e). Mirrors the device replace_edge_round
        exactly (compacted lists, first-max replacement tie-break).
        Returns True iff the edge was inserted."""
        if t == c or t not in self.vectors or c not in self.vectors:
            return False
        pm = self.prune_metric
        nbr = self.neighbors[t]
        d_tc = exact_distance(self.vectors[t], self.vectors[c], pm)
        d_te = [
            exact_distance(self.vectors[t], self.vectors[e], pm)
            if e in self.vectors else float("inf")
            for e in nbr
        ]
        d_ec = [
            exact_distance(self.vectors[c], self.vectors[e], pm)
            if e in self.vectors else float("inf")
            for e in nbr
        ]
        already = c in nbr
        if already:
            slot = nbr.index(c)
        else:
            if any(d_tc > self.alpha * dec for e, dec in zip(nbr, d_ec)
                   if e in self.vectors):
                return False  # dominated
            if len(nbr) < self.r:
                slot = len(nbr)
            else:
                repl = [(dte, j) for j, dte in enumerate(d_te) if dte > d_tc]
                if not repl:
                    return False
                best = max(d for d, _ in repl)
                slot = next(j for j, dte in enumerate(d_te) if dte == best)
        new_list = list(nbr)
        if slot == len(new_list):
            new_list.append(c)
            d_te.append(0.0)
            d_ec.append(0.0)
        else:
            new_list[slot] = c
        final = [
            e for j, e in enumerate(new_list)
            if j == slot or not (d_te[j] > self.alpha * d_ec[j])
        ]
        self._set_neighbors(t, final)
        return True

    def force_edge(self, t: int, c: int):
        """Unconditional insertion (device force_edge_round): first empty
        slot, else replace the farthest edge."""
        if t == c or t not in self.vectors or c not in self.vectors:
            return
        nbr = self.neighbors[t]
        if c in nbr:
            return
        if len(nbr) < self.r:
            new_list = nbr + [c]
        else:
            pm = self.prune_metric
            d_te = [
                exact_distance(self.vectors[t], self.vectors[e], pm)
                if e in self.vectors else float("-inf")
                for e in nbr
            ]
            worst = max(range(len(nbr)), key=lambda j: (d_te[j], -j))
            new_list = list(nbr)
            new_list[worst] = c
        self._set_neighbors(t, new_list)

    # --- delete (diskAnnDelete, vectordiskann.c:1626-1700) ---

    def delete(self, node_id: int):
        if node_id not in self.vectors:
            return
        # Unlink + connectivity repair (matching the device Coordinator):
        # each neighbor drops its edge to node_id and inherits node_id's
        # remaining out-edges as RobustPrune candidates. All repairs read
        # the pre-delete state (the device batches them in parallel).
        d_list = [n for n in self.neighbors.get(node_id, [])
                  if n in self.vectors]
        pre_lists = {t: list(self.neighbors[t]) for t in d_list}
        for t in d_list:
            keep = [s for s in pre_lists[t] if s != node_id and s in self.vectors]
            extra = [s for s in d_list if s != t]
            cand = (keep + extra)[: 2 * self.r]
            new_list = self.robust_prune(self.vectors[t], cand, self_id=t)
            self._set_neighbors(t, new_list)
        del self.vectors[node_id]
        del self.neighbors[node_id]
        del self.edge_codes[node_id]
        if self.entry_point == node_id:
            # Entry-point reset (GraphManager::HandleNodeDeletion,
            # GraphManager.cpp:476-487; random fallback :533-552 pinned
            # deterministically to the live node with the most live
            # out-neighbors, ties to the smallest id — same rule as the
            # device Coordinator).
            if self.vectors:
                self.entry_point = max(
                    sorted(self.vectors),
                    key=lambda x: (
                        sum(1 for nb in self.neighbors[x] if nb in self.vectors),
                        -x,
                    ),
                )
            else:
                self.entry_point = None

    def build(self, ids, vectors):
        for i, v in zip(ids, vectors):
            self.insert(int(i), v)


def brute_force_topk(queries: np.ndarray, base: np.ndarray,
                     metric: MetricType, k: int) -> np.ndarray:
    """Ground-truth exact top-k by (dist, index)."""
    out = []
    for q in queries:
        dists = np.array([exact_distance(q, b, metric) for b in base])
        order = sorted(range(len(base)), key=lambda i: (dists[i], i))[:k]
        out.append(order)
    return np.asarray(out)

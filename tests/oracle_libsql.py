"""libSQL-EXACT oracle: a bit-faithful Python replica of the reference C
implementation (/root/reference/libsql/vectordiskann.c), validated against
golden traces produced by EXECUTING that C code (tests/golden_harness/).

This is deliberately a *second* oracle, distinct from tests/oracle.py:

  - tests/oracle.py is the ENGINE's executable spec — it pins the pinned
    (distance, id) tie-break, eager zombie filtering, sorted reciprocal
    passes and delete-time connectivity repair that the JAX engine
    implements (documented deviations, PARITY.md).
  - THIS module replicates the reference's exact behaviors instead:
    insertion-ordered candidate arrays (ties keep arrival order), lazy
    zombie discovery at blob-read time (vectordiskann.c:1349-1354),
    reverse-visit-order insert passes over the visitedList
    (:1572,:1590 — the list is head-prepended at :1100), scan-from-END
    edge replacement with last-max tie-break and early-exit domination
    (:1197-1223), swap-with-last edge deletion (:1426-1448), and the
    reference's delete back-edge removal AS SHIPPED — which is a no-op,
    because :1676 passes ``edgeRowid`` (the neighbor's own id) instead of
    ``nodeRowid`` to nodeBinEdgeFindIdx, so the self-edge lookup never
    matches and every delete leaves ALL back-edges as zombie edges
    (verified by executing the C code; SURVEY Appendix B addendum).

Float arithmetic is float32 with the same operation order as the C shims
(tests/golden_harness/shims.c), so on integer-valued golden datasets every
distance — including the f32 values stored in edge metadata — reproduces
bit-for-bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

F32 = np.float32


def dist_l2(a: np.ndarray, b: np.ndarray) -> np.float32:
    """sqrtf of the f32 sum of squared diffs (shims.c vectorDistanceL2).
    Exact for integer-valued inputs regardless of summation order."""
    d = a.astype(F32) - b.astype(F32)
    return np.sqrt(np.sum(d * d, dtype=F32).astype(F32))


def dist_cos(a: np.ndarray, b: np.ndarray) -> np.float32:
    """f32 dot/norms, double-precision 1 - dot/(sqrt(na)*sqrt(nb)), rounded
    back to f32 (shims.c vectorDistanceCos — same expression structure)."""
    a = a.astype(F32)
    b = b.astype(F32)
    dot = float(np.sum(a * b, dtype=F32))
    na = float(np.sum(a * a, dtype=F32))
    nb = float(np.sum(b * b, dtype=F32))
    if na <= 0.0 or nb <= 0.0:
        return F32(1.0)
    cos = dot / (math.sqrt(na) * math.sqrt(nb))
    cos = min(1.0, max(-1.0, cos))
    return F32(1.0 - cos)


@dataclass
class Edge:
    rowid: int
    dist: np.float32  # stored f32 edge-meta distance (format V2+)
    vec: np.ndarray  # the serialized edge vector copy


@dataclass
class Block:
    """One node block: vector + edge list in BLOCK order (order matters —
    replacement scans and swap-deletes are position-dependent)."""

    rowid: int
    vec: np.ndarray
    edges: list[Edge] = field(default_factory=list)


class LibsqlDiskann:
    """Replays the reference insert/search/delete ops given the recorded
    search roots from a golden trace (the RNG entry choice is external)."""

    def __init__(self, dims: int, metric: str, max_edges: int,
                 insert_l: int, search_l: int, alpha: float = 1.2):
        self.dims = dims
        self.metric = metric
        self.max_edges = max_edges
        self.insert_l = insert_l
        self.search_l = search_l
        self.alpha = alpha
        self.blocks: dict[int, Block] = {}

    def dist(self, a: np.ndarray, b: np.ndarray) -> np.float32:
        return dist_cos(a, b) if self.metric == "cos" else dist_l2(a, b)

    # --- diskAnnSearchInternal (vectordiskann.c:1283-1400) ---

    def search_internal(self, query: np.ndarray, start_rowid: int,
                        max_candidates: int, top_k: int):
        """Returns (visit_order, top_rowids). Candidate array semantics:
        sorted ascending, ties keep ARRIVAL order (strict-less insertion,
        :1077-1088); zombie candidates are discovered lazily at blob-read
        time and removed without a visit (:1349-1354)."""
        query = query.astype(F32)
        # [dist, rowid, visited]
        cands: list[list] = []
        visited_order: list[int] = []
        visited_set: set[int] = set()
        top: list[tuple[np.float32, int]] = []  # (dist, rowid) sorted array

        start = self.blocks[start_rowid]
        cands.append([self.dist(query, start.vec), start_rowid, False])

        def n_unvisited():
            return sum(1 for c in cands if not c[2])

        while n_unvisited() > 0:
            i_cand = next(i for i, c in enumerate(cands) if not c[2])
            dist, rowid, _ = cands[i_cand]
            block = self.blocks.get(rowid)
            if block is None:  # zombie: delete candidate, no visit (:1353)
                cands.pop(i_cand)
                continue
            cands[i_cand][2] = True
            visited_order.append(rowid)
            visited_set.add(rowid)
            # top-set insert (diskAnnSearchCtxMarkVisited :1091-1110):
            # first position with dist < existing (strict), append-after-
            # equals; dropped if full and not better than all.
            ins = next((j for j, (d, _) in enumerate(top) if dist < d),
                       len(top) if len(top) < top_k else -1)
            if ins >= 0:
                top.insert(ins, (dist, rowid))
                del top[top_k:]

            cand_ids = {c[1] for c in cands}
            for e in block.edges:
                if e.rowid in visited_set or e.rowid in cand_ids:
                    continue  # :1379
                ed = self.dist(query, e.vec)
                ins = next(
                    (j for j, c in enumerate(cands) if ed < c[0]),
                    len(cands) if len(cands) < max_candidates else -1,
                )
                if ins < 0:
                    continue
                cands.insert(ins, [ed, e.rowid, False])
                if len(cands) > max_candidates:
                    cands.pop()
                cand_ids = {c[1] for c in cands}
        return visited_order, [r for _, r in top]

    # --- diskAnnReplaceEdgeIdx (:1176-1224) ---

    def replace_edge_idx(self, block: Block, new_rowid: int,
                         new_vec: np.ndarray):
        """Returns (idx | None, node_to_new). Scans edges from the END:
        zombie-duplicate override returns immediately; domination
        (nodeToNew > alpha*edgeToNew) early-exits; replacement slot is the
        farthest-stored edge with last-max tie-break; append wins when the
        block has room."""
        node_to_new = self.dist(block.vec, new_vec)
        i_replace = None
        node_to_replace = None
        for i in range(len(block.edges) - 1, -1, -1):
            e = block.edges[i]
            if e.rowid == new_rowid:
                return i, node_to_new
            node_to_edge = e.dist  # stored meta distance (format V2+)
            edge_to_new = self.dist(e.vec, new_vec)
            if node_to_new > F32(self.alpha) * edge_to_new:
                return None, node_to_new
            if node_to_new < node_to_edge and (
                i_replace is None or node_to_replace < node_to_edge
            ):
                node_to_replace = node_to_edge
                i_replace = i
        if len(block.edges) < self.max_edges:
            return len(block.edges), node_to_new
        return i_replace, node_to_new

    def replace_edge(self, block: Block, idx: int, rowid: int,
                     dist: np.float32, vec: np.ndarray):
        e = Edge(rowid, dist, vec.astype(F32).copy())
        if idx == len(block.edges):
            block.edges.append(e)
        else:
            block.edges[idx] = e

    # --- diskAnnPruneEdges (:1229-1280): swap-with-last deletion ---

    def prune_edges(self, block: Block, i_inserted: int):
        hint = block.edges[i_inserted]
        i = 0
        while i < len(block.edges):
            e = block.edges[i]
            if e.rowid == hint.rowid:
                i += 1
                continue
            hint_to_edge = self.dist(hint.vec, e.vec)
            if e.dist > F32(self.alpha) * hint_to_edge:
                # nodeBinDeleteEdge: move LAST edge into slot i (:1426-1448)
                last = block.edges.pop()
                if i < len(block.edges):
                    block.edges[i] = last
            else:
                i += 1

    # --- diskAnnInsert (:1493-1623) ---

    def insert(self, rowid: int, vec: np.ndarray,
               start_rowid: int | None) -> list[int]:
        """start_rowid is the recorded entry choice (None = first row).
        Returns the insert search's visit order for trace comparison."""
        vec = vec.astype(F32)
        visits: list[int] = []
        if start_rowid is not None:
            visits, _ = self.search_internal(
                vec, start_rowid, self.insert_l, top_k=1
            )
        new_block = Block(rowid, vec.copy())
        self.blocks[rowid] = new_block
        if start_rowid is None:
            return visits
        # Pass 1 (:1572-1586): visitedList order = REVERSE visit order
        # (head prepend at :1100).
        for v in reversed(visits):
            vb = self.blocks[v]
            idx, node_to_new = self.replace_edge_idx(new_block, v, vb.vec)
            if idx is None:
                continue
            self.replace_edge(new_block, idx, v, node_to_new, vb.vec)
            self.prune_edges(new_block, idx)
        # Pass 2 (:1590-1606): same order, add new node into each visited.
        for v in reversed(visits):
            vb = self.blocks[v]
            idx, node_to_new = self.replace_edge_idx(vb, rowid, vec)
            if idx is None:
                continue
            self.replace_edge(vb, idx, rowid, node_to_new, vec)
            self.prune_edges(vb, idx)
        return visits

    # --- diskAnnDelete (:1626-1700) AS SHIPPED ---

    def delete(self, rowid: int):
        """The reference's back-edge removal is a no-op: :1676 looks up the
        NEIGHBOR's own rowid in the neighbor's block (a self-edge, which
        never exists) instead of the deleted node's. Replicated faithfully:
        the row disappears, every forward edge pointing at it becomes a
        zombie discovered lazily by later searches."""
        block = self.blocks.get(rowid)
        if block is None:
            return
        for e in block.edges:
            nb = self.blocks.get(e.rowid)
            if nb is None:
                continue
            i_delete = next(
                (i for i, x in enumerate(nb.edges) if x.rowid == e.rowid),
                -1,
            )  # faithful: searches for e.rowid, i.e. a self-edge
            if i_delete != -1:  # pragma: no cover — unreachable by design
                last = nb.edges.pop()
                if i_delete < len(nb.edges):
                    nb.edges[i_delete] = last
        del self.blocks[rowid]

    def search(self, query: np.ndarray, k: int, start_rowid: int):
        return self.search_internal(query, start_rowid, self.search_l, k)

    def adjacency_bits(self) -> dict[str, list[list[int]]]:
        """{rowid: [[edge_rowid, f32_distance_bits], ...]} in block order —
        the exact shape the golden traces record."""
        out = {}
        for rowid in sorted(self.blocks):
            out[str(rowid)] = [
                [e.rowid, int(np.asarray(e.dist, F32).view(np.uint32))]
                for e in self.blocks[rowid].edges
            ]
        return out

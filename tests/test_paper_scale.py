"""Paper-scale capacity demonstration (BASELINE GIST1M; paper Table II).

GIST1M — 1M x 960d, cosine — with TERNARY cached edges at R=64 needs
~19.5 GB of graph state at 1,048,576 slots (docs/SCALING.md memory model);
row-sharding it is the GlobalShardedIndex's job. Two affordable levels on
the virtual 8-device CPU mesh:

  - TRUE-capacity allocation: the full 1M x 960d row-sharded arrays are
    allocated over the mesh and every device holds exactly 1/8 of every
    field — the memory model, measured not projected.
  - An end-to-end 960d slice: build -> distribute -> sharded search ->
    recall vs brute force at the paper's dimensionality (a full 1M
    distributed_build is hours of XLA-CPU compute; the ID-exactness of
    distributed_build itself is pinned by test_global_sharded at small
    dims, and benchmarks/paper_scale_gist1m.py runs the big config
    standalone).
"""

import numpy as np

from duckdb_lm_diskann_tpu.common.types import (
    EdgeType,
    MetricType,
    VectorType,
)
from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu.core.graph import GraphParams
from duckdb_lm_diskann_tpu.parallel.global_graph import (
    GlobalShardedIndex,
    _alloc_stacked,
)
from duckdb_lm_diskann_tpu.parallel.mesh import make_mesh


def _gist_config(r=64, l_insert=128):
    cfg = LmDiskannConfig(
        metric_type=MetricType.COSINE,
        r=r,
        l_insert=l_insert,
        l_search=100,
        dimensions=960,
        node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.TERNARY,
    )
    cfg.validate()
    return cfg


def test_gist1m_capacity_allocation():
    """Allocate the FULL GIST1M graph (1M x 960d, R=64, ternary edges)
    row-sharded over 8 devices: every device materializes exactly 1/8 of
    every field and the total matches the memory model — vectors 3840 +
    2 ternary planes x 64 edges x ceil(960/32) u32 words (2*64*120) +
    neighbors 256 + flags ~= 19.5 kB/row, ~19.5 GB total, ~2.4 GB/device
    on 8."""
    params = GraphParams.from_config(_gist_config())
    mesh = make_mesh(8)
    cap = 1 << 20  # 1,048,576 slots
    stacked = _alloc_stacked(params, cap, mesh)
    total = 0
    for f in stacked:
        if not f.size:
            continue
        shard_bytes = {s.data.nbytes for s in f.addressable_shards}
        assert len(shard_bytes) == 1, "uneven shard split"
        per_dev = shard_bytes.pop()
        assert per_dev * 8 == f.nbytes, "device holds != 1/8 of the field"
        total += f.nbytes
    per_row = total / cap
    assert 19_000 <= per_row <= 20_000, per_row  # the memory model above
    assert 19e9 < total < 21e9  # paper scale, per the memory model
    assert total / 8 < 3e9  # ~2.4 GB/device on 8
    del stacked


def test_gist_960d_sharded_recall(rng):
    """End-to-end at the paper's dimensionality: build a 960d cosine +
    TERNARY-edge graph, serve it row-sharded over 8 devices, and hold
    recall@10 vs exact brute force (the popcount edge-code path carries
    the traversal at 960d: W = 15 u64-words/plane)."""
    cfg = _gist_config(r=32, l_insert=64)
    n, d = 1024, 960
    z = rng.standard_normal((n, 24)).astype(np.float32)
    w = (rng.standard_normal((24, d)) / 5).astype(np.float32)
    data = np.tanh(z @ w) + 0.02 * rng.standard_normal((n, d)).astype(
        np.float32
    )
    coord = Coordinator(cfg, initial_capacity=n)
    coord.bulk_build(list(range(n)), data, max_batch=256)

    gidx = GlobalShardedIndex(coord, mesh=make_mesh(8))
    stacked = gidx.distribute()
    # per-device bytes = total/8 for every populated field
    for f in stacked:
        if f.size:
            for s in f.addressable_shards:
                assert s.data.nbytes * 8 == f.nbytes

    q = data[:128] + 0.01 * rng.standard_normal((128, d)).astype(np.float32)
    ids, dists = gidx.search(q, 10, l_search=128)

    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ dn.T), axis=1)[:, :10]
    hits = sum(
        len(set(ids[i].tolist()) & set(truth[i].tolist()))
        for i in range(len(q))
    )
    recall = hits / (len(q) * 10)
    assert recall >= 0.93, recall

    # sharded results == single-chip results (the standing contract)
    ids_1, d_1 = coord.search(q, 10, l_search=128)
    np.testing.assert_array_equal(ids, ids_1)
    np.testing.assert_array_equal(dists, d_1)

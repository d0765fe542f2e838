"""Frontier edge scoring (core/searcher._score_edges) for every edge codec,
against the NumPy oracle's own encoders and approximate distances
(tests/oracle.py). Popcount codecs (TERNARY, FLOAT1BIT) produce integer
similarities and must match exactly; the others are elementwise float math
whose only difference is reduction order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
from duckdb_lm_diskann_tpu.core.graph import GraphParams, make_graph_arrays
from duckdb_lm_diskann_tpu.core.searcher import _score_edges
from duckdb_lm_diskann_tpu.ops.quantize import i4_planar_from_packed_np
from duckdb_lm_diskann_tpu.ops.ternary import encode_ternary_np

from .oracle import OracleGraph

CASES = [
    (EdgeType.TERNARY, MetricType.COSINE, 100),
    (EdgeType.FLOAT1BIT, MetricType.COSINE, 100),
    (EdgeType.INT8, MetricType.L2, 24),
    (EdgeType.INT4, MetricType.L2, 24),
    (EdgeType.FLOAT16, MetricType.IP, 24),
    (EdgeType.FLOAT32, MetricType.COSINE, 24),
    (EdgeType.NONE, MetricType.L2, 24),
]


@pytest.mark.parametrize(
    "edge_type,metric,dims", CASES, ids=[c[0].value for c in CASES]
)
def test_score_edges_matches_oracle(rng, edge_type, metric, dims):
    C, R, B = 32, 8, 6
    oracle = OracleGraph(dims, R, metric, edge_type, 1.2, 16, 16)
    params = GraphParams(
        dims=dims, r=R, metric=metric, edge_type=edge_type, alpha=1.2,
        l_insert=16, l_search=16, max_visits=64,
    )
    vecs = rng.standard_normal((C, dims)).astype(np.float32)
    nbrs = rng.integers(0, C, (C, R)).astype(np.int32)
    codes = [[oracle.encode_edge(vecs[j]) for j in row] for row in nbrs]
    arrays = make_graph_arrays(params, C)._replace(
        vectors=jnp.asarray(vecs), neighbors=jnp.asarray(nbrs),
        valid=jnp.ones((C,), bool),
    )

    def stack(i=None, dtype=None):
        x = np.asarray([[c if i is None else c[i] for c in row] for row in codes])
        return jnp.asarray(x if dtype is None else x.astype(dtype))

    if edge_type is EdgeType.TERNARY:
        arrays = arrays._replace(edge_pos=stack(0), edge_neg=stack(1))
    elif edge_type is EdgeType.FLOAT1BIT:
        arrays = arrays._replace(edge_pos=stack())
    elif edge_type is EdgeType.INT8:
        arrays = arrays._replace(edge_i8=stack(0), edge_scale=stack(1))
    elif edge_type is EdgeType.INT4:
        packed = np.asarray([[c[0] for c in row] for row in codes])
        arrays = arrays._replace(
            edge_i4=jnp.asarray(i4_planar_from_packed_np(packed, dims)),
            edge_scale=stack(1),
        )
    elif edge_type in (EdgeType.FLOAT16, EdgeType.FLOAT32):
        arrays = arrays._replace(edge_f32=stack())

    cur = rng.integers(0, C, (B, 1)).astype(np.int32)
    queries = rng.standard_normal((B, dims)).astype(np.float32)
    qp, qn = encode_ternary_np(queries)
    score = jax.jit(_score_edges, static_argnums=1)
    got = np.asarray(score(
        arrays, params, jnp.asarray(cur), jnp.asarray(queries),
        jnp.asarray(qp), jnp.asarray(qn), jnp.asarray(nbrs[cur]),
    ))
    assert got.shape == (B, 1, R)
    want = np.asarray([
        [[oracle.edge_distance(queries[b], codes[cur[b, 0]][r])
          for r in range(R)]]
        for b in range(B)
    ])
    if edge_type in (EdgeType.TERNARY, EdgeType.FLOAT1BIT):
        np.testing.assert_array_equal(got, want.astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

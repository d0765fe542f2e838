"""Exact-distance kernel tests vs scalar NumPy oracles.

Oracle semantics pinned to ComputeExactDistanceFloat (distance.hpp:50-105):
L2 = sqrt(clamp(sum sq, 0)), IP = -dot, COSINE = 1 - clamped cos with
zero-norm -> 1.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from duckdb_lm_diskann_tpu.common.types import MetricType
from duckdb_lm_diskann_tpu.ops.distance import (
    all_pairs_distance,
    pairwise_distance,
    query_to_neighbors_distance,
    similarity_to_distance,
)

METRICS = [MetricType.L2, MetricType.IP, MetricType.COSINE]


def oracle_distance(a, b, metric):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if metric is MetricType.L2:
        d = float(np.sum((a - b) ** 2))
        return np.sqrt(max(d, 0.0))
    if metric is MetricType.IP:
        return -float(np.dot(a, b))
    if metric is MetricType.COSINE:
        na, nb = float(np.dot(a, a)), float(np.dot(b, b))
        if na <= 0.0 or nb <= 0.0:
            return 1.0
        cos = float(np.dot(a, b)) / (np.sqrt(na) * np.sqrt(nb))
        return 1.0 - max(-1.0, min(1.0, cos))
    raise ValueError(metric)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_matches_oracle(rng, metric):
    a = rng.standard_normal((32, 24), dtype=np.float32)
    b = rng.standard_normal((32, 24), dtype=np.float32)
    got = np.asarray(pairwise_distance(jnp.asarray(a), jnp.asarray(b), metric))
    want = np.array([oracle_distance(a[i], b[i], metric) for i in range(32)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_all_pairs_matches_oracle(rng, metric):
    q = rng.standard_normal((8, 16), dtype=np.float32)
    base = rng.standard_normal((20, 16), dtype=np.float32)
    got = np.asarray(all_pairs_distance(jnp.asarray(q), jnp.asarray(base), metric))
    want = np.array(
        [[oracle_distance(q[i], base[j], metric) for j in range(20)] for i in range(8)]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_query_to_neighbors(rng, metric):
    q = rng.standard_normal((4, 16), dtype=np.float32)
    nbrs = rng.standard_normal((4, 6, 16), dtype=np.float32)
    got = np.asarray(
        query_to_neighbors_distance(jnp.asarray(q), jnp.asarray(nbrs), metric)
    )
    want = np.array(
        [[oracle_distance(q[i], nbrs[i, j], metric) for j in range(6)] for i in range(4)]
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cosine_zero_norm_is_max_distance():
    # distance.hpp:85-94: zero vectors -> distance 1.0
    z = jnp.zeros((1, 8))
    v = jnp.ones((1, 8))
    assert float(pairwise_distance(z, v, MetricType.COSINE)[0]) == 1.0
    assert float(pairwise_distance(z, z, MetricType.COSINE)[0]) == 1.0
    got = all_pairs_distance(z, jnp.concatenate([v, z]), MetricType.COSINE)
    np.testing.assert_allclose(np.asarray(got), [[1.0, 1.0]])


def test_l2_sqrt_clamp():
    # Identical vectors: distance must be exactly 0, never NaN.
    v = jnp.asarray(np.random.default_rng(1).standard_normal((5, 12)), jnp.float32)
    d = pairwise_distance(v, v, MetricType.L2)
    np.testing.assert_array_equal(np.asarray(d), np.zeros(5, np.float32))


def test_similarity_to_distance_mapping():
    sim = jnp.asarray([2.0, -3.0])
    np.testing.assert_allclose(
        np.asarray(similarity_to_distance(sim, MetricType.IP)), [-2.0, 3.0]
    )
    np.testing.assert_allclose(
        np.asarray(similarity_to_distance(sim, MetricType.COSINE)), [-1.0, 4.0]
    )
    with pytest.raises(ValueError, match="L2"):
        similarity_to_distance(sim, MetricType.L2)


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a (closed) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in eqn.params.values():
            if hasattr(sub, "jaxpr"):
                out.extend(_dot_precisions(sub.jaxpr))
    return out


@pytest.mark.parametrize("metric", METRICS)
def test_all_pairs_runs_at_highest_precision(metric):
    # Exact answers (brute-force scan, no-index join, recall ground truth)
    # come from this product; at default precision a GPU may run an f32
    # matmul in TF32.
    import jax

    q = jnp.zeros((4, 16), jnp.float32)
    base = jnp.zeros((32, 16), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda a, b: all_pairs_distance(a, b, metric))(q, base)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert len(precisions) == 1
    highest = jax.lax.Precision.HIGHEST
    assert precisions[0] in ((highest, highest), highest)

"""Batched exact-distance kernels (L2 / IP / COSINE).

JAX re-design of ``src/lm_diskann/core/distance.hpp``:

  - ComputeExactDistanceFloat (distance.hpp:50-105):
      L2     -> sqrt(max(sum((a-b)^2), 0))
      IP     -> -dot(a, b)
      COSINE -> 1 - clamp(dot / (|a||b|), -1, 1); zero-norm vectors -> 1.0
  - CalculateDistance<T_Q, T_N> (distance.hpp:165-198): int8 inputs are
    widened to float32 first (no scaling), reproduced by callers converting
    with common.types.convert_to_float.

Where the reference computes one scalar distance per call in a pointer loop,
these kernels are *batched*: pairwise forms are elementwise products and
reductions, and the all-pairs form is one matrix product — the hot operator
of brute-force scans, exact re-ranking (Searcher.cpp:189-245), and the
RobustPrune candidate matrices.

All functions are jit-safe pure functions of their inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..common.types import MetricType


def _l2_from_sq(dist_sq: jnp.ndarray) -> jnp.ndarray:
    # Clamp-at-zero before sqrt, matching distance.hpp:63-66.
    return jnp.sqrt(jnp.maximum(dist_sq, 0.0))


def pairwise_distance(
    a: jnp.ndarray, b: jnp.ndarray, metric: MetricType
) -> jnp.ndarray:
    """Distance between broadcast-compatible batches of vectors.

    a: [..., D], b: [..., D] -> [...]. Elementwise over leading dims.
    Exact semantics of ComputeExactDistanceFloat (distance.hpp:50-105).
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    if metric is MetricType.L2:
        diff = a - b
        return _l2_from_sq(jnp.sum(diff * diff, axis=-1))
    if metric is MetricType.IP:
        return -jnp.sum(a * b, axis=-1)
    if metric is MetricType.COSINE:
        dot = jnp.sum(a * b, axis=-1)
        na_sq = jnp.sum(a * a, axis=-1)
        nb_sq = jnp.sum(b * b, axis=-1)
        norm = jnp.sqrt(na_sq) * jnp.sqrt(nb_sq)
        cos = jnp.clip(dot / jnp.where(norm > 0.0, norm, 1.0), -1.0, 1.0)
        # Zero (or negative-underflow) norms -> max distance 1.0
        # (distance.hpp:85-94).
        return jnp.where((na_sq <= 0.0) | (nb_sq <= 0.0), 1.0, 1.0 - cos)
    raise ValueError(f"Unsupported metric type {metric}")


def all_pairs_distance(
    queries: jnp.ndarray, base: jnp.ndarray, metric: MetricType
) -> jnp.ndarray:
    """All-pairs distances: queries [B, D] x base [N, D] -> [B, N].

    Every metric reduces to one [B, D] @ [D, N] matmul plus rank-1 norm
    corrections. This is the engine under exact answers: the brute-force
    scan (the lm_diskann_match/join macros, hnsw_index_macros.cpp:10-113),
    the no-index join, and recall ground truth. The product runs at
    ``Precision.HIGHEST``: at default precision a GPU may compute an f32
    matmul in TF32 (about three decimal digits), which would turn an exact
    answer into an approximate one.
    """
    q = queries.astype(jnp.float32)
    b = base.astype(jnp.float32)
    dot = jax.lax.dot_general(
        q,
        b,
        (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [B, N]
    if metric is MetricType.IP:
        return -dot
    if metric is MetricType.L2:
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)  # [B, 1]
        b_sq = jnp.sum(b * b, axis=-1)[None, :]  # [1, N]
        return _l2_from_sq(q_sq + b_sq - 2.0 * dot)
    if metric is MetricType.COSINE:
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
        b_sq = jnp.sum(b * b, axis=-1)[None, :]
        norm = jnp.sqrt(q_sq) * jnp.sqrt(b_sq)
        cos = jnp.clip(dot / jnp.where(norm > 0.0, norm, 1.0), -1.0, 1.0)
        return jnp.where((q_sq <= 0.0) | (b_sq <= 0.0), 1.0, 1.0 - cos)
    raise ValueError(f"Unsupported metric type {metric}")


def batched_all_pairs_distance(
    vecs: jnp.ndarray, metric: MetricType
) -> jnp.ndarray:
    """Per-batch candidate-vs-candidate distance matrix:
    vecs [T, C, D] -> [T, C, C].

    The RobustPrune inner engine: the reference's O(R^2) scalar
    candidate-vs-selected distance loop (GraphManager.cpp:346-367) becomes a
    batched [C, D] x [D, C] matmul per target, at the default precision.
    """
    v = vecs.astype(jnp.float32)
    dot = jnp.einsum("tcd,ted->tce", v, v, preferred_element_type=jnp.float32)
    if metric is MetricType.IP:
        return -dot
    sq = jnp.sum(v * v, axis=-1)  # [T, C]
    if metric is MetricType.L2:
        return _l2_from_sq(sq[:, :, None] + sq[:, None, :] - 2.0 * dot)
    if metric is MetricType.COSINE:
        norm = jnp.sqrt(sq)[:, :, None] * jnp.sqrt(sq)[:, None, :]
        cos = jnp.clip(dot / jnp.where(norm > 0.0, norm, 1.0), -1.0, 1.0)
        zero = (sq[:, :, None] <= 0.0) | (sq[:, None, :] <= 0.0)
        return jnp.where(zero, 1.0, 1.0 - cos)
    raise ValueError(f"Unsupported metric type {metric}")


def query_to_neighbors_distance(
    query: jnp.ndarray, neighbor_vecs: jnp.ndarray, metric: MetricType
) -> jnp.ndarray:
    """query [B, D] x per-query neighbor vectors [B, R, D] -> [B, R].

    The frontier-expansion scoring op for FLOAT32/INT8 edge caches: each beam
    element scores all R cached neighbor vectors from one gathered node row —
    the batched form of the per-edge distance loop in
    libsql/vectordiskann.c:1370-1396 (approx distances from in-block
    compressed vectors, no second block fetch).
    """
    return pairwise_distance(query[:, None, :], neighbor_vecs, metric)


def similarity_to_distance(sim: jnp.ndarray, metric: MetricType) -> jnp.ndarray:
    """CalculateApproxDistance's similarity->distance mapping
    (distance.hpp:231-242): IP -> -sim, COSINE -> 1-sim, L2 -> rejected."""
    if metric is MetricType.IP:
        return -sim
    if metric is MetricType.COSINE:
        return 1.0 - sim
    raise ValueError(
        "L2 metric is not directly compatible with ternary approximate "
        "distance. Ternary approximation is for IP/Cosine-like similarities."
    )

"""Scalar distance functions + expression IR for the planner surface.

Mirrors the reference's distance-function surface that the optimizer
pattern-matches (HNSWIndex::TryMatchDistanceFunction,
src/hnsw/hnsw_index.cpp:615-650):

    array_distance               -> L2
    array_cosine_distance        -> COSINE
    array_negative_inner_product -> IP
    array_cosine_similarity / array_inner_product — similarity forms that the
    expression optimizer rewrites into distance forms
    (hnsw_optimize_expr.cpp:18-75).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..common.types import MetricType
from ..ops.distance import all_pairs_distance


# --- expression IR ---


@dataclasses.dataclass(frozen=True)
class Expr:
    pass


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    """Column reference; ``table`` qualifies multi-relation expressions (the
    BoundColumnRef binding-index analog used by the join matcher,
    hnsw_optimize_join.cpp:397-419)."""

    name: str
    table: str | None = None


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: object

    def __hash__(self):
        v = self.value
        if isinstance(v, np.ndarray):
            return hash((v.shape, v.tobytes()))
        return hash(v)

    def __eq__(self, other):
        if not isinstance(other, Const):
            return NotImplemented
        a, b = self.value, other.value
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return np.array_equal(np.asarray(a), np.asarray(b))
        return a == b


@dataclasses.dataclass(frozen=True)
class FunctionExpr(Expr):
    name: str
    args: tuple


# Distance-function name -> metric (TryMatchDistanceFunction map).
DISTANCE_FUNCTIONS: dict[str, MetricType] = {
    "array_distance": MetricType.L2,
    "array_cosine_distance": MetricType.COSINE,
    "array_negative_inner_product": MetricType.IP,
}

# Similarity spellings and their distance rewrites
# (hnsw_optimize_expr.cpp:18-75 rewrites 1.0 - cosine_similarity).
SIMILARITY_TO_DISTANCE = {
    "array_cosine_similarity": "array_cosine_distance",
    "array_inner_product": "array_negative_inner_product",
}


def l2(a, b):
    return FunctionExpr("array_distance", (a, b))


def cosine_distance(a, b):
    return FunctionExpr("array_cosine_distance", (a, b))


def cosine_similarity(a, b):
    return FunctionExpr("array_cosine_similarity", (a, b))


def negative_inner_product(a, b):
    return FunctionExpr("array_negative_inner_product", (a, b))


def inner_product(a, b):
    return FunctionExpr("array_inner_product", (a, b))


def sub(a, b):
    return FunctionExpr("-", (a, b))


def match_distance_call(expr: Expr):
    """If expr is dist_fn(column, const) or dist_fn(const, column), return
    (metric, column_name, query_vector); else None. Mirrors the operand
    matching of the TopN optimizer (hnsw_optimize_scan.cpp:83-130)."""
    if not isinstance(expr, FunctionExpr) or expr.name not in DISTANCE_FUNCTIONS:
        return None
    if len(expr.args) != 2:
        return None
    a, b = expr.args
    col, const = None, None
    if isinstance(a, ColumnRef) and isinstance(b, Const):
        col, const = a, b
    elif isinstance(b, ColumnRef) and isinstance(a, Const):
        col, const = b, a
    else:
        return None
    return DISTANCE_FUNCTIONS[expr.name], col.name, np.asarray(const.value, np.float32)


def evaluate_distance(
    metric: MetricType, vectors: np.ndarray, query: np.ndarray
) -> np.ndarray:
    """Brute-force scalar-function evaluation over a whole column — one
    HIGHEST-precision matmul (the seq_scan the optimizer replaces)."""
    out = all_pairs_distance(
        jnp.asarray(query[None, :], jnp.float32), jnp.asarray(vectors), metric
    )
    return np.asarray(out)[0]

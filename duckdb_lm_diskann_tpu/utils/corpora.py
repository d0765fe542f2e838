"""Seeded synthetic corpora: a smooth manifold and a hard stressor.

``make_manifold_corpus`` models well-behaved descriptor corpora (SIFT,
GIST, DEEP): graph-ANN recall curves on it start near 0.99 at L=50 and can
hide prune-quality regressions. ``make_hard_corpus`` produces the
pathologies real-world corpora actually show, so recall-vs-L has room to
move:

  clustered    — Zipf-mass clusters: a few giant dense clusters plus a
                 long tail of sparse ones. Giant clusters starve the
                 alpha-prune of long-range edges; tail clusters risk
                 disconnection.
  anisotropic  — per-cluster random low-rank stretch: distances are
                 dominated by a few directions, so cached-code (INT4/
                 ternary) approximations mis-rank harder.
  duplicates   — a fraction of rows are exact or near-exact copies:
                 stresses dedup/tie-break paths and wastes beam slots.

All three pathologies combine in ``make_hard_corpus`` (deterministic per
seed). Both generators return ``(gen, rng)``: ``gen(m)`` draws m more rows,
and ``rng`` is the generator's own stream for drawing queries.
"""

from __future__ import annotations

import numpy as np


def make_manifold_corpus(dims, seed=0xBE7C4, zdim=12):
    """Smooth random manifold with intrinsic dimension 12 embedded in
    ``dims`` (z ~ N(0,I)^12 -> tanh(z W1) W2 + noise): real SIFT/GIST/DEEP
    vectors live on low-intrinsic-dimension manifolds with continuous
    neighborhoods, the regime graph-ANN methods (and their published recall
    numbers) assume."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((zdim, 64)).astype(np.float32)
    w2 = (rng.standard_normal((64, dims)) / np.sqrt(64)).astype(np.float32)

    def gen(m):
        z = rng.standard_normal((m, zdim)).astype(np.float32)
        return np.tanh(z @ w1) @ w2 + 0.02 * rng.standard_normal(
            (m, dims)
        ).astype(np.float32)

    return gen, rng


def zipf_cluster_ids(rng: np.random.Generator, m: int, n_clusters: int,
                     exponent: float = 1.1) -> np.ndarray:
    """Cluster assignment with Zipf(exponent) mass over cluster ranks."""
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    return rng.choice(n_clusters, size=m, p=p)


def make_hard_corpus(
    n: int,
    dims: int,
    seed: int = 0x4A2D,
    n_clusters: int = 256,
    zipf_exponent: float = 1.1,
    anisotropy_decades: float = 1.5,
    duplicate_fraction: float = 0.05,
):
    """Clustered + anisotropic + duplicate-heavy generator.

    Each cluster c has a center ~ 4*N(0,I) and a per-dimension scale
    vector log-uniform over ``anisotropy_decades`` decades (random
    rotation omitted: axis-aligned stretch already breaks the isotropic
    assumption the codes rely on, and keeps the generator cheap at 1M+).
    ``duplicate_fraction`` of rows are exact copies of earlier rows.
    """
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((n_clusters, dims)).astype(np.float32)
    scales = (
        10.0
        ** rng.uniform(-anisotropy_decades, 0.3, (n_clusters, dims))
    ).astype(np.float32)

    def gen(m: int) -> np.ndarray:
        cid = zipf_cluster_ids(rng, m, n_clusters, zipf_exponent)
        x = centers[cid] + scales[cid] * rng.standard_normal(
            (m, dims)
        ).astype(np.float32)
        n_dup = int(m * duplicate_fraction)
        if n_dup and m > 1:
            dst = rng.choice(m, n_dup, replace=False)
            src = rng.integers(0, m, n_dup)
            x[dst] = x[src]
        return x

    return gen, rng

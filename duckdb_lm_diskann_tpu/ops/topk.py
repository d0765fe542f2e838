"""Deterministic top-k selection and sorted-beam merge primitives.

The reference maintains its beam as a distance-sorted candidate array with
insertion at the first index whose distance exceeds the new candidate's
(libsql/vectordiskann.c:1077-1148) and its top-k as a second sorted buffer
(:1091-1110). Here both become whole-array sorts with a pinned
deterministic tie-break — sort by (distance, id) — which is the pinned
traversal spec that replaces heap pop order (SURVEY §7.3).

All sorts are ``jax.lax.sort`` with num_keys=2: lexicographic ascending on
(distance, id), so equal distances always resolve to the smaller id, on every
backend, every shard count, every batch size.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

def default_bitonic() -> bool:
    """Single source of truth for the hop-merge implementation default.

    Explicit LMD_BITONIC wins ("0" = generic lax.sort forms, anything else =
    bitonic networks); otherwise backend-dependent: bitonic on CPU (measured
    ~25% faster on XLA-CPU), lax.sort on the GPU, where XLA's sort kernel
    beat the fused networks in stream QPS on an H100 at the headline shape
    (chip_smoke.py's merge phase; numbers in PERF.md). Resolved lazily,
    never at import: modules must be import-safe so
    jax.distributed.initialize() can run before any backend init."""
    env = os.environ.get("LMD_BITONIC")
    if env is not None:
        return env != "0"
    try:
        return jax.default_backend() == "cpu"
    except Exception:
        return True

# Python float, not a device array: modules must be import-safe so
# jax.distributed.initialize() can run before any backend init
# (parallel/multihost.py entry path).
INF = float("inf")


def sort_by_distance_id(
    dist: jnp.ndarray, ids: jnp.ndarray, *extras: jnp.ndarray
) -> tuple[jnp.ndarray, ...]:
    """Sort along the last axis by (dist, id) ascending; extras are permuted
    along for the ride. Invalid entries should carry dist=+inf."""
    return jax.lax.sort((dist, ids) + tuple(extras), dimension=-1, num_keys=2)


def topk_by_distance(
    dist: jnp.ndarray, ids: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic k smallest (dist, id) pairs along the last axis."""
    sorted_dist, sorted_ids = sort_by_distance_id(dist, ids)
    return sorted_dist[..., :k], sorted_ids[..., :k]


def mask_invalid(
    dist: jnp.ndarray, ids: jnp.ndarray, valid: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Push invalid entries to (+inf, -1) so sorts move them to the tail."""
    return (
        jnp.where(valid, dist, INF),
        jnp.where(valid, ids, jnp.int32(-1)),
    )


def dedup_sorted_ids(
    dist: jnp.ndarray, ids: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """After a (dist, id) sort, mask duplicate ids (keep first occurrence).

    Safety net mirroring the reference's duplicate guards: RobustPrune dedups
    candidates by row id after sorting (GraphManager.cpp:302-305) and the
    search context refuses duplicate candidates (vectordiskann.c:1066-1074).
    A duplicated id always carries an identical cached-code distance, so
    duplicates land adjacent after the lexicographic sort.
    """
    prev_ids = jnp.concatenate(
        [jnp.full_like(ids[..., :1], -2), ids[..., :-1]], axis=-1
    )
    dup = (ids == prev_ids) & (ids >= 0)
    return mask_invalid(dist, ids, ~dup)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _cmp_swap(arrs, swap, stride, width):
    """One compare-exchange stage: pair lanes (i, i+stride) inside blocks of
    2*stride along the last axis; ``swap`` [..., width//2//stride? ] decides.
    Returns the exchanged arrays. ``swap`` has the paired shape
    [..., width/(2*stride), stride]."""
    lead = arrs[0].shape[:-1]
    out = []
    for a in arrs:
        p = a.reshape(*lead, width // (2 * stride), 2, stride)
        lo, hi = p[..., 0, :], p[..., 1, :]
        new_lo = jnp.where(swap, hi, lo)
        new_hi = jnp.where(swap, lo, hi)
        out.append(
            jnp.stack([new_lo, new_hi], axis=-2).reshape(*lead, width)
        )
    return tuple(out)


def _lex_gt(d0, i0, d1, i1):
    """(d0, i0) > (d1, i1) lexicographic — the pinned (distance, id) order.

    Note: unlike lax.sort's total float order this treats -0.0 == +0.0
    (exactly like the NumPy oracle's lexsort); distances here are never
    both-signed zeros in practice (L2/cos are non-negative; IP -0.0 only
    from an exactly-zero dot)."""
    return (d0 > d1) | ((d0 == d1) & (i0 > i1))


def _bitonic_stage(arrs, stride, width, asc_mask=None):
    """Compare-exchange at ``stride``; ``asc_mask`` (paired shape, True =
    ascending block) flips the comparison for descending blocks."""
    lead = arrs[0].shape[:-1]
    d = arrs[0].reshape(*lead, width // (2 * stride), 2, stride)
    i = arrs[1].reshape(*lead, width // (2 * stride), 2, stride)
    gt = _lex_gt(d[..., 0, :], i[..., 0, :], d[..., 1, :], i[..., 1, :])
    swap = gt if asc_mask is None else (gt == asc_mask)
    return _cmp_swap(arrs, swap, stride, width)


def bitonic_sort(arrs: tuple, *, descending: bool = False) -> tuple:
    """Full bitonic sort by (dist, id) lexicographic over the last axis.

    ``arrs`` = (dist, ids, *extras); width must be a power of two. A fused
    compare-exchange network — every stage is elementwise ops XLA fuses,
    bypassing the generic variadic sort kernel."""
    width = arrs[0].shape[-1]
    assert width & (width - 1) == 0, "bitonic_sort requires pow2 width"
    lead_ndim = arrs[0].ndim - 1
    k = 2
    while k <= width:
        # Block direction: ascending iff (position // k) is even (flipped
        # globally for a descending sort).
        s = k // 2
        while s >= 1:
            pos = jnp.arange(width).reshape(width // (2 * s), 2, s)[:, 0, :]
            asc = (pos // k) % 2 == 0
            if descending:
                asc = ~asc
            asc = asc.reshape((1,) * lead_ndim + asc.shape)
            arrs = _bitonic_stage(arrs, s, width, asc_mask=asc)
            s //= 2
        k *= 2
    return arrs


def bitonic_merge_sorted(arrs_a: tuple, arrs_b_desc: tuple) -> tuple:
    """Merge an ASCENDING-sorted run A with a DESCENDING-sorted run B into
    one ascending run: concat(A, B_desc) is bitonic, so log2(n) stages
    suffice (vs log^2 for a full sort). Widths must sum to a power of two."""
    width = arrs_a[0].shape[-1] + arrs_b_desc[0].shape[-1]
    assert width & (width - 1) == 0, "merge width must be pow2"
    arrs = tuple(
        jnp.concatenate([a, b], axis=-1)
        for a, b in zip(arrs_a, arrs_b_desc, strict=True)
    )
    s = width // 2
    while s >= 1:
        arrs = _bitonic_stage(arrs, s, width)
        s //= 2
    return arrs


def sorted_dedup_topk(
    dist: jnp.ndarray,
    ids: jnp.ndarray,
    *,
    bitonic: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sort by (dist, id), mask duplicate ids, re-sort — the final-pass
    shape (exact re-rank over the visited log, Searcher.cpp:189-245 /
    vectordiskann.c:1091-1110). With ``bitonic`` the two generic sorts
    become fused compare-exchange networks (pow2-padded); exactness-equal.
    Callers truncate the result to k themselves."""
    if bitonic is None:
        bitonic = default_bitonic()
    if not bitonic:
        sd, ss = sort_by_distance_id(dist, ids)
        sd, ss = dedup_sorted_ids(sd, ss)
        return sort_by_distance_id(sd, ss)[:2]

    orig = dist.shape[-1]
    n = _next_pow2(orig) - orig
    if n:
        cfg = [(0, 0)] * (dist.ndim - 1) + [(0, n)]
        dist = jnp.pad(dist, cfg, constant_values=INF)
        ids = jnp.pad(ids, cfg, constant_values=-1)
    sd, ss = bitonic_sort((dist, ids))
    sd, ss = dedup_sorted_ids(sd, ss)
    sd, ss = bitonic_sort((sd, ss))
    return sd[..., :orig], ss[..., :orig]


def merge_beams(
    dist_a: jnp.ndarray,
    ids_a: jnp.ndarray,
    dist_b: jnp.ndarray,
    ids_b: jnp.ndarray,
    size: int,
    *,
    extras_a: tuple[jnp.ndarray, ...] = (),
    extras_b: tuple[jnp.ndarray, ...] = (),
    dedup: bool = False,
    a_sorted: bool = False,
    bitonic: bool | None = None,
) -> tuple[jnp.ndarray, ...]:
    """Merge two (dist, id, extras...) candidate sets, keep the best ``size``.

    The batched form of diskAnnSearchCtxInsertCandidate's insert-and-evict-worst
    (vectordiskann.c:1136-1148) applied to a whole batch of new candidates at
    once: concat -> lexicographic sort -> truncate. Callers must pre-mask
    entries they don't want considered (dist=+inf).

    ``dedup``: mask duplicate ids before truncation, keeping each id's
    best (distance, then original-order) copy. The dedup pass sorts by
    (id, distance) so ALL copies of an id are adjacent — including copies
    with differing distances, which exist when a stale cached edge code
    points at a recycled slot — then re-sorts by (distance, id). Two sorts
    total; callers with E>1 frontier expansion use this instead of an
    O((E*R)^2) pairwise duplicate mask.

    ``a_sorted``: promise that (dist_a, ids_a) is already (dist, id)-sorted
    ascending AND the two sides share no ids. Enables the bitonic fast
    path — sort only the candidates (descending), then one log2(n)-stage
    bitonic merge instead of a full lax.sort over the concatenation. The
    hop-loop caller (core/searcher.py) qualifies: the beam is maintained
    sorted and in-beam neighbors are masked out of the candidates.

    ``bitonic``: use the fused bitonic compare-exchange networks instead of
    generic lax.sort kernels wherever a path supports it (False retains the
    lax.sort forms — the reference implementation the exactness tests pin
    the networks against); None -> default_bitonic() (LMD_BITONIC env, else
    backend-dependent). Caveat: bitonic networks are NOT stable, so two
    entries with byte-identical (dist, id) keys but different extras can
    attach extras either way; the searcher never produces that shape (its
    only equal-key duplicates carry equal extras — beam members are masked
    out of the candidates before the merge).
    """
    if bitonic is None:
        bitonic = default_bitonic()
    if a_sorted and not dedup and bitonic:
        La, Lb = dist_a.shape[-1], dist_b.shape[-1]
        pb = _next_pow2(Lb)
        total = _next_pow2(La + pb)
        pa = total - pb

        def pad(x, width, fill):
            n = width - x.shape[-1]
            if n == 0:
                return x
            cfg = [(0, 0)] * (x.ndim - 1) + [(0, n)]
            return jnp.pad(x, cfg, constant_values=fill)

        b = (pad(dist_b, pb, INF), pad(ids_b, pb, -1)) + tuple(
            pad(e, pb, 0) for e in extras_b
        )
        # Descending sort floats the +inf pads to B's front, where the
        # bitonic merge needs them; they exit at the output tail.
        b = bitonic_sort(b, descending=True)
        a = (pad(dist_a, pa, INF), pad(ids_a, pa, -1)) + tuple(
            pad(e, pa, 0) for e in extras_a
        )
        out = bitonic_merge_sorted(a, b)
        return tuple(o[..., :size] for o in out)

    dist = jnp.concatenate([dist_a, dist_b], axis=-1)
    ids = jnp.concatenate([ids_a, ids_b], axis=-1)
    extras = tuple(
        jnp.concatenate([ea, eb], axis=-1)
        for ea, eb in zip(extras_a, extras_b, strict=True)
    )
    if dedup:
        if bitonic:
            width = _next_pow2(dist.shape[-1])

            def pad(x, fill):
                n = width - x.shape[-1]
                if n == 0:
                    return x
                cfg = [(0, 0)] * (x.ndim - 1) + [(0, n)]
                return jnp.pad(x, cfg, constant_values=fill)

            # Pad ids with int32 max so pads tail the (id, dist) sort; they
            # mutually dedup to (-1, INF) and tail the final sort too.
            imax = jnp.iinfo(jnp.int32).max
            padded = (pad(ids, imax), pad(dist, INF)) + tuple(
                pad(e, 0) for e in extras
            )
            by_id = bitonic_sort(padded)
        else:
            by_id = jax.lax.sort(
                (ids, dist) + extras, dimension=-1, num_keys=2
            )
        ids_s, dist_s = by_id[0], by_id[1]
        prev = jnp.concatenate(
            [jnp.full_like(ids_s[..., :1], -2), ids_s[..., :-1]], axis=-1
        )
        dup = (ids_s == prev) & (ids_s >= 0)
        dist_s = jnp.where(dup, INF, dist_s)
        ids_s = jnp.where(dup, jnp.int32(-1), ids_s)
        if bitonic:
            out = bitonic_sort((dist_s, ids_s) + by_id[2:])
        else:
            out = sort_by_distance_id(dist_s, ids_s, *by_id[2:])
    else:
        out = sort_by_distance_id(dist, ids, *extras)
    return tuple(o[..., :size] for o in out)

"""Regression tests for round-1 advisor findings (ADVICE.md).

Each test pins one reported defect:
  1. Reopen workflow: create_index over a persisted index directory.
  2. Reopen with conflicting layout options must raise, not silently
     serialize a mismatched layout.
  3. Sharded search with row ids >= 2^31 (int64 ids survive the device
     hi/lo split).
  4. Insert rollback clears the valid mask and leaves slots in the pending
     deletion queue (no immediate recycling).
"""

import numpy as np
import pytest

from duckdb_lm_diskann_tpu.common.types import MetricType, VectorType
from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu.db.database import connect


OPTS = {"metric": "cosine", "r": 4, "l_insert": 8, "l_search": 16}


def _make_db(tmp_path, rng, n=48, d=8):
    data = rng.standard_normal((n, d)).astype(np.float32)
    db = connect(str(tmp_path / "db"))
    t = db.create_table("t", {"v": data})
    db.create_index("idx", t, "v", options=dict(OPTS))
    db.checkpoint()
    return data


def test_reopen_create_index_reuses_persisted(tmp_path, rng):
    data = _make_db(tmp_path, rng)
    # Natural reopen workflow: recreate table + create_index after restart.
    db2 = connect(str(tmp_path / "db"))
    t2 = db2.create_table("t", {"v": data})
    idx2 = db2.create_index("idx", t2, "v", options=dict(OPTS))
    assert idx2.coordinator.count == len(data)
    res = db2.knn("t", "v", data[3], 3, metric="cosine")
    assert 3 in res["row_ids"].tolist()


def test_reopen_create_index_rebuilds_on_row_mismatch(tmp_path, rng):
    data = _make_db(tmp_path, rng)
    # Reopen with a DIFFERENT row set: must rebuild, not crash on
    # duplicate-rowid bulk_build into the loaded coordinator.
    db2 = connect(str(tmp_path / "db"))
    t2 = db2.create_table("t", {"v": data[:20]})
    idx2 = db2.create_index("idx", t2, "v", options=dict(OPTS))
    assert idx2.coordinator.count == 20


def test_reopen_conflicting_layout_options_raise(tmp_path, rng):
    data = _make_db(tmp_path, rng)
    db2 = connect(str(tmp_path / "db"))
    t2 = db2.create_table("t", {"v": data})
    bad = dict(OPTS)
    bad["r"] = 8  # persisted index has r=4
    with pytest.raises(ValueError, match="conflicts with the persisted"):
        db2.create_index("idx", t2, "v", options=bad)
    # Unspecified options take the persisted values, no error.
    db3 = connect(str(tmp_path / "db"))
    t3 = db3.create_table("t", {"v": data})
    idx3 = db3.create_index("idx", t3, "v")
    assert idx3.config.r == 4


def test_sharded_search_preserves_int64_rowids(rng):
    from duckdb_lm_diskann_tpu.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu.parallel.sharded import ShardedIndex

    dims, n, k = 8, 120, 3
    cfg = LmDiskannConfig(
        metric_type=MetricType.COSINE, r=4, l_insert=8, l_search=24,
        dimensions=dims, node_vector_type=VectorType.FLOAT32,
    )
    data = rng.standard_normal((n, dims)).astype(np.float32)
    base = (1 << 40) + 7  # far beyond int32
    rowids = base + np.arange(n, dtype=np.int64)
    idx = ShardedIndex(cfg, mesh=make_mesh(4))
    idx.build(rowids, data)
    ids, dists = idx.search(data[:6], k)
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids[:, 0], rowids[:6])


def test_insert_rollback_clears_valid_and_defers_recycling(rng, monkeypatch):
    import duckdb_lm_diskann_tpu.core.coordinator as coord_mod
    from duckdb_lm_diskann_tpu.core import builder

    cfg = LmDiskannConfig(
        metric_type=MetricType.COSINE, r=4, l_insert=8, l_search=16,
        dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    coord = Coordinator(cfg)
    data = rng.standard_normal((20, 8)).astype(np.float32)
    coord.insert(list(range(20)), data)

    real_insert_batch = builder.insert_batch
    calls = {"n": 0}

    def failing_insert_batch(
        arrays, slots, vecs, entry, params,
        pad_to=None, all_valid=False, donate=True,
    ):
        # Store the vectors (marks valid) then die — the mid-insert crash.
        calls["n"] += 1
        arrays = builder.store_vectors(
            arrays,
            __import__("jax.numpy", fromlist=["asarray"]).asarray(slots),
            __import__("jax.numpy", fromlist=["asarray"]).asarray(vecs),
        )
        raise RuntimeError("boom")

    monkeypatch.setattr(coord_mod, "insert_batch", failing_insert_batch)
    new_vecs = rng.standard_normal((4, 8)).astype(np.float32)
    with pytest.raises(RuntimeError):
        coord.insert(list(range(100, 104)), new_vecs)
    monkeypatch.setattr(coord_mod, "insert_batch", real_insert_batch)

    # Rolled-back slots: unmapped, not valid, queued for vacuum (not free).
    assert all(r not in coord.allocator.rowid_to_slot for r in range(100, 104))
    valid = np.asarray(coord.arrays.valid)
    assert len(coord.allocator.pending_deletion) == 4
    for slot in coord.allocator.pending_deletion:
        assert not valid[slot]
    assert not coord.allocator.free_slots  # no immediate recycling

    # Searches never surface the rolled-back slots.
    ids, _ = coord.search(new_vecs, 3)
    assert (ids < 100).all()
    # Vacuum reclaims them.
    assert coord.vacuum() == 4
    assert len(coord.allocator.free_slots) == 4


def test_assume_all_valid_fast_path_is_bit_identical(rng):
    """On a never-tombstoned index the validity gather is the identity, so
    the fast path (assume_all_valid=True, skipping the [B*R] element
    gather) must return bit-identical
    results to the eager path; the first delete must flip the coordinator
    off the fast path and keep excluding tombstoned rows."""
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.common.types import MetricType
    from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.core.searcher import beam_search

    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=8, l_insert=16, alpha=1.2,
        l_search=24, dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    coord = Coordinator(cfg)
    data = rng.standard_normal((120, 8)).astype(np.float32)
    coord.insert(list(range(120)), data)
    assert not coord._ever_tombstoned

    q = jnp.asarray(data[:16] + 0.01)
    kw = dict(params=coord.params, l_search=24, k=5)
    fast = beam_search(coord.arrays, q, jnp.int32(coord.entry_slot),
                       assume_all_valid=True, **kw)
    slow = beam_search(coord.arrays, q, jnp.int32(coord.entry_slot),
                       assume_all_valid=False, **kw)
    np.testing.assert_array_equal(
        np.asarray(fast.topk_slots), np.asarray(slow.topk_slots))
    np.testing.assert_array_equal(
        np.asarray(fast.visited_slots), np.asarray(slow.visited_slots))
    np.testing.assert_array_equal(
        np.asarray(fast.topk_dists), np.asarray(slow.topk_dists))

    # snapshot inherits the flag
    assert not coord.snapshot()._ever_tombstoned

    # first delete flips the flag; tombstoned rows stay excluded
    coord.delete([5])
    assert coord._ever_tombstoned
    assert coord.snapshot()._ever_tombstoned
    ids, _ = coord.search(data[5][None, :], 3)
    assert 5 not in ids[0].tolist()


def test_delete_with_duplicate_rowids_in_one_batch(rng):
    """A rowid listed twice in one delete batch is ONE delete; the second
    occurrence is skipped like a missing row (round-4 fix: the second
    free() used to pop an unmapped rowid and raise KeyError)."""
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=4, l_insert=8, l_search=16,
        dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    cfg.validate()
    coord = Coordinator(cfg)
    data = rng.standard_normal((40, 8)).astype(np.float32)
    coord.bulk_build(list(range(40)), data)
    assert coord.delete([3, 7, 3, 11, 7, 3]) == 3
    assert coord.count == 37
    ids, _ = coord.search(data[:1], 5, l_search=16)
    assert not {3, 7, 11} & set(ids.ravel().tolist())


def test_allocate_batch_atomic_on_duplicate(rng):
    """Regression (round-4 review): a duplicate rowid mid-batch must not
    leave earlier batch rowids permanently mapped to ghost slots."""
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=4, l_insert=8, l_search=16,
        dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    cfg.validate()
    coord = Coordinator(cfg)
    data = rng.standard_normal((12, 8)).astype(np.float32)
    coord.bulk_build(list(range(10)), data[:10])
    with pytest.raises(KeyError):
        coord.insert([100, 7], data[10:12])  # 7 already present
    assert 100 not in coord.allocator.rowid_to_slot
    assert coord.count == 10
    coord.insert([100], data[10:11])  # still insertable
    assert coord.count == 11
    with pytest.raises(KeyError):
        coord.insert([200, 200], data[10:12])  # in-batch duplicate
    assert 200 not in coord.allocator.rowid_to_slot


def test_failed_first_insert_resets_entry(rng, monkeypatch):
    """Regression (round-4 review): a failed FIRST insert must reset the
    bootstrap entry point, or every later insert computes step=0 forever."""
    from duckdb_lm_diskann_tpu.core import builder, coordinator

    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=4, l_insert=8, l_search=16,
        dimensions=8, node_vector_type=VectorType.FLOAT32,
    )
    cfg.validate()
    coord = Coordinator(cfg)
    data = rng.standard_normal((6, 8)).astype(np.float32)

    calls = {"n": 0}
    real = builder.insert_batch

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # after the bootstrap store, before batch 2
            raise RuntimeError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(coordinator, "insert_batch", failing)
    with pytest.raises(RuntimeError, match="injected"):
        coord.insert(list(range(6)), data)
    assert coord.count == 0
    assert coord.entry_slot == -1

    monkeypatch.setattr(coordinator, "insert_batch", real)
    coord.insert(list(range(6)), data)  # the index recovers fully
    assert coord.count == 6
    ids, _ = coord.search(data[:1], 1, l_search=16)
    assert ids[0, 0] == 0


def test_grouped_delete_scan_matches_per_round(rng, monkeypatch):
    """Delete-repair dispatch fusion (builder.delete_repair_scan): stacking
    equal-width repair rounds into one lax.scan must be bit-identical to
    dispatching them one by one — same graph, same valid mask, same search
    results. The 160-row delete below yields multi-round scan groups
    (adjacency multiplicity > 1), so the scan path really executes."""
    from duckdb_lm_diskann_tpu.core import builder

    n, d = 500, 12
    data = rng.standard_normal((n, d)).astype(np.float32)
    cfg = LmDiskannConfig(
        metric_type=MetricType.L2, r=8, l_insert=16, l_search=32,
        dimensions=d, node_vector_type=VectorType.FLOAT32,
    )
    cfg.validate()

    def build():
        c = Coordinator(cfg, initial_capacity=n)
        c.bulk_build(list(range(n)), data, max_batch=64)
        return c

    picks = rng.choice(n, 160, replace=False).tolist()

    c_scan = build()
    c_single = build()
    groups = builder.group_repair_rounds  # grouped (production) path
    forced_kinds: list[str] = []  # group kinds the forced path dispatched

    def force_singletons(rounds):
        out = [("one", t, e) for t, e in rounds]
        forced_kinds.extend(k for k, _, _ in out)
        return out

    # monkeypatch (not raw assignment) so the hook is always restored, and
    # record what the forced path actually produced: if a future refactor
    # binds group_repair_rounds at import time instead of call time, the
    # hook stops taking effect and the emptiness assertion below fails
    # loudly instead of letting both sides silently run the grouped path.
    monkeypatch.setattr(builder, "group_repair_rounds", force_singletons)
    c_single.delete(picks)
    monkeypatch.setattr(builder, "group_repair_rounds", groups)
    assert forced_kinds, "forced-singleton hook never ran; parity is vacuous"
    assert all(k == "one" for k in forced_kinds)
    # Sanity: the production grouping actually produces scan groups here.
    nbr = np.asarray(c_scan.arrays.neighbors[
        __import__("jax.numpy", fromlist=["asarray"]).asarray(
            np.asarray([c_scan.allocator.rowid_to_slot[r] for r in picks],
                       np.int32))])
    rounds, _ = builder.plan_delete_repair(
        nbr, np.asarray([c_scan.allocator.rowid_to_slot[r] for r in picks],
                        np.int32), cfg.r)
    assert any(k == "scan" for k, _, _ in groups(rounds))
    c_scan.delete(picks)

    assert (np.asarray(c_scan.arrays.valid)
            == np.asarray(c_single.arrays.valid)).all()
    assert (np.asarray(c_scan.arrays.neighbors)
            == np.asarray(c_single.arrays.neighbors)).all()
    q = rng.standard_normal((8, d)).astype(np.float32)
    ids_a, d_a = c_scan.search(q, 5)
    ids_b, d_b = c_single.search(q, 5)
    assert (ids_a == ids_b).all()
    assert np.allclose(d_a, d_b)

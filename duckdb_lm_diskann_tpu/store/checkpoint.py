"""Checkpoint / load orchestration: graph.lmd + shadow store, two-phase merge.

JAX re-design of the reference's persistence story:

  - Coordinator::SaveIndex/LoadIndex -> StorageManager::SaveIndexContents/
    LoadIndexContents (Coordinator.cpp:239-317; stubbed in the reference at
    StorageManager.cpp:187-239) — implemented here for real.
  - V2 design (Consolidated Proposal:15-26, :96-107, :188-211): graph.lmd
    fixed-size block file + secondary transactional store; checkpoint is an
    idempotent two-phase merge — (1) write + fsync graph.lmd, (2) atomically
    commit lookup/tombstones/checksums/metadata and clear the delta log. A
    crash between phases re-merges harmlessly.
  - Index metadata fields (entry point, count, config, format version)
    mirror index_config.hpp:195-210 / StorageManager.cpp:104-117.
  - Startup reconciliation + recovery (Proposal:88,94,426-429): pending
    deltas detected at load; ``recover`` replays them from the base table
    via IPrimaryStorageService; checksum mismatch -> mark-broken ->
    ``rebuild_from_primary`` (Proposal:429,440).

Block assignment: block_id == device slot. Neighbor ids are serialized as
*row ids* (host-relocatable, reference format); the loader maps them back to
slots through the persisted ``lmd_lookup`` table. Zombie edges (to rows that
died before the checkpoint) serialize as the empty sentinel — a checkpoint
is also a zombie-edge sweep.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..common.types import EdgeType, INVALID_ROW_ID, MetricType, VectorType
from ..core.config import LmDiskannConfig
from ..core.coordinator import Coordinator
from ..core.graph import GraphArrays, make_graph_arrays
from ..ops.quantize import i4_packed_from_planar_np, i4_planar_from_packed_np
from .block_codec import decode_blocks, encode_blocks, resolve_layout
from .file_service import open_block_file
from .shadow import ShadowStorageService


class IndexCorruptionError(RuntimeError):
    """Checksum/reconciliation failure: index is marked broken; rebuild from
    the base table (Proposal:429,440)."""


def _config_to_dict(config: LmDiskannConfig) -> dict:
    return {
        "metric": config.metric_type.value,
        "r": config.r,
        "l_insert": config.l_insert,
        "alpha": config.alpha,
        "l_search": config.l_search,
        "dimensions": config.dimensions,
        "node_vector_type": config.node_vector_type.value,
        "edge_type": config.resolve_edge_type().value,
        "max_visits": config.max_visits,
        "insert_max_visits": config.insert_max_visits,
        "insert_beam_width": config.insert_beam_width,
    }


def _config_from_dict(d: dict) -> LmDiskannConfig:
    return LmDiskannConfig(
        metric_type=MetricType.parse(d["metric"]),
        r=int(d["r"]),
        l_insert=int(d["l_insert"]),
        alpha=float(d["alpha"]),
        l_search=int(d["l_search"]),
        dimensions=int(d["dimensions"]),
        node_vector_type=VectorType(d["node_vector_type"]),
        edge_type=EdgeType.parse(d["edge_type"]),
        max_visits=int(d.get("max_visits", 0)),
        insert_max_visits=int(d.get("insert_max_visits", 0)),
        insert_beam_width=int(d.get("insert_beam_width", 1)),
    )


def save_index(
    coord: Coordinator,
    directory: str | os.PathLike,
    chunk_bytes: int = 64 << 20,
) -> dict:
    """Two-phase checkpoint of a Coordinator into an index directory
    (the per-index directory the reference creates as
    ``<db>.lmd_idx/<index>/``, db/LmDiskannIndex.cpp:165-235).

    Incremental: when the directory already holds a committed checkpoint
    and graph.lmd shut down clean, only rows flagged in
    ``arrays.dirty_rows`` are encoded + written (the V2 dirty-block design,
    Consolidated Proposal:96-107,188-211) via scattered ``write_blocks_at``;
    otherwise the whole file is rewritten. Crash tolerance: the new CRC of
    every block about to be written is STAGED in the shadow store before
    phase 1, so a crash between phases leaves every block matching either
    its committed (old) or staged (new) checksum — the next load recovers
    instead of reporting corruption, and the clean_shutdown flag forces
    that next save to be a full rewrite.

    Returns {"blocks_written", "incremental", "high_water"}.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    layout = resolve_layout(coord.config)
    shadow = ShadowStorageService(directory)
    bf = open_block_file(directory / "graph.lmd", layout.block_size, create=True)
    try:
        hw = coord.allocator.high_water
        arrays = coord.arrays
        prev_hw = shadow.get_metadata("high_water", None)
        incremental = (
            prev_hw is not None
            and not shadow.get_metadata("broken", False)
            and bf.clean_shutdown
            and bf.num_blocks == prev_hw
            and hw >= prev_hw
        )
        if incremental:
            dirty = np.asarray(arrays.dirty_rows[:hw])
            idx = np.nonzero(dirty)[0].astype(np.int64)
        else:
            idx = np.arange(hw, dtype=np.int64)

        slot_rowids = coord._slot_rowids
        et = coord.params.edge_type

        def encode_chunk(sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            """Device -> host pull + block encode + CRC for one chunk of
            slot indices (contiguous ranges pull by slice)."""
            contiguous = len(sel) and sel[0] + len(sel) - 1 == sel[-1] and (
                not incremental
            )
            if contiguous:
                lo, hi = int(sel[0]), int(sel[-1]) + 1

                def pull(a):
                    return np.asarray(a[lo:hi])
            else:
                # coord.arrays may be numpy-backed (the distributed save
                # path hands a host-materialized facade); index with the
                # matching array kind.
                sel_d = (
                    sel
                    if isinstance(arrays.vectors, np.ndarray)
                    else jnp.asarray(sel, jnp.int32)
                )

                def pull(a):
                    return np.asarray(a[sel_d])

            vectors = pull(arrays.vectors)
            neighbors = pull(arrays.neighbors)  # slots
            valid = pull(arrays.valid)
            # slot -> rowid for neighbor serialization; dead -> sentinel.
            nbr_rowids = np.where(
                neighbors >= 0,
                slot_rowids[np.maximum(neighbors, 0)],
                np.int64(INVALID_ROW_ID),
            )
            # valid-masked: blocks of dead slots serialize zeroed.
            nbr_rowids = np.where(
                valid[:, None], nbr_rowids, np.int64(INVALID_ROW_ID)
            )
            kw = {}
            if et is EdgeType.TERNARY:
                kw["edge_pos"] = pull(arrays.edge_pos)
                kw["edge_neg"] = pull(arrays.edge_neg)
            elif et is EdgeType.INT8:
                kw["edge_i8"] = pull(arrays.edge_i8)
                kw["edge_scale"] = pull(arrays.edge_scale)
            elif et is EdgeType.INT4:
                # device planar words -> the disk block format's
                # byte-interleaved packing (ops/quantize.words_per_i4)
                kw["edge_i4"] = i4_packed_from_planar_np(
                    pull(arrays.edge_i4), coord.config.dimensions
                )
                kw["edge_scale"] = pull(arrays.edge_scale)
            elif et is EdgeType.FLOAT32 or et is EdgeType.FLOAT16:
                kw["edge_f32"] = pull(arrays.edge_f32)
            elif et is EdgeType.FLOAT1BIT:
                kw["edge_pos"] = pull(arrays.edge_pos)
            blocks = encode_blocks(coord.config, vectors, nbr_rowids, **kw)
            blocks[~valid] = 0
            return blocks, bf.crc32_rows(blocks)

        # Pipelined two-phase write (the V2 flush-daemon design,
        # Consolidated Proposal:96-107): per chunk — stage its CRCs, then
        # hand the blocks to the store's background writer thread and start
        # pulling/encoding the next chunk while the previous one hits disk.
        # Crash safety is per block: every block on disk matches either its
        # committed (old) or staged (new) CRC at all times, so staging
        # chunk-by-chunk preserves the recovery invariant.
        shadow.clear_staged_checksums()
        bf.mark_dirty(True)
        if not incremental:
            bf.truncate(hw)
        checksums_all: list[np.ndarray] = []
        chunk_rows = max(1, chunk_bytes // layout.block_size)
        for lo in range(0, len(idx), chunk_rows):
            sel = idx[lo : lo + chunk_rows]
            blocks, crc = encode_chunk(sel)
            checksums_all.append(crc)
            shadow.stage_checksums(sel, crc)
            if incremental:
                bf.submit_write_at(sel, blocks)
            else:
                bf.submit_write(int(sel[0]), blocks)
        # Drain the writer BEFORE reading num_blocks: the worker thread
        # mutates the header's block count as scattered writes land, so the
        # read is only well-defined at quiescence.
        bf.flush_wait(bf.submit_sync())
        if incremental and bf.num_blocks < hw:
            bf.truncate(hw)  # slots allocated but never written stay 0
            bf.sync()
        checksums = (
            np.concatenate(checksums_all)
            if checksums_all
            else np.empty(0, np.uint32)
        )

        # Phase 2: transactional shadow commit (clears delta log + staged).
        shadow.commit_checkpoint(
            lookup=dict(coord.allocator.rowid_to_slot),
            tombstones=coord.allocator.pending_deletion,
            checksums={int(b): int(v) for b, v in zip(idx, checksums)},
            metadata={
                "format_version": 3,
                "config": _config_to_dict(coord.config),
                "entry_rowid": coord.entry_rowid,
                "count": coord.count,
                "high_water": hw,
                "free_slots": coord.allocator.free_slots,
                "broken": False,
            },
            incremental=incremental,
        )
        bf.mark_dirty(False)
        zeros_like = (
            np.zeros_like
            if isinstance(arrays.dirty_rows, np.ndarray)
            else jnp.zeros_like
        )
        coord.arrays = arrays._replace(dirty_rows=zeros_like(arrays.dirty_rows))
        coord.dirty = False
        return {
            "blocks_written": int(len(idx)),
            "incremental": bool(incremental),
            "high_water": hw,
        }
    finally:
        bf.close()
        shadow.close()


def _load_host_state(
    directory: str | os.PathLike, verify_checksums: bool = True
) -> dict:
    """Read + verify an index directory into HOST (numpy) state: the shared
    first half of every loader. Returns a dict with the config, allocator
    state, and per-field row data at high_water length — callers place it
    on one device (:func:`load_index`) or row-sharded over a mesh
    (parallel.global_graph.load_global_sharded / sharded.load_sharded)."""
    directory = Path(directory)
    shadow = ShadowStorageService(directory)
    try:
        cfg_dict = shadow.get_metadata("config")
        if cfg_dict is None:
            raise FileNotFoundError(f"no index metadata in {directory}")
        config = _config_from_dict(cfg_dict)
        layout = resolve_layout(config)
        hw = int(shadow.get_metadata("high_water", 0))
        if shadow.get_metadata("broken", False):
            raise IndexCorruptionError(
                f"index at {directory} is marked broken; rebuild from the "
                "base table (rebuild_from_primary)"
            )
        pending = shadow.pending_deltas()

        bf = open_block_file(directory / "graph.lmd", layout.block_size, create=False)
        try:
            blocks = bf.read_blocks(0, min(hw, bf.num_blocks)) if hw else (
                np.empty((0, layout.block_size), np.uint8)
            )
            if verify_checksums and hw:
                want = shadow.load_checksums()
                staged = shadow.load_staged_checksums()
                got = bf.crc32_rows(blocks)
                # A block is consistent if it matches its committed CRC or
                # a staged (phase-1-written, never-committed) CRC — the two
                # states a crash between checkpoint phases can leave.
                bad = [
                    i
                    for i in range(len(got))
                    if want.get(i) not in (None, int(got[i]))
                    and staged.get(i) != int(got[i])
                ]
                if bad:
                    shadow.set_metadata("broken", True)
                    raise IndexCorruptionError(
                        f"checksum mismatch in blocks {bad[:8]} of "
                        f"{directory}/graph.lmd; index marked broken"
                    )
        finally:
            bf.close()

        decoded = decode_blocks(config, blocks)
        lookup = shadow.load_lookup()  # rowid -> slot
        tombstones = shadow.load_tombstones()
        free_slots = [int(s) for s in shadow.get_metadata("free_slots", [])]

        # rowid -> slot translation for serialized neighbor ids.
        rowid_keys = np.asarray(sorted(lookup), np.int64)
        slot_vals = np.asarray([lookup[int(r)] for r in rowid_keys], np.int32)
        nbr_rowids = decoded["neighbor_rowids"]  # [hw, R]
        if hw and len(rowid_keys):
            pos = np.searchsorted(rowid_keys, nbr_rowids)
            pos = np.clip(pos, 0, max(len(rowid_keys) - 1, 0))
            hit = (
                (len(rowid_keys) > 0)
                & (nbr_rowids >= 0)
                & (rowid_keys[pos] == nbr_rowids)
            )
            nbr_slots = np.where(hit, slot_vals[pos], -1).astype(np.int32)
        else:
            # hw rows with an empty lookup = a checkpoint taken after every
            # row was deleted: blocks exist, nothing resolves.
            nbr_slots = np.full((hw, config.r), -1, np.int32)

        vec_dtype = (
            np.int8
            if config.node_vector_type is VectorType.INT8
            else np.float32
        )
        valid_hw = np.zeros(hw, bool)
        for slot in lookup.values():
            if slot < hw:
                valid_hw[slot] = True
        fields = {
            "vectors": decoded["vectors"].astype(vec_dtype)
            if hw
            else np.zeros((0, config.dimensions), vec_dtype),
            "neighbors": nbr_slots,
            "valid": valid_hw,
        }
        et = config.resolve_edge_type()
        if hw:
            if et is EdgeType.TERNARY:
                fields["edge_pos"] = decoded["edge_pos"]
                fields["edge_neg"] = decoded["edge_neg"]
            elif et is EdgeType.INT8:
                fields["edge_i8"] = decoded["edge_i8"]
                fields["edge_scale"] = decoded["edge_scale"]
            elif et is EdgeType.INT4:
                fields["edge_i4"] = i4_planar_from_packed_np(
                    decoded["edge_i4"], config.dimensions
                )
                fields["edge_scale"] = decoded["edge_scale"]
            elif et is EdgeType.FLOAT32 or et is EdgeType.FLOAT16:
                fields["edge_f32"] = decoded["edge_f32"]
            elif et is EdgeType.FLOAT1BIT:
                fields["edge_pos"] = decoded["edge_pos"]

        return {
            "config": config,
            "hw": hw,
            "lookup": lookup,
            "tombstones": tombstones,
            "free_slots": free_slots,
            "pending": pending,
            "entry_rowid": shadow.get_metadata("entry_rowid", INVALID_ROW_ID),
            "fields": fields,
        }
    finally:
        shadow.close()


def _host_graph_arrays(params, cap: int, st: dict) -> list[np.ndarray]:
    """Full-capacity HOST arrays (ordered per GraphArrays._fields) from a
    ``_load_host_state`` dict: zeros (-1 for neighbors) past high_water."""
    proto = make_graph_arrays(params, 1)
    hw = st["hw"]
    out = []
    for name, f in zip(GraphArrays._fields, proto):
        shape = (cap,) + tuple(f.shape[1:])
        if name == "neighbors":
            a = np.full(shape, -1, np.dtype(f.dtype))
        else:
            a = np.zeros(shape, np.dtype(f.dtype))
        rows = st["fields"].get(name)
        if rows is not None and hw:
            a[:hw] = rows
        out.append(a)
    return out


def _restore_coordinator_meta(
    coord: Coordinator, st: dict, cap: int, entry_fallback=None
) -> None:
    """Fill allocator / rowid maps / recovery flags from host state.
    ``entry_fallback``: zero-arg callable returning (slot, rowid) when the
    persisted entry rowid is gone — loaders pass their engine-appropriate
    re-selection (single-chip vs row-sharded); it runs AFTER the allocator
    state is in place. When it needs the graph arrays, callers instead
    leave it None and restore the entry themselves after placing arrays."""
    sr = np.full(cap, INVALID_ROW_ID, np.int64)
    for rowid, slot in st["lookup"].items():
        coord.allocator.rowid_to_slot[rowid] = slot
        coord.allocator.slot_to_rowid[slot] = rowid
        sr[slot] = rowid
    coord._slot_rowids = sr
    coord.allocator.high_water = st["hw"]
    coord.allocator.free_slots = st["free_slots"]
    coord.allocator.pending_deletion = st["tombstones"]
    # A loaded index with any tombstoned/freed slots (or pending deltas
    # to replay) may hold zombie in-edges: searches must keep the
    # validity gather (see Coordinator._ever_tombstoned).
    coord._ever_tombstoned = bool(
        st["tombstones"] or st["free_slots"] or st["pending"]
    )
    coord.dirty = False
    coord.needs_recovery = bool(st["pending"])
    coord.pending_deltas = st["pending"]
    entry_rowid = st["entry_rowid"]
    if entry_rowid in st["lookup"]:
        coord.entry_slot = st["lookup"][entry_rowid]
        coord.entry_rowid = entry_rowid
    elif st["lookup"] and entry_fallback is not None:
        coord.entry_slot, coord.entry_rowid = entry_fallback()


def load_index(
    directory: str | os.PathLike, verify_checksums: bool = True
) -> Coordinator:
    """Load an index directory back into a Coordinator."""
    st = _load_host_state(directory, verify_checksums)
    config, hw, lookup = st["config"], st["hw"], st["lookup"]
    coord = Coordinator(config, initial_capacity=max(1024, hw))
    cap = coord.capacity
    _restore_coordinator_meta(coord, st, cap)
    host = _host_graph_arrays(coord.params, cap, st)
    coord.arrays = GraphArrays(*(jnp.asarray(a) for a in host))
    # Entry fallback needs the arrays (degree scan): restore it here.
    if st["entry_rowid"] not in lookup and lookup:
        coord.entry_slot, coord.entry_rowid = coord._select_fallback_entry()
    return coord


def recover(index, primary, directory: str | os.PathLike) -> int:
    """Replay un-merged deltas after a crash (startup reconciliation,
    Proposal:426-429). ``primary`` is a PrimaryStorageService for re-reading
    vectors of rows whose blocks never reached graph.lmd. Returns the number
    of deltas replayed; saves a clean checkpoint afterwards.

    ``index`` is a Coordinator or any index-like exposing
    insert/delete/save and a ``.coordinator`` (GlobalShardedIndex: the
    replay then runs through the row-sharded DML path, so crash recovery
    works for indexes bigger than one chip too).

    The delta log is replayed in sequence order, but consecutive runs of
    the SAME op are coalesced into one batched insert/delete: distinct-row
    inserts commute within a run (and likewise deletes), so batching
    preserves the log's semantics while replacing O(N) single-row device
    dispatches with O(N / batch) ramped batched ones — the difference
    between hours and seconds at a 100k-delta backlog (replay cost == the
    engine's bulk-insert rate; see docs/DURABILITY.md for the bound and
    the auto-checkpoint trigger that caps the backlog)."""
    coord = getattr(index, "coordinator", index)
    pending = getattr(coord, "pending_deltas", [])
    replayed = 0
    run_op: str | None = None
    run_rows: list[int] = []
    run_set: set[int] = set()

    def flush():
        nonlocal replayed, run_op
        if not run_rows:
            return
        if run_op == "insert":
            vecs = np.atleast_2d(
                np.asarray(primary.get_vectors(run_rows), np.float32)
            )
            index.insert(run_rows, vecs)
        else:
            index.delete(run_rows)
        replayed += len(run_rows)
        run_rows.clear()
        run_set.clear()

    for _seq, op, row_id, _block_id in pending:
        in_run = run_op == op and row_id in run_set
        queued_insert = run_op == "insert" and row_id in run_set
        queued_delete = run_op == "delete" and row_id in run_set
        applied = row_id in coord.allocator.rowid_to_slot
        if op == "insert":
            # Skip rows already applied (idempotent replay) or duplicated
            # within the current run — UNLESS the row's delete is queued in
            # the current un-flushed run: then this is the insert half of a
            # crash-logged update (delete r, insert r) and must re-apply
            # after the deletes flush, or the update's row is lost.
            if in_run or (applied and not queued_delete):
                continue
        else:  # delete: only meaningful if the row exists or is queued
            if in_run or (not applied and not queued_insert):
                continue
        if op != run_op:
            flush()  # applies any queued opposite-op rows first (ordering)
            run_op = op
        run_rows.append(row_id)
        run_set.add(row_id)
    flush()
    coord.needs_recovery = False
    coord.pending_deltas = []
    if index is coord:
        save_index(coord, directory)
    elif hasattr(index, "save"):
        index.save(directory)
    elif hasattr(index, "persist_to_disk"):
        # db.LmDiskannIndex checkpoints into its own directory.
        index.persist_to_disk()
    else:
        raise TypeError(
            f"recover(): {type(index).__name__} exposes neither save() nor "
            "persist_to_disk()"
        )
    return replayed


def rebuild_from_primary(
    config: LmDiskannConfig, primary, rowids, directory: str | os.PathLike
) -> Coordinator:
    """Last-resort recovery: rebuild the whole index from the base table
    (mark-index-broken path, Proposal:429,440)."""
    coord = Coordinator(config)
    vectors = primary.get_vectors(rowids)
    coord.bulk_build(list(rowids), np.asarray(vectors, np.float32))
    save_index(coord, directory)
    return coord

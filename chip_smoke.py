"""End-to-end smoke test of the LM-DiskANN engine on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py           # one card: the SIFT-1M-shaped index
    python chip_smoke.py --multi   # four cards: the two sharded modes only

Every phase goes through the entry points a user calls (``db.connect()``,
``create_table``, ``create_index``, ``knn_join``, ``knn``, table DML,
``checkpoint``) with corpora generated from fixed seeds, and prints one JSON
progress line with its wall time. Answers are checked against an exact
brute-force top-k computed at ``precision=HIGHEST`` with a float64 re-rank,
independent of the engine. Nothing is caught: a failed check raises, and the
process exits non-zero without printing the final line. Where JAX finds no
GPU the script exits non-zero before doing any work.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 10
RECALL_MIN = 0.95  # the reference-parity contract (BASELINE.md)
SIFT_OPTIONS = {
    "metric": "l2", "r": 64, "l_insert": 128, "alpha": 1.2,
    "edge_type": "int4", "l_search": 100,
}
GIST_OPTIONS = {
    "metric": "cosine", "r": 64, "l_insert": 128, "alpha": 1.2,
    "edge_type": "ternary", "l_search": 128,
}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Scale of each phase. ``FULL`` is what the script runs; tests run the
    same phases at a few thousand rows on the CPU."""

    sift_rows: int = 1_000_000
    queries: int = 4096
    single_queries: int = 16
    gist_rows: int = 131_072
    gist_queries: int = 1024
    mutate_rows: int = 1000
    persist_rows: int = 100_000
    persist_queries: int = 256
    codec_lanes: int = 1024
    codec_capacity: int = 4096
    lanes: int = 1024
    prune_targets: int = 2048
    multi_rows: int = 1_000_000
    global_rows: int = 262_144
    global_batch: int = 1024
    global_deletes: int = 1000


FULL = Sizes()


def emit(phase: str, t0: float, **fields) -> None:
    line = {"phase": phase, "seconds": round(time.perf_counter() - t0, 3)}
    line.update(fields)
    print(json.dumps(line), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpu(count: int = 1):
    """Phase 1: the card, or exit non-zero. There is no CPU fallback."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.exit(
            f"chip_smoke: needs {count} GPU(s); JAX found "
            f"{len(devices)} {devices[0].platform} device(s)"
        )
    return devices


def _memory(dev) -> dict:
    stats = dev.memory_stats() or {}
    return {
        k: stats.get(k)
        for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    }


# --------------------------------------------------------------------- #
# the reference: exact brute force, independent of the engine


def _chunk_topk_fn(metric: str, kc: int):
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def chunk_topk(q, b):
        dot = jnp.matmul(q, b.T, precision=hi)
        if metric == "l2":
            d = jnp.sum(b * b, -1)[None, :] - 2.0 * dot
        elif metric == "cosine":
            nb = jnp.sqrt(jnp.sum(b * b, -1))
            d = -dot / jnp.where(nb > 0, nb, 1.0)[None, :]
        else:
            d = -dot
        neg, idx = jax.lax.top_k(-d, min(kc, b.shape[0]))
        return -neg, idx

    return chunk_topk


def exact_topk(queries, base, base_ids, metric: str, k: int = K,
               chunk: int = 131_072) -> np.ndarray:
    """Exact top-k row ids: 4k candidates per query from a HIGHEST-precision
    matmul scan over base chunks, re-ranked by float64 distances on the
    host (ties to the smaller row id)."""
    import jax.numpy as jnp

    kc = 4 * k
    fn = _chunk_topk_fn(metric, kc)
    q = jnp.asarray(queries, jnp.float32)
    cand_d, cand_i = [], []
    for off in range(0, len(base), chunk):
        d, i = fn(q, jnp.asarray(base[off : off + chunk], jnp.float32))
        cand_d.append(np.asarray(d))
        cand_i.append(np.asarray(i) + off)
    cd, ci = np.concatenate(cand_d, 1), np.concatenate(cand_i, 1)
    keep = np.argsort(cd, axis=1, kind="stable")[:, :kc]
    ci = np.take_along_axis(ci, keep, 1)  # [Q, kc] base positions
    qv = np.asarray(queries, np.float64)[:, None, :]
    bv = np.asarray(base, np.float64)[ci]
    if metric == "l2":
        d64 = np.sqrt(((qv - bv) ** 2).sum(-1))
    elif metric == "cosine":
        num = (qv * bv).sum(-1)
        den = np.linalg.norm(qv, axis=-1) * np.linalg.norm(bv, axis=-1)
        d64 = 1.0 - num / np.where(den > 0, den, 1.0)
    else:
        d64 = -(qv * bv).sum(-1)
    ids = np.asarray(base_ids, np.int64)[ci]
    order = np.lexsort((ids, d64), axis=1)[:, :k]
    return np.take_along_axis(ids, order, 1)


def recall_at_k(ids: np.ndarray, truth: np.ndarray) -> float:
    k = truth.shape[1]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, truth))
    return hits / (len(truth) * k)


def _check_recall(phase: str, recall: float) -> None:
    if recall < RECALL_MIN:
        raise AssertionError(f"{phase}: recall@10 {recall:.4f} < {RECALL_MIN}")


def _join_ids(db, table, queries) -> tuple[np.ndarray, np.ndarray, float]:
    t0 = time.perf_counter()
    res = db.knn_join(table, "vec", queries, K)
    secs = time.perf_counter() - t0
    return res["row_ids"].reshape(-1, K), res["distance"].reshape(-1, K), secs


def _queries(data, n, rng):
    idx = rng.integers(0, len(data), n)
    noise = 0.01 * rng.standard_normal((n, data.shape[1])).astype(np.float32)
    return (data[idx] + noise).astype(np.float32)


# --------------------------------------------------------------------- #
# single-card phases


def build_phase(db, name: str, rows: int, dims: int, options: dict,
                seed: int):
    """Phase 2 (and 5): corpus -> table -> CREATE INDEX (bulk build)."""
    import jax

    from duckdb_lm_diskann_tpu.utils.corpora import make_manifold_corpus

    t0 = time.perf_counter()
    gen, rng = make_manifold_corpus(dims, seed)
    data = gen(rows)
    table = db.create_table(name, {"vec": data})
    t1 = time.perf_counter()
    index = db.create_index(f"{name}_idx", table, "vec", options=options)
    jax.block_until_ready(index.coordinator.arrays)
    build_s = time.perf_counter() - t1
    timings = index.coordinator.build_timings
    steady = timings[len(timings) // 2 :]
    steady_rate = sum(r for r, _ in steady) / max(sum(s for _, s in steady), 1e-9)
    emit(
        f"build_{name}", t0, rows=rows, dims=dims,
        metric=options["metric"], edge_type=options["edge_type"],
        build_seconds=round(build_s, 3),
        steady_inserts_per_second=round(steady_rate, 1),
        insert_batches=len(timings),
        memory=_memory(jax.devices()[0]),
    )
    return table, index, data, rng


def serve_phase(db, table, index, data, rng, sizes: Sizes):
    """Phase 3: knn_join + single-query knn against the exact reference."""
    t0 = time.perf_counter()
    queries = _queries(data, sizes.queries, rng)
    _join_ids(db, table, queries)  # compile
    ids, _, secs = _join_ids(db, table, queries)
    truth = exact_topk(queries, data, table.row_ids, "l2")
    recall = recall_at_k(ids, truth)
    _check_recall("serve", recall)
    single = [
        db.knn(table, "vec", queries[i], K, metric="l2")["row_ids"]
        for i in range(sizes.single_queries)
    ]
    bucket_ids, _ = index.coordinator.search(
        queries[: sizes.single_queries], K, pad_to_bucket=True
    )
    for i, got in enumerate(single):
        if set(got.tolist()) != set(ids[i].tolist()):
            raise AssertionError(f"knn({i}) differs from knn_join's row {i}")
        if set(bucket_ids[i].tolist()) != set(ids[i].tolist()):
            raise AssertionError(f"pad_to_bucket row {i} differs from knn_join")
    emit(
        "serve", t0, queries=len(queries), k=K,
        l_search=SIFT_OPTIONS["l_search"], recall_at_10=round(recall, 4),
        knn_join_qps=round(len(queries) / secs, 1),
        single_knn_checked=len(single),
    )
    return queries, truth


def _popcount(x: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1)
    return bits.reshape(*x.shape, 32).sum(-1, dtype=np.int64)


def edge_codec_case(edge: str, dims: int, metric: str, lanes: int,
                    capacity: int, seed: int = 0):
    """Score ``lanes`` visited nodes' R cached edge codes with the engine's
    plain-XLA scorer (searcher._score_edges) on the default device, and the
    same from the NumPy codecs in float64. Returns (device, reference)."""
    import jax
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
    from duckdb_lm_diskann_tpu.core.graph import GraphParams, make_graph_arrays
    from duckdb_lm_diskann_tpu.core.searcher import _score_edges
    from duckdb_lm_diskann_tpu.ops.quantize import (
        decode_int4_np,
        decode_int8_np,
        encode_int4_np,
        encode_int8_np,
        i4_planar_from_packed_np,
    )
    from duckdb_lm_diskann_tpu.ops.ternary import encode_ternary_np

    et, mt = EdgeType.parse(edge), MetricType.parse(metric)
    R = 64
    params = GraphParams(
        dims=dims, r=R, metric=mt, edge_type=et, alpha=1.2, l_insert=128,
        l_search=100, max_visits=400,
    )
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((capacity, dims)).astype(np.float32)
    nbrs = rng.integers(0, capacity, (capacity, R)).astype(np.int32)
    ev = vecs[nbrs]  # [C, R, D] each node's neighbours' own vectors
    arrays = make_graph_arrays(params, capacity)._replace(
        vectors=jnp.asarray(vecs), neighbors=jnp.asarray(nbrs),
        valid=jnp.ones((capacity,), bool),
    )
    cur = rng.integers(0, capacity, (lanes, 1)).astype(np.int32)
    queries = rng.standard_normal((lanes, dims)).astype(np.float32)
    q64 = queries.astype(np.float64)[:, None, None, :]
    if et in (EdgeType.TERNARY, EdgeType.FLOAT1BIT):
        pos, neg = encode_ternary_np(ev)
        qp, qn = encode_ternary_np(queries)
        arrays = arrays._replace(edge_pos=jnp.asarray(pos))
        cp = pos[cur]  # [B, 1, R, W]
        qp4, qn4 = qp[:, None, None, :], qn[:, None, None, :]
        if et is EdgeType.TERNARY:
            arrays = arrays._replace(edge_neg=jnp.asarray(neg))
            cn = neg[cur]
            sim = (_popcount(qp4 & cp) - _popcount(qp4 & cn)
                   - _popcount(qn4 & cp) + _popcount(qn4 & cn)).sum(-1)
        else:
            sim = dims - 2 * _popcount(qp4 ^ cp).sum(-1)
        ref = np.float32(1.0) - sim.astype(np.float32)  # cosine, exact ints
        q_pos, q_neg = jnp.asarray(qp), jnp.asarray(qn)
    else:
        if et is EdgeType.INT8:
            codes, scale = encode_int8_np(ev)
            arrays = arrays._replace(
                edge_i8=jnp.asarray(codes), edge_scale=jnp.asarray(scale))
            dec = decode_int8_np(codes, scale)
        elif et is EdgeType.INT4:
            packed, scale = encode_int4_np(ev)
            arrays = arrays._replace(
                edge_i4=jnp.asarray(i4_planar_from_packed_np(packed, dims)),
                edge_scale=jnp.asarray(scale))
            dec = decode_int4_np(packed, scale, dims)
        elif et is EdgeType.FLOAT16:
            arrays = arrays._replace(edge_f32=jnp.asarray(ev.astype(np.float16)))
            dec = ev.astype(np.float16)
        elif et is EdgeType.FLOAT32:
            arrays = arrays._replace(edge_f32=jnp.asarray(ev))
            dec = ev
        else:  # NONE scores the neighbours' own vectors
            dec = ev
        b = dec.astype(np.float64)[cur]  # [B, 1, R, D]
        if mt is MetricType.L2:
            ref = np.sqrt(((q64 - b) ** 2).sum(-1))
        elif mt is MetricType.COSINE:
            den = np.linalg.norm(q64, axis=-1) * np.linalg.norm(b, axis=-1)
            ref = 1.0 - (q64 * b).sum(-1) / np.where(den > 0, den, 1.0)
        else:
            ref = -(q64 * b).sum(-1)
        q_pos = q_neg = jnp.zeros((lanes, 1), jnp.uint32)
    score = jax.jit(_score_edges, static_argnums=1)
    cur_d = jnp.asarray(cur)
    out = score(arrays, params, cur_d, jnp.asarray(queries), q_pos, q_neg,
                arrays.neighbors[cur_d])
    return np.asarray(out), ref


CODEC_CASES = (
    ("ternary", 960, "cosine"),
    ("float1bit", 960, "cosine"),
    ("int8", 128, "l2"),
    ("int4", 128, "l2"),
    ("float16", 128, "l2"),
    ("float32", 128, "l2"),
    ("int4", 96, "cosine"),
    ("none", 128, "l2"),
)


def codec_phase(sizes: Sizes) -> None:
    """Phase 4: every edge codec at real widths against NumPy float64.
    Popcount codecs must be bit-exact; the rest differ only by reduction
    order (elementwise math, no matmul), so rtol = atol = 1e-5."""
    t0 = time.perf_counter()
    report = {}
    for edge, dims, metric in CODEC_CASES:
        got, ref = edge_codec_case(
            edge, dims, metric, sizes.codec_lanes, sizes.codec_capacity
        )
        if got.shape != ref.shape:
            raise AssertionError(f"{edge}: shape {got.shape} != {ref.shape}")
        if edge in ("ternary", "float1bit"):
            if not np.array_equal(got, ref):
                raise AssertionError(f"{edge}: popcount scores not bit-exact")
            dev = 0.0
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{edge} {dims}d {metric}")
            dev = float(np.max(np.abs(got - ref)))
        report[f"{edge}_{dims}d_{metric}"] = dev
    emit("edge_codecs", t0, lanes=sizes.codec_lanes, r=64,
         max_abs_deviation=report)


def ternary_phase(db, sizes: Sizes) -> None:
    """Phase 5: 960d cosine index with TERNARY edge codes, end to end."""
    t0 = time.perf_counter()
    table, index, data, rng = build_phase(
        db, "gist", sizes.gist_rows, 960, GIST_OPTIONS, seed=0x61577
    )
    queries = _queries(data, sizes.gist_queries, rng)
    _join_ids(db, table, queries)
    ids, _, secs = _join_ids(db, table, queries)
    recall = recall_at_k(ids, exact_topk(queries, data, table.row_ids, "cosine"))
    _check_recall("ternary", recall)
    emit("ternary_serve", t0, queries=len(queries),
         l_search=GIST_OPTIONS["l_search"], recall_at_10=round(recall, 4),
         knn_join_qps=round(len(queries) / secs, 1))
    hop_phase(index, queries, sizes, "ternary_960d")
    db.drop_index(table, "gist_idx")
    del db.tables["gist"]


def mutate_phase(db, table, index, queries, sizes: Sizes) -> None:
    """Phase 6: delete rows (the search then pays the neighbour-validity
    gather), insert new ones, search again."""
    import jax

    from duckdb_lm_diskann_tpu.utils.corpora import make_manifold_corpus

    t0 = time.perf_counter()
    rng = np.random.default_rng(0xDE1E7E)
    gone = rng.choice(table.row_ids, sizes.mutate_rows, replace=False)
    t1 = time.perf_counter()
    table.delete(gone)
    jax.block_until_ready(index.coordinator.arrays)
    delete_s = time.perf_counter() - t1
    gen, _ = make_manifold_corpus(table.columns["vec"].shape[1], 0x1A5E27)
    t1 = time.perf_counter()
    table.insert({"vec": gen(sizes.mutate_rows)})
    jax.block_until_ready(index.coordinator.arrays)
    insert_s = time.perf_counter() - t1
    if not index.coordinator._ever_tombstoned:
        raise AssertionError("delete did not tombstone any slot")
    ids, _, secs = _join_ids(db, table, queries)
    if np.isin(ids, gone).any():
        raise AssertionError("a deleted row id was returned")
    truth = exact_topk(queries, table.columns["vec"], table.row_ids, "l2")
    recall = recall_at_k(ids, truth)
    _check_recall("mutate", recall)
    emit("mutate", t0, deleted=len(gone), inserted=sizes.mutate_rows,
         delete_seconds=round(delete_s, 3), insert_seconds=round(insert_s, 3),
         recall_at_10=round(recall, 4),
         knn_join_qps_incl_compile=round(len(queries) / secs, 1))


def persist_phase(sizes: Sizes) -> None:
    """Phase 7: build -> checkpoint -> reopen; every answer must survive."""
    from duckdb_lm_diskann_tpu.db.database import connect
    from duckdb_lm_diskann_tpu.store import file_service
    from duckdb_lm_diskann_tpu.utils.corpora import make_manifold_corpus

    t0 = time.perf_counter()
    gen, rng = make_manifold_corpus(128, 0x9E25)
    data = gen(sizes.persist_rows)
    queries = _queries(data, sizes.persist_queries, rng)

    def answers(db, table):
        ids, dists, _ = _join_ids(db, table, queries)
        single = [db.knn(table, "vec", q, K, metric="l2") for q in queries[:8]]
        return ids, dists, single

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke")
        db = connect(path)
        table = db.create_table("p", {"vec": data})
        db.create_index("p_idx", table, "vec", options=SIFT_OPTIONS)
        before = answers(db, table)
        t1 = time.perf_counter()
        db.checkpoint()
        ckpt_s = time.perf_counter() - t1
        del db, table
        db = connect(path)
        table = db.create_table("p", {"vec": data})
        index = db.create_index("p_idx", table, "vec", options=SIFT_OPTIONS)
        if index.coordinator.build_timings:
            raise AssertionError("reopen rebuilt the index instead of loading")
        after = answers(db, table)
    for a, b in zip(before[:2], after[:2]):
        if not np.array_equal(a, b):
            raise AssertionError("knn_join answers changed across reopen")
    for a, b in zip(before[2], after[2]):
        if not (np.array_equal(a["row_ids"], b["row_ids"])
                and np.array_equal(a["distance"], b["distance"])):
            raise AssertionError("knn answers changed across reopen")
    emit("persist", t0, rows=sizes.persist_rows,
         checkpoint_seconds=round(ckpt_s, 3),
         block_store="native" if file_service._load_lib() else "python")


# --------------------------------------------------------------------- #
# phase 8: measurements kept as findings (printed, not gated)


def _computations(hlo: str) -> dict[str, list[str]]:
    comps, cur = {}, None
    for line in hlo.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\) -> .* \{$", line)
        if m:
            cur = comps.setdefault(m.group(1), [])
        elif line == "}":
            cur = None
        elif cur is not None:
            cur.append(line.strip())
    return comps


def _shape(type_str: str) -> tuple[str, int]:
    """``u32[1024,64,16]{2,1,0}`` -> ("u32", 1048576)."""
    m = re.match(r"(\w+)\[([\d,]*)\]", type_str)
    if not m:
        return type_str, -1
    dims = [int(x) for x in m.group(2).split(",") if x]
    return m.group(1), int(np.prod(dims, dtype=np.int64))


def _fused(comps: dict[str, list[str]]) -> dict[str, tuple[str, str]]:
    """Fused computation -> (calling computation, calling fusion line)."""
    callers = {}
    for name, lines in comps.items():
        for line in lines:
            m = re.search(r"calls=%?([\w.\-]+)", line)
            if m and " fusion(" in line:
                callers[m.group(1)] = (name, line)
    return callers


def gather_fusion_report(hlo: str, table_type: str) -> dict:
    """Where the optimized HLO gathers rows of the edge-code table of type
    ``table_type`` (e.g. ``u32[1048576,64,16]``; reshaped views count):
    the gather's computation and, for a fused gather, the calling fusion's
    output. The gathered codes are materialised in device memory when that
    output is the gather's own result."""
    comps = _computations(hlo)
    callers = _fused(comps)
    want = _shape(table_type)
    found = []
    for name, lines in comps.items():
        tables = {  # parameters, tuple elements or views holding the table
            m.group(1) for ln in lines
            if (m := re.match(r"(?:ROOT )?%?([\w.\-]+) = (\S+) ", ln))
            and _shape(m.group(2)) == want
        }
        for line in lines:
            m = re.match(
                r"(?:ROOT )?%?([\w.\-]+) = (\S+) gather\(%?([\w.\-]+),", line
            )
            if not m or m.group(3) not in tables:
                continue
            entry = {"gather": m.group(2).split("{")[0], "in": name}
            if name in callers:
                call = callers[name][1]
                fm = re.match(r"(?:ROOT )?%?([\w.\-]+) = (.+?) fusion\(", call)
                kind = re.search(r"kind=(\w+)", call)
                root = next((ln for ln in lines if ln.startswith("ROOT")), "")
                entry.update(
                    fusion=fm.group(1),
                    fusion_output=fm.group(2).split("{")[0],
                    fusion_kind=kind.group(1) if kind else None,
                    fusion_root_op=root.split("=", 1)[-1].split("(")[0].split()[-1]
                    if root else None,
                    codes_materialized=m.group(2).split("{")[0]
                    in fm.group(2),
                )
            else:
                entry["codes_materialized"] = True
            found.append(entry)
    return {"gathers": found}


def _score_fusions(hlo: str) -> set[str]:
    """Unfused-level instructions of the optimized HLO (the kernels that
    run) that carry, or call a fused computation carrying, the
    ``edge_score`` named scope."""
    comps = _computations(hlo)
    callers = _fused(comps)
    scoped = {n for n, ls in comps.items() if any("edge_score" in l for l in ls)}
    names = set()
    for comp, lines in comps.items():
        if comp in callers:
            continue
        for line in lines:
            m = re.match(r"(?:ROOT )?%?([\w.\-]+) = ", line)
            if not m:
                continue
            call = re.search(r"calls=%?([\w.\-]+)", line)
            if "edge_score" in line.split("metadata=")[-1] or (
                call and call.group(1) in scoped
            ):
                names.add(m.group(1))
    return names


def _op_names(hlo: str) -> dict[str, str]:
    """Kernel name (dots as underscores) -> the jax op_name metadata of the
    unfused-level HLO instruction that launches it."""
    out = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*op_name=\"([^\"]+)\"", line)
        if m:
            out.setdefault(m.group(1).replace(".", "_"), m.group(2))
    return out


def _device_kernel_times(trace_dir: str) -> dict[str, float]:
    """Summed device time (ns) per kernel name, from the xplane trace."""
    import jax

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    prof = jax.profiler.ProfileData.from_file(path)
    best: dict[str, float] = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # one line per view of the same kernels: keep the busiest
            times: dict[str, float] = {}
            for ev in line.events:
                times[ev.name] = times.get(ev.name, 0.0) + ev.duration_ns
            if sum(times.values()) > sum(best.values()):
                best = times
    return best


def hop_phase(index, queries, sizes: Sizes, label: str) -> None:
    """Phase 8a: does XLA fuse the edge-code gather into the scoring, and
    what share of the stream loop's device time is the scoring stage."""
    import jax
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core.searcher import beam_search_stream

    t0 = time.perf_counter()
    coord = index.coordinator
    arrays = coord.arrays
    q = jnp.asarray(queries)
    entry = jnp.asarray([coord.entry_slot], jnp.int32)
    kw = dict(params=coord.params, l_search=coord.config.l_search, k=K,
              lanes=sizes.lanes, assume_all_valid=not coord._ever_tombstoned)
    hlo = beam_search_stream.lower(arrays, q, entry, **kw).compile().as_text()
    table = arrays.edge_i4 if arrays.edge_i4.size else arrays.edge_pos
    shape = f"{table.dtype.name.replace('uint', 'u')}[{','.join(map(str, table.shape))}]"
    report = gather_fusion_report(hlo, shape)
    score_ops = _score_fusions(hlo)
    res = beam_search_stream(arrays, q, entry, **kw)
    jax.block_until_ready(res)
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            res = beam_search_stream(arrays, q, entry, **kw)
            jax.block_until_ready(res)
        kernels = _device_kernel_times(tdir)
    norm = {n.replace(".", "_") for n in score_ops} | score_ops
    score_ns = sum(t for n, t in kernels.items() if n in norm)
    total_ns = sum(kernels.values())
    hops = int(res.hops)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    ops = _op_names(hlo)
    emit(
        f"hop_{label}", t0, edge_table=shape, hops=hops, **report,
        score_ops=sorted(score_ops),
        device_ms_total=round(total_ns / 1e6, 3),
        score_stage_ms=round(score_ns / 1e6, 3) if score_ns else None,
        score_share=round(score_ns / total_ns, 4) if total_ns else None,
        hop_us=round(total_ns / 1e3 / max(hops, 1), 3),
        top_kernels_ms={n: round(t / 1e6, 3) for n, t in top},
        top_kernel_ops={n: ops.get(n.replace(".", "_")) for n, _ in top},
    )


def merge_phase(index, queries, sizes: Sizes) -> dict:
    """Phase 8b: stream QPS with the bitonic merge and with lax.sort,
    alternating, best of three each; the answers must be identical."""
    import jax
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core.searcher import beam_search_stream

    t0 = time.perf_counter()
    coord = index.coordinator
    q = jnp.asarray(queries)
    entry = jnp.asarray([coord.entry_slot], jnp.int32)
    outs, best = {}, {True: 0.0, False: 0.0}
    for _ in range(4):  # first round warms both programs
        for bitonic in (True, False):
            p = dataclasses.replace(coord.params, bitonic=bitonic)
            t1 = time.perf_counter()
            res = beam_search_stream(
                coord.arrays, q, entry, params=p,
                l_search=coord.config.l_search, k=K, lanes=sizes.lanes,
                assume_all_valid=not coord._ever_tombstoned,
            )
            jax.block_until_ready(res)
            qps = len(queries) / (time.perf_counter() - t1)
            if bitonic in outs:
                best[bitonic] = max(best[bitonic], qps)
            outs[bitonic] = res
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(outs[True][:2], outs[False][:2])
    )
    if not same:
        raise AssertionError("bitonic and lax.sort merges disagree")
    result = {"stream_qps_bitonic": round(best[True], 1),
              "stream_qps_lax_sort": round(best[False], 1)}
    emit("merge", t0, queries=len(queries), lanes=sizes.lanes,
         default_bitonic=coord.params.bitonic, **result)
    return result


def prune_phase(index, data, sizes: Sizes) -> None:
    """Phase 8c: RobustPrune's candidate matmul at default precision
    against HIGHEST, on real insert-search candidate sets [T, 256, 128]."""
    import jax
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core.builder import batched_robust_prune
    from duckdb_lm_diskann_tpu.core.searcher import search_for_initial_candidates
    from duckdb_lm_diskann_tpu.ops.distance import batched_all_pairs_distance

    t0 = time.perf_counter()
    coord = index.coordinator
    p = coord.params
    rng = np.random.default_rng(0x9A0E)
    nodes = jnp.asarray(
        data[rng.choice(len(data), sizes.prune_targets, replace=False)]
    )
    cands = search_for_initial_candidates(
        coord.arrays, nodes, jnp.int32(coord.entry_slot), params=p,
        l_insert=coord.config.l_insert,
        assume_all_valid=not coord._ever_tombstoned,
    ).visited_slots  # [T, 2 * l_insert]
    vecs = coord.arrays.vectors[jnp.maximum(cands, 0)]
    selfs = jnp.full((sizes.prune_targets,), -1, jnp.int32)
    dist = jax.jit(batched_all_pairs_distance, static_argnums=1)
    out = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            out[prec] = (
                np.asarray(dist(vecs, p.prune_metric)),
                np.asarray(batched_robust_prune(
                    coord.arrays, nodes, cands, selfs, params=p)),
            )
    d_lo, sel_lo = out["default"]
    d_hi, sel_hi = out["highest"]
    changed = sum(
        len(set(a[a >= 0].tolist()) ^ set(b[b >= 0].tolist()))
        for a, b in zip(sel_lo, sel_hi)
    )
    dev = np.abs(d_lo - d_hi)
    emit(
        "prune_precision", t0, shape=list(vecs.shape),
        max_abs_deviation=float(np.max(dev)),
        p99_abs_deviation=float(np.percentile(dev, 99)),
        median_abs_distance=float(np.median(np.abs(d_hi))),
        max_rel_deviation=float(
            np.max(np.abs(d_lo - d_hi) / np.maximum(np.abs(d_hi), 1e-6))),
        decisions_changed=changed,
        decision_share_changed=changed / cands.size,
        rows_with_changed_edges=int(sum(
            set(a.tolist()) != set(b.tolist()) for a, b in zip(sel_lo, sel_hi)
        )),
    )


def run_single(sizes: Sizes = FULL) -> None:
    """Phases 2-8 on the default device."""
    from duckdb_lm_diskann_tpu.db.database import connect

    db = connect()
    table, index, data, rng = build_phase(
        db, "sift", sizes.sift_rows, 128, SIFT_OPTIONS, seed=0xBE7C4
    )
    queries, _ = serve_phase(db, table, index, data, rng, sizes)
    codec_phase(sizes)
    ternary_phase(db, sizes)
    # The measurements read the index before any delete, as served.
    hop_phase(index, queries, sizes, "int4_128d")
    merge_phase(index, queries, sizes)
    prune_phase(index, data, sizes)
    mutate_phase(db, table, index, queries, sizes)
    persist_phase(sizes)


# --------------------------------------------------------------------- #
# --multi: the sharded modes on four cards


def _mismatch(ids, dists, ref_ids, ref_dists) -> dict | None:
    """None when ids and distances equal the single-card answer exactly;
    otherwise how far apart they are."""
    if np.array_equal(ids, ref_ids) and np.array_equal(dists, ref_dists):
        return None
    same = ids == ref_ids
    return {
        "ids_equal": float(same.mean()),
        "rows_equal": float(same.all(1).mean()),
        "max_dist_diff_where_ids_agree": float(
            np.abs(np.where(same, dists - ref_dists, 0.0)).max()),
    }


def run_multi(sizes: Sizes = FULL, n_devices: int = 4) -> None:
    """Disjoint shards over ``n_devices`` cards, then the global graph
    against the single-card engine."""
    from duckdb_lm_diskann_tpu.common.types import VectorType
    from duckdb_lm_diskann_tpu.core.config import parse_options
    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.parallel.global_graph import GlobalShardedIndex
    from duckdb_lm_diskann_tpu.parallel.mesh import make_mesh
    from duckdb_lm_diskann_tpu.parallel.sharded import ShardedIndex
    from duckdb_lm_diskann_tpu.utils.corpora import make_manifold_corpus

    mesh = make_mesh(n_devices)
    config = parse_options(SIFT_OPTIONS)
    config.dimensions = 128
    config.node_vector_type = VectorType.FLOAT32

    t0 = time.perf_counter()
    gen, rng = make_manifold_corpus(128, 0xBE7C4)
    data = gen(sizes.multi_rows)
    queries = _queries(data, sizes.queries, rng)
    sharded = ShardedIndex(config, mesh=mesh)
    t1 = time.perf_counter()
    sharded.build(np.arange(len(data)), data)
    build_s = time.perf_counter() - t1
    sharded.search(queries, K)  # compile
    t1 = time.perf_counter()
    ids, _ = sharded.search(queries, K)
    secs = time.perf_counter() - t1
    truth = exact_topk(queries, data, np.arange(len(data)), "l2")
    recall = recall_at_k(ids, truth)
    _check_recall("sharded", recall)
    for dev, coord in zip(mesh.devices.flat, sharded.coordinators):
        if coord.arrays.vectors.devices() != {dev}:
            raise AssertionError(f"a shard's rows are not on {dev}")
    mem = [_memory(d)["bytes_in_use"] for d in mesh.devices.flat]
    if None not in mem and min(mem) * n_devices < max(mem):
        raise AssertionError(f"shards not spread over the cards: {mem}")
    emit("multi_disjoint", t0, rows=len(data), shards=n_devices,
         build_seconds=round(build_s, 3), recall_at_10=round(recall, 4),
         qps=round(len(queries) / secs, 1), bytes_in_use_per_device=mem)
    del sharded

    t0 = time.perf_counter()
    gdata = data[: sizes.global_rows]
    gq = queries[: sizes.gist_queries]
    coord = Coordinator(config, initial_capacity=len(gdata))
    coord.bulk_build(list(range(len(gdata))), gdata,
                     max_batch=sizes.global_batch)
    ids_1, d_1 = coord.search(gq, K)
    gidx = GlobalShardedIndex(coord, mesh=mesh)
    ids_g, d_g = gidx.search(gq, K)
    mismatch = {"search": _mismatch(ids_g, d_g, ids_1, d_1)}
    coord_d = Coordinator(config, initial_capacity=len(gdata))
    gidx_d = GlobalShardedIndex(coord_d, mesh=mesh)
    t1 = time.perf_counter()
    gidx_d.distributed_build(list(range(len(gdata))), gdata,
                             max_batch=sizes.global_batch)
    dbuild_s = time.perf_counter() - t1
    ids_d, d_d = gidx_d.search(gq, K)
    mismatch["distributed_build"] = _mismatch(ids_d, d_d, ids_1, d_1)
    gone = list(range(sizes.global_deletes))
    coord.delete(gone)
    gidx_d.delete(gone)
    ids_1, d_1 = coord.search(gq, K)
    ids_d, d_d = gidx_d.search(gq, K)
    mismatch["distributed_delete"] = _mismatch(ids_d, d_d, ids_1, d_1)
    emit("multi_global", t0, rows=len(gdata), queries=len(gq),
         distributed_build_seconds=round(dbuild_s, 3), deletes=len(gone),
         mismatch_vs_single_card=mismatch,
         bytes_in_use_per_device=[
             _memory(d)["bytes_in_use"] for d in mesh.devices.flat])
    failed = [what for what, m in mismatch.items() if m is not None]
    if failed:
        raise AssertionError(f"global graph differs from one card: {failed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded modes")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1

    t0 = time.perf_counter()
    devices = require_gpu(count)
    import jax

    from duckdb_lm_diskann_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(_nvidia_smi(), flush=True)
    emit("device", t0, jax=jax.__version__, platform=devices[0].platform,
         kind=devices[0].device_kind, count=len(devices),
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache)
    if args.multi:
        run_multi()
    else:
        run_single()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

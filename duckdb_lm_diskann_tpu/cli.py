"""Command-line interface: build / search / info / compact / verify / bench.

The M6 surface of SURVEY §7.2. Vectors are exchanged as .npy files
(float32 [N, D]); indexes live in ``<path>.lmd_idx/<name>/`` directories
exactly like the library API.

Examples:
    python -m duckdb_lm_diskann_tpu.cli build  --db /tmp/db --index idx \
        --vectors vecs.npy --metric l2 --r 64
    python -m duckdb_lm_diskann_tpu.cli search --db /tmp/db --index idx \
        --queries q.npy --k 10 --out results.npy
    python -m duckdb_lm_diskann_tpu.cli info   --db /tmp/db --index idx
    python -m duckdb_lm_diskann_tpu.cli compact --db /tmp/db --index idx
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _load_index(args):
    from .store import checkpoint

    directory = Path(f"{args.db}.lmd_idx") / args.index
    return checkpoint.load_index(directory), directory


def cmd_build(args) -> int:
    from .core.config import parse_options
    from .core.coordinator import Coordinator
    from .core.graph import derive_vector_type
    from .store import checkpoint

    vectors = np.load(args.vectors)
    options = {}
    if args.metric:
        options["metric"] = args.metric
    for key in ("r", "l_insert", "l_search"):
        v = getattr(args, key)
        if v:
            options[key] = v
    if args.alpha:
        options["alpha"] = args.alpha
    if args.edge_type:
        options["edge_type"] = args.edge_type
    config = parse_options(options)
    config.dimensions = vectors.shape[1]
    config.node_vector_type = derive_vector_type(vectors)
    config.validate()

    t0 = time.perf_counter()
    coord = Coordinator(config, initial_capacity=len(vectors))
    rowids = (
        np.load(args.rowids).tolist() if args.rowids else list(range(len(vectors)))
    )
    coord.bulk_build(rowids, vectors.astype(np.float32), max_batch=args.batch)
    build_s = time.perf_counter() - t0
    directory = Path(f"{args.db}.lmd_idx") / args.index
    checkpoint.save_index(coord, directory)
    print(
        json.dumps(
            {
                "built": len(vectors),
                "seconds": round(build_s, 2),
                "directory": str(directory),
            }
        )
    )
    return 0


def cmd_search(args) -> int:
    coord, _ = _load_index(args)
    queries = np.load(args.queries).astype(np.float32)
    t0 = time.perf_counter()
    ids, dists = coord.search(queries, args.k, l_search=args.l_search or None)
    elapsed = time.perf_counter() - t0
    if args.out:
        np.save(args.out, ids)
        np.save(str(args.out).replace(".npy", "") + "_dists.npy", dists)
    else:
        for b in range(min(len(ids), 10)):
            print(ids[b].tolist())
    print(
        json.dumps(
            {
                "queries": len(queries),
                "k": args.k,
                "seconds": round(elapsed, 4),
                "qps": round(len(queries) / elapsed, 1),
            }
        ),
        file=sys.stderr,
    )
    return 0


def cmd_info(args) -> int:
    coord, directory = _load_index(args)
    print(
        json.dumps(
            {
                "index": args.index,
                "directory": str(directory),
                "count": coord.count,
                "capacity": coord.capacity,
                "metric": coord.config.metric_type.value,
                "edge_type": coord.config.resolve_edge_type().value,
                "dimensions": coord.config.dimensions,
                "r": coord.config.r,
                "l_insert": coord.config.l_insert,
                "l_search": coord.config.l_search,
                "alpha": coord.config.alpha,
                "entry_rowid": coord.entry_rowid,
                "in_memory_size": coord.get_in_memory_size(),
                "pending_deletes": len(coord.allocator.pending_deletion),
                "needs_recovery": getattr(coord, "needs_recovery", False),
            },
            indent=2,
        )
    )
    return 0


def cmd_compact(args) -> int:
    from .store import checkpoint

    coord, directory = _load_index(args)
    recycled = coord.vacuum()
    checkpoint.save_index(coord, directory)
    print(json.dumps({"recycled_slots": recycled}))
    return 0


def cmd_verify(args) -> int:
    from .utils.verify import VerificationError, verify_graph

    coord, _ = _load_index(args)
    try:
        report = verify_graph(coord)
    except VerificationError as e:
        print(json.dumps({"ok": False, "problems": str(e)}))
        return 1
    print(json.dumps({"ok": True, **report}))
    return 0


def cmd_bench(args) -> int:
    """Query benchmark against a built index: QPS, recall@k (vs brute force
    over the index's own vectors, or a supplied ground-truth .npy), and
    per-batch latency percentiles — the CLI face of the M6 bench surface
    (SURVEY §7.2), reporting the BASELINE.json north-star metrics."""
    import jax.numpy as jnp

    from .ops.distance import all_pairs_distance

    coord, _ = _load_index(args)
    queries = np.load(args.queries).astype(np.float32)
    n_q = len(queries)
    k = args.k
    l_search = args.l_search or None
    batch = args.batch

    # Ground truth: supplied file, else exact brute force — one
    # [B, D] @ [D, N] matmul per chunk at HIGHEST precision (O(B*N)
    # memory, base matrix uploaded once).
    if args.ground_truth:
        gt = np.load(args.ground_truth)[:, :k]
    else:
        valid = np.asarray(coord.arrays.valid)
        rowids = coord.allocator.rowids_array(coord.capacity)
        base = jnp.asarray(np.asarray(coord.arrays.vectors, np.float32))
        gt = np.empty((n_q, k), np.int64)
        chunk = max(1, 2**24 // max(1, coord.capacity))
        for i in range(0, n_q, chunk):
            dm = np.array(
                all_pairs_distance(
                    jnp.asarray(queries[i : i + chunk]),
                    base,
                    coord.config.metric_type,
                )
            )
            dm[:, ~valid] = np.inf
            idx = np.argsort(dm, axis=1)[:, :k]
            gt[i : i + chunk] = rowids[idx]

    # Pad the query set to a batch multiple: a ragged final batch would
    # retrace + recompile INSIDE the timed loop and corrupt p99/QPS.
    n_pad = (-n_q) % batch
    if n_pad:
        queries = np.concatenate([queries, queries[:1].repeat(n_pad, 0)])
    coord.search(queries[:batch], k, l_search=l_search)  # warmup/compile

    lat_ms = []
    all_ids = np.empty((len(queries), k), np.int64)
    t0 = time.perf_counter()
    for i in range(0, len(queries), batch):
        tb = time.perf_counter()
        ids, _ = coord.search(queries[i : i + batch], k, l_search=l_search)
        lat_ms.append((time.perf_counter() - tb) * 1e3)
        all_ids[i : i + batch] = ids
    elapsed = time.perf_counter() - t0

    # -1 is the empty-result sentinel on both sides; never count it a hit.
    recall = float(
        np.mean(
            [
                len(set(all_ids[i]) & set(gt[i]) - {-1}) / k
                for i in range(n_q)
            ]
        )
    )
    print(
        json.dumps(
            {
                "queries": n_q,
                "k": k,
                "l_search": l_search or coord.config.l_search,
                "batch": batch,
                "qps": round(len(queries) / elapsed, 1),
                "recall_at_k": round(recall, 4),
                "p50_batch_ms": round(float(np.percentile(lat_ms, 50)), 2),
                "p99_batch_ms": round(float(np.percentile(lat_ms, 99)), 2),
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="duckdb_lm_diskann_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build")
    b.add_argument("--db", required=True)
    b.add_argument("--index", required=True)
    b.add_argument("--vectors", required=True)
    b.add_argument("--rowids")
    b.add_argument("--metric", default="")
    b.add_argument("--r", type=int, default=0)
    b.add_argument("--l-insert", dest="l_insert", type=int, default=0)
    b.add_argument("--l-search", dest="l_search", type=int, default=0)
    b.add_argument("--alpha", type=float, default=0.0)
    b.add_argument("--edge-type", dest="edge_type", default="")
    b.add_argument("--batch", type=int, default=1024)
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search")
    s.add_argument("--db", required=True)
    s.add_argument("--index", required=True)
    s.add_argument("--queries", required=True)
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--l-search", dest="l_search", type=int, default=0)
    s.add_argument("--out")
    s.set_defaults(fn=cmd_search)

    bn = sub.add_parser("bench")
    bn.add_argument("--db", required=True)
    bn.add_argument("--index", required=True)
    bn.add_argument("--queries", required=True)
    bn.add_argument("--k", type=int, default=10)
    bn.add_argument("--l-search", dest="l_search", type=int, default=0)
    bn.add_argument("--ground-truth", dest="ground_truth", default="")
    bn.add_argument("--batch", type=int, default=256)
    bn.set_defaults(fn=cmd_bench)

    for name, fn in (("info", cmd_info), ("compact", cmd_compact),
                     ("verify", cmd_verify)):
        c = sub.add_parser(name)
        c.add_argument("--db", required=True)
        c.add_argument("--index", required=True)
        c.set_defaults(fn=fn)

    args = p.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

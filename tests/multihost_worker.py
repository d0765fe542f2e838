"""Worker process for the multi-host CPU test (SURVEY §4: multi-host tests
runnable on CPU via jax.distributed + forked workers).

Each worker is one "host" with 2 virtual CPU devices; Gloo backs the
cross-process collectives that NCCL provides between GPUs.

Usage: python multihost_worker.py <proc_id> <n_procs> <addr> <out.json>
"""

import json
import os
import sys


def main() -> int:
    proc_id, n_procs = int(sys.argv[1]), int(sys.argv[2])
    addr, out_path = sys.argv[3], sys.argv[4]

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from duckdb_lm_diskann_tpu.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu.parallel import multihost

    multihost.initialize_distributed(
        addr, n_procs, proc_id, cpu_collectives="gloo"
    )
    assert jax.process_count() == n_procs, jax.process_count()
    assert jax.device_count() == 2 * n_procs, jax.device_count()
    assert jax.local_device_count() == 2

    rng = np.random.default_rng(7)
    n, d = 240, 16
    data = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((4, d)).astype(np.float32)

    cfg = LmDiskannConfig(
        metric_type=MetricType.L2,
        r=8,
        l_insert=16,
        alpha=1.2,
        l_search=64,
        dimensions=d,
        node_vector_type=VectorType.FLOAT32,
        edge_type=EdgeType.INT8,
    )
    cfg.validate()

    idx = multihost.MultiHostShardedIndex(cfg)
    assert idx.n_shards == 2 * n_procs
    assert len(idx.local_shards) == 2
    idx.build(list(range(n)), data)
    ids, dists = idx.search(queries, 5, l_search=64)

    # The merged result is replicated: every process validates it.
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    brute = np.argsort(d2, axis=-1, kind="stable")[:, :5]
    overlap = np.mean(
        [
            len(set(ids[b].tolist()) & set(brute[b].tolist())) / 5.0
            for b in range(len(queries))
        ]
    )
    # Global-graph mode across processes: ONE graph row-sharded over the
    # 4-device global mesh, per-hop psum row exchange crossing the process
    # boundary — results must be ID-EXACT vs the single-chip search of the
    # same graph (the BASELINE result-equivalence mandate, SURVEY §7.3).
    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.parallel.global_graph import GlobalShardedIndex

    coord = Coordinator(cfg, initial_capacity=256)
    coord.bulk_build(list(range(n)), data)  # deterministic on every process
    ids_single, dists_single = coord.search(queries, 5, l_search=64)
    gidx = GlobalShardedIndex(coord)
    assert gidx.n_shards == 2 * n_procs
    ids_global, dists_global = gidx.search(queries, 5, l_search=64)
    exact = bool(
        np.array_equal(ids_single, ids_global)
        and np.allclose(dists_single, dists_global)
    )
    assert exact, (ids_single.tolist(), ids_global.tolist())

    # Multi-process checkpoint: distributed build (row-sharded across the
    # two processes) -> per-process block scatter-writes + proc-0 shadow
    # commit -> every process re-loads from the shared directory -> search
    # must be ID/distance-exact vs the pre-save index.
    from duckdb_lm_diskann_tpu.parallel.global_graph import (
        load_global_sharded,
    )

    ckpt = os.path.join(os.path.dirname(out_path), "gsi_ckpt")
    coord_d = Coordinator(cfg, initial_capacity=8)
    gidx_d = GlobalShardedIndex(coord_d)
    gidx_d.distributed_build(list(range(n)), data, max_batch=64)
    info = gidx_d.save(ckpt)
    assert info["blocks_written"] > 0
    ids_d0, dist_d0 = gidx_d.search(queries, 5, l_search=64)
    g2 = load_global_sharded(ckpt)
    ids_d1, dist_d1 = g2.search(queries, 5, l_search=64)
    ckpt_exact = bool(
        np.array_equal(ids_d0, ids_d1) and np.array_equal(dist_d0, dist_d1)
    )
    assert ckpt_exact, (ids_d0.tolist(), ids_d1.tolist())

    result = {
        "proc": proc_id,
        "devices": jax.device_count(),
        "overlap": float(overlap),
        "global_exact": exact,
        "ckpt_exact": ckpt_exact,
        "ids": ids.tolist(),
    }
    if proc_id == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    assert overlap >= 0.9, f"recall across hosts too low: {overlap}"
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-host scaffolding test: jax.distributed over forked CPU workers.

Proves the sharded search compiles and merges ACROSS PROCESSES (SURVEY §7.2
M5; the single-process 8-device tests in test_sharded.py cover multi-chip
semantics only). Two workers x 2 virtual CPU devices = a 4-shard global
mesh spanning two "hosts", with Gloo carrying the all_gather merge.
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multihost_sharded_search(tmp_path):
    n_procs = 2
    addr = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "result.json"
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    # CPU workers only: drop the parent's device-count flag and platform
    # pin so each worker sets its own before jax.distributed.initialize.
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(n_procs), addr, str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n_procs)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"

    result = json.loads(out.read_text())
    assert result["devices"] == 2 * n_procs
    assert result["overlap"] >= 0.9
    # Cross-process global-graph mode returned single-chip-identical ids.
    assert result["global_exact"] is True
    # Shard-parallel checkpoint (per-process block writes, proc-0 commit)
    # round-tripped ID-exact across processes.
    assert result["ckpt_exact"] is True

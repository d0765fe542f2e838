"""chip_smoke.py's parts that run without a GPU: the device guard, the
exact reference, the codec phase and the optimized-HLO reader."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_guard_exits_nonzero_on_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


def test_script_fails_on_cpu_without_result_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_exact_topk_matches_numpy(rng, metric):
    base = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    ids = np.arange(1000, 1300)
    got = chip_smoke.exact_topk(q, base, ids, metric, k=5, chunk=128)
    if metric == "l2":
        d = ((q[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    elif metric == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        bn = base / np.linalg.norm(base, axis=1, keepdims=True)
        d = -(qn.astype(np.float64) @ bn.T)
    else:
        d = -(q.astype(np.float64) @ base.T)
    want = ids[np.argsort(d, axis=1, kind="stable")[:, :5]]
    np.testing.assert_array_equal(got, want)
    assert chip_smoke.recall_at_k(got, want) == 1.0


def test_codec_phase_at_small_size():
    chip_smoke.codec_phase(
        chip_smoke.Sizes(codec_lanes=8, codec_capacity=128)
    )


def test_gather_fusion_report_reads_optimized_hlo():
    import jax.numpy as jnp

    def score(table, idx, q):
        return jnp.sum((table[idx].astype(jnp.float32) - q[:, None]) ** 2, -1)

    table = jnp.ones((512, 16), jnp.uint32)
    idx = jnp.zeros((8, 4), jnp.int32)
    q = jnp.ones((8, 16), jnp.float32)
    with jax.named_scope("edge_score"):
        hlo = jax.jit(score).lower(table, idx, q).compile().as_text()
    report = chip_smoke.gather_fusion_report(hlo, "u32[512,16]")
    assert report["gathers"], hlo
    for g in report["gathers"]:
        assert g["gather"].startswith("u32[")
        assert isinstance(g["codes_materialized"], bool)


def test_mismatch_reports_distance_to_single_card():
    ids = np.arange(20).reshape(2, 10)
    d = np.linspace(0, 1, 20, dtype=np.float32).reshape(2, 10)
    assert chip_smoke._mismatch(ids, d, ids.copy(), d.copy()) is None
    ids2, d2 = ids.copy(), d.copy()
    ids2[1, 9] = 99
    d2[0, 0] += 1e-6
    m = chip_smoke._mismatch(ids2, d2, ids, d)
    assert m["ids_equal"] == 19 / 20
    assert m["rows_equal"] == 0.5
    assert 0 < m["max_dist_diff_where_ids_agree"] < 2e-6

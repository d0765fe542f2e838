"""Roofline accounting arithmetic (utils/roofline.py — SURVEY M5's
bytes-per-hop vs bandwidth model)."""

import pytest

from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType, VectorType
from duckdb_lm_diskann_tpu.core.graph import GraphParams
from duckdb_lm_diskann_tpu.utils.roofline import (
    device_hbm_gbps,
    edge_code_bytes,
    hop_roofline,
)


def make_params(edge_type, dims=128, r=64, vtype=VectorType.FLOAT32):
    return GraphParams(
        dims=dims, r=r, metric=MetricType.COSINE, edge_type=edge_type,
        alpha=1.2, l_insert=128, l_search=100, max_visits=400,
        node_vtype=vtype,
    )


def test_edge_code_bytes_per_codec():
    # D=128: ternary planes are 2*ceil(128/64)*8 = 32 B; 1bit = 16 B;
    # int8 = 128+4; int4 = 64+4; f32 = 512; f16 = 256; none = 512.
    want = {
        EdgeType.TERNARY: 32,
        EdgeType.FLOAT1BIT: 16,
        EdgeType.INT8: 132,
        EdgeType.INT4: 68,
        EdgeType.FLOAT32: 512,
        EdgeType.FLOAT16: 256,
        EdgeType.NONE: 512,
    }
    for et, b in want.items():
        assert edge_code_bytes(make_params(et)) == b, et


def test_hop_roofline_headline_config():
    # The benchmarked headline: 1M x 128d INT4, B=1024, L=100, W=1.
    p = make_params(EdgeType.INT4)
    rl = hop_roofline(p, batch=1024, l_search=100, mean_visits=104.0,
                      hbm_gbps=3350.0)
    # gather = B*(D*4 + R*4 + R + R*68) = 1024*(512+256+64+4352) = 5,308,416
    assert rl.gather_bytes == 1024 * (512 + 256 + 64 + 64 * 68)
    # state = beam (B*L*9*2) + merge (B*164*12*2)
    assert rl.state_bytes == 1024 * 100 * 9 * 2 + 1024 * 164 * 12 * 2
    # SoL hop time = bytes / BW: ~11.2 MB/hop at 3.35 TB/s, ~3.3 us.
    want_us = (rl.gather_bytes + rl.state_bytes) / 3350e9 * 1e6
    assert rl.sol_hop_us == pytest.approx(want_us)
    assert 3 < rl.sol_hop_us < 4
    # SoL QPS = B / (hops * hop_s), 104 one-visit hops per query.
    assert rl.sol_qps == pytest.approx(1024 / (104 * want_us * 1e-6))


def test_int8_node_vectors_cut_vector_bytes():
    f32 = hop_roofline(make_params(EdgeType.INT4), batch=64, l_search=100,
                       hbm_gbps=3350.0)
    i8 = hop_roofline(
        make_params(EdgeType.INT4, vtype=VectorType.INT8),
        batch=64, l_search=100, hbm_gbps=3350.0,
    )
    assert f32.gather_bytes - i8.gather_bytes == 64 * 128 * 3


def test_device_kind_mapping():
    # H100 SXM5 80 GB, as jax reports its device_kind; NVIDIA data sheet.
    assert device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    # No default peak: dividing by some other device's bandwidth would
    # misstate every roofline share.
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        device_hbm_gbps(kind)

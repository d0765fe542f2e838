"""Analytic roofline accounting for the beam-search hop loop.

SURVEY §7.2 M5 calls for "roofline accounting per operator (bytes from HBM
per hop vs MXU FLOPs)". The reference has no analog (its per-node cost model
is one 4 KB disk page per visit, paper §IV); on an accelerator the
equivalent first-principles model is bytes gathered from device memory per
hop versus the card's memory bandwidth, because frontier scoring is far
below matrix-unit intensity (R-way dot products per gathered row —
arithmetic intensity < 2 FLOP/byte for every edge codec, so the hot loop is
bandwidth/overhead bound, never compute bound).

The model counts the IRREDUCIBLE graph-data traffic — the LM-DiskANN
"one self-contained block per visit" property mapped to SoA gather rows:

    node vectors    B*E*D*vec_bytes      (exact re-rank of each visit)
    neighbor ids    B*E*R*4
    valid mask      B*E*R*1
    edge codes      B*E*R*edge_bytes     (cached neighbor codes)

plus the per-hop beam/sort state working set (read+write of the beam and
the merge buffer), which bounds how low a "perfectly fused" hop could go.
Real hops also pay XLA op-dispatch overheads the model deliberately
excludes — the printed `sol_fraction` (measured speed-of-light fraction)
is exactly the headroom left for kernel-level work.

Peak bandwidths are published figures, keyed by ``device_kind``; a device
that is not in the table is an error, never a default.
"""

from __future__ import annotations

import dataclasses

from ..common.types import EdgeType, VectorType
from ..core.graph import GraphParams

# Published device-memory bandwidth (GB/s) by jax ``device_kind``.
# H100 SXM5 80 GB: 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet).
DEVICE_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def edge_code_bytes(params: GraphParams) -> int:
    """Bytes of cached edge code gathered per (visit, neighbor)."""
    et = params.edge_type
    d = params.dims
    w_bytes = params.words * 4  # u32 words per ternary plane
    if et is EdgeType.TERNARY:
        return 2 * w_bytes
    if et is EdgeType.FLOAT1BIT:
        return w_bytes
    if et is EdgeType.INT8:
        return d + 4  # codes + f32 scale
    if et is EdgeType.INT4:
        return (d + 1) // 2 + 4
    if et is EdgeType.FLOAT32:
        return 4 * d
    if et is EdgeType.FLOAT16:
        return 2 * d
    if et is EdgeType.NONE:
        return 4 * d  # gathers the neighbor's own full vector instead
    raise ValueError(et)


@dataclasses.dataclass(frozen=True)
class HopRoofline:
    gather_bytes: int  # irreducible graph-data HBM reads per hop
    state_bytes: int  # beam/merge working set (read+write) per hop
    flops: int  # useful arithmetic per hop
    sol_hop_us: float  # speed-of-light hop time at the given bandwidth
    sol_qps: float  # SoL throughput for the whole search

    def as_dict(self) -> dict:
        return {
            "gather_bytes_per_hop": self.gather_bytes,
            "state_bytes_per_hop": self.state_bytes,
            "flops_per_hop": self.flops,
            "sol_hop_us": round(self.sol_hop_us, 2),
            "sol_qps": round(self.sol_qps, 1),
        }


def hop_roofline(
    params: GraphParams,
    *,
    batch: int,
    l_search: int,
    beam_width: int = 1,
    mean_visits: float | None = None,
    hbm_gbps: float,
) -> HopRoofline:
    """Per-hop byte/FLOP accounting + speed-of-light QPS.

    ``mean_visits`` is the measured mean visited nodes per query (defaults
    to l_search + 4, the empirical L+epsilon of converged beams); hops per
    query = mean_visits / beam_width (each hop visits ``beam_width`` nodes).
    """
    B, E, R, D, L = batch, beam_width, params.r, params.dims, l_search
    vec_bytes = 1 if params.node_vtype is VectorType.INT8 else 4

    gather = B * E * (D * vec_bytes + R * 4 + R * 1 + R * edge_code_bytes(params))

    # Beam state (dist f32 + slot i32 + vis byte) read+written, plus the
    # sorted-merge buffer of L + E*R keyed triples (dist, slot, vis-i32).
    beam_state = B * L * (4 + 4 + 1) * 2
    merge_buf = B * (L + E * R) * 12 * 2
    state = beam_state + merge_buf

    # Useful arithmetic: exact distance to each visit (2*D FLOPs) + edge
    # scoring (~2*D per neighbor for dequant codecs; popcount algebra
    # counted as 1 op/word-op: TERNARY does 4 AND+popcount plane pairs,
    # FLOAT1BIT one XOR+popcount).
    if params.edge_type is EdgeType.TERNARY:
        edge_flops = B * E * R * params.words * 4
    elif params.edge_type is EdgeType.FLOAT1BIT:
        edge_flops = B * E * R * params.words * 2
    else:
        edge_flops = B * E * R * 2 * D
    flops = B * E * 2 * D + edge_flops

    bw = hbm_gbps * 1e9
    sol_hop_s = (gather + state) / bw
    mv = mean_visits if mean_visits is not None else L + 4.0
    hops_per_query = max(1.0, mv / E)
    sol_qps = B / (hops_per_query * sol_hop_s) if sol_hop_s > 0 else 0.0
    return HopRoofline(
        gather_bytes=int(gather),
        state_bytes=int(state),
        flops=int(flops),
        sol_hop_us=sol_hop_s * 1e6,
        sol_qps=sol_qps,
    )


def device_hbm_gbps(device_kind: str) -> float:
    """Published memory bandwidth of a jax ``device_kind``; raises
    ValueError for a device the table does not list."""
    try:
        return DEVICE_HBM_GBPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(DEVICE_HBM_GBPS)}"
        ) from None

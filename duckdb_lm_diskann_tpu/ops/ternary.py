"""Ternary quantization: sign bit-plane encoding + popcount dot product.

JAX re-design of ``src/lm_diskann/core/ternary_quantization.hpp`` —
the reference's SIMD kernel library (scalar/AVX2/AVX-512/NEON popcount dot,
ternary_quantization.hpp:269-546, runtime dispatch :562-602).

Encoding (ternary_quantization.hpp:146-199):
    value > 0  -> bit set in the positive plane
    value < 0  -> bit set in the negative plane
    value == 0 -> neither
    dimension d lives at bit (d % 64) of 64-bit word (d / 64).

Device arrays use uint32 words (JAX runs 32-bit by default). The bit
layout is the little-endian split of the reference's u64 words: dimension d
-> bit (d % 32) of u32 word (d / 32), and planes are padded to
2*ceil(D/64) u32 words, so reinterpreting the u32 plane as u64 words
reproduces the reference layout byte-for-byte (see store/block_codec.py).

Ternary dot product (ternary_quantization.hpp:44):
    dot = pop(q+ & v+) - pop(q+ & v-) - pop(q- & v+) + pop(q- & v-)

Where the reference dispatches to one of four hand-written SIMD kernels per
CPU, here a single expression of bitwise-AND + ``lax.population_count`` + sum
serves every backend; XLA fuses it with the gather of the codes it scores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import words_per_plane_u32


def encode_ternary(vectors: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Encode float vectors [..., D] into (pos, neg) planes [..., W] uint32.

    jit-safe; EncodeTernary semantics (ternary_quantization.hpp:146-199).
    """
    d = vectors.shape[-1]
    w = words_per_plane_u32(d)
    pad = w * 32 - d
    if pad:
        pad_widths = [(0, 0)] * (vectors.ndim - 1) + [(0, pad)]
        vectors = jnp.pad(vectors, pad_widths)
    # [..., W, 32] bits, bit index = dim % 32
    bits = vectors.reshape(*vectors.shape[:-1], w, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    pos = jnp.sum(
        jnp.where(bits > 0, weights, jnp.uint32(0)), axis=-1, dtype=jnp.uint32
    )
    neg = jnp.sum(
        jnp.where(bits < 0, weights, jnp.uint32(0)), axis=-1, dtype=jnp.uint32
    )
    return pos, neg


def encode_ternary_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NumPy host-side encoder (oracle + persistence codec path)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    d = vectors.shape[-1]
    w = words_per_plane_u32(d)
    pad = w * 32 - d
    if pad:
        pad_widths = [(0, 0)] * (vectors.ndim - 1) + [(0, pad)]
        vectors = np.pad(vectors, pad_widths)
    bits = vectors.reshape(*vectors.shape[:-1], w, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32)).reshape(1, 32)
    pos = ((bits > 0).astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)
    neg = ((bits < 0).astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)
    return pos, neg


def ternary_dot(
    q_pos: jnp.ndarray,
    q_neg: jnp.ndarray,
    v_pos: jnp.ndarray,
    v_neg: jnp.ndarray,
) -> jnp.ndarray:
    """Ternary dot product over trailing word axis; broadcasts leading dims.

    pop(q+ & v+) - pop(q+ & v-) - pop(q- & v+) + pop(q- & v-)
    (ternary_quantization.hpp:44; scalar kernel :269-296).

    Returns int32 scores (higher = more similar), exactly the integer the
    reference's SIMD kernels produce.
    """
    pp = jax.lax.population_count(q_pos & v_pos)
    pn = jax.lax.population_count(q_pos & v_neg)
    np_ = jax.lax.population_count(q_neg & v_pos)
    nn = jax.lax.population_count(q_neg & v_neg)
    return jnp.sum(
        (pp.astype(jnp.int32) - pn.astype(jnp.int32))
        - (np_.astype(jnp.int32) - nn.astype(jnp.int32)),
        axis=-1,
    )


def ternary_similarity(
    query: jnp.ndarray, v_pos: jnp.ndarray, v_neg: jnp.ndarray
) -> jnp.ndarray:
    """ComputeApproxSimilarityTernary (distance.hpp:121-153): encode the float
    query once, then popcount-dot it against stored neighbor planes.

    query: [B, D]; v_pos/v_neg: [B, ..., W] -> similarity [B, ...] float32.
    """
    q_pos, q_neg = encode_ternary(query)
    extra = v_pos.ndim - q_pos.ndim
    if extra:
        shape = q_pos.shape[:1] + (1,) * extra + q_pos.shape[1:]
        q_pos = q_pos.reshape(shape)
        q_neg = q_neg.reshape(shape)
    return ternary_dot(q_pos, q_neg, v_pos, v_neg).astype(jnp.float32)


def ternary_dot_np(
    q_pos: np.ndarray, q_neg: np.ndarray, v_pos: np.ndarray, v_neg: np.ndarray
) -> np.ndarray:
    """NumPy oracle for the ternary dot (tests + host-side verification)."""

    def pop(x):
        return np.vectorize(lambda v: bin(int(v)).count("1"))(x).astype(np.int64)

    return (
        pop(q_pos & v_pos).sum(-1)
        - pop(q_pos & v_neg).sum(-1)
        - pop(q_neg & v_pos).sum(-1)
        + pop(q_neg & v_neg).sum(-1)
    )

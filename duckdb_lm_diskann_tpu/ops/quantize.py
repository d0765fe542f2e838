"""INT8 edge-cache quantization.

The reference stores int8 node vectors as a placeholder direct cast
(GraphManager.cpp:98-107 — flagged in SURVEY Appendix B as a quirk NOT to
copy) and stubs the compressed edge write path. Here INT8 edge caching is a
real abs-max quantization: per-vector scale = max|v| / 127, symmetric, with
the scale stored next to the codes; it is the default edge cache for L2
indexes where ternary codes are invalid (index_config.cpp:93-99).

Frontier scoring dequantizes the codes in-register (codes * scale) inside
the distance computation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def encode_int8(vectors: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """vectors [..., D] float -> (codes int8 [..., D], scales f32 [...]).

    code = round(v / scale) with scale = max|v|/127; all-zero vectors get
    scale 0 and zero codes.
    """
    v = vectors.astype(jnp.float32)
    abs_max = jnp.max(jnp.abs(v), axis=-1)
    scale = abs_max / 127.0
    inv = jnp.where(scale > 0.0, 1.0 / jnp.where(scale > 0.0, scale, 1.0), 0.0)
    codes = jnp.clip(jnp.round(v * inv[..., None]), -127, 127).astype(jnp.int8)
    return codes, scale


def decode_int8(codes: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """codes int8 [..., D], scales [...] -> float32 [..., D]."""
    return codes.astype(jnp.float32) * scales[..., None]


def half_dims(d: int) -> int:
    """Packed byte count of an INT4 code vector: two 4-bit codes per byte
    (the HOST/disk representation; see words_per_i4 for the device one)."""
    return (d + 1) // 2


def words_per_i4(d: int) -> int:
    """u32 words per INT4 code vector in the DEVICE (planar) layout.

    On device, codes are stored 8 nibbles per u32 word, PLANAR: nibble
    slot s of word w holds dim s*DW + w (DW = ceil(D/8)), i.e. the D dims
    are split into 8 contiguous chunks and chunk s occupies bit lane
    [4s, 4s+4) of every word. Unpacking is then 8 shift/mask ops whose
    outputs are already dim-contiguous — no nibble interleave, pure
    elementwise bit math. The HOST/disk block format keeps the
    reference-shaped byte-interleaved packing (block_codec.py); the two
    converters below translate at the host<->device boundary."""
    return (d + 7) // 8


def encode_int4(vectors: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """vectors [..., D] float -> (planar words u32 [..., ceil(D/8)],
    scales [...]).

    code = round(v / scale) clipped to [-7, 7] with scale = max|v|/7,
    stored as two's-complement nibbles in the planar device layout (see
    words_per_i4). 4 bits/dim with magnitudes — between the reference's
    2-bit ternary planes and INT8."""
    v = vectors.astype(jnp.float32)
    D = v.shape[-1]
    dw = words_per_i4(D)
    if D != 8 * dw:
        v = jnp.concatenate(
            [v, jnp.zeros(v.shape[:-1] + (8 * dw - D,), jnp.float32)],
            axis=-1,
        )
    abs_max = jnp.max(jnp.abs(v[..., :D]), axis=-1)
    scale = abs_max / 7.0
    inv = jnp.where(scale > 0.0, 1.0 / jnp.where(scale > 0.0, scale, 1.0), 0.0)
    q = jnp.clip(jnp.round(v * inv[..., None]), -7, 7).astype(jnp.int32)
    u = (q & 0xF).astype(jnp.uint32).reshape(*v.shape[:-1], 8, dw)
    words = u[..., 0, :]
    for s in range(1, 8):
        words = words | (u[..., s, :] << (4 * s))
    return words, scale


def unpack_int4(words: jnp.ndarray, d: int) -> jnp.ndarray:
    """planar words u32 [..., ceil(D/8)] -> signed f32 codes [..., D]."""
    w = words.astype(jnp.int32)
    # sign-extend 4-bit two's complement: (x ^ 8) - 8
    parts = [(((w >> (4 * s)) & 0xF) ^ 8) - 8 for s in range(8)]
    out = jnp.concatenate(parts, axis=-1)
    return out[..., :d].astype(jnp.float32)


def decode_int4(words: jnp.ndarray, scales: jnp.ndarray, d: int) -> jnp.ndarray:
    return unpack_int4(words, d) * scales[..., None]


def i4_planar_from_packed_np(packed: np.ndarray, d: int) -> np.ndarray:
    """HOST: byte-interleaved u8 [..., ceil(D/2)] (the disk block format,
    dim 2i low nibble / 2i+1 high nibble) -> planar device words
    u32 [..., ceil(D/8)]."""
    u = np.asarray(packed).astype(np.uint32)
    dw = words_per_i4(d)
    nib = np.zeros(u.shape[:-1] + (8 * dw,), np.uint32)
    nib[..., 0 : 2 * u.shape[-1] : 2] = u & 0xF
    nib[..., 1 : 2 * u.shape[-1] : 2] = u >> 4
    nib[..., d:] = 0  # odd-D pad nibble must not leak into the words
    nib = nib.reshape(*u.shape[:-1], 8, dw)
    words = nib[..., 0, :].copy()
    for s in range(1, 8):
        words |= nib[..., s, :] << np.uint32(4 * s)
    return words


def i4_packed_from_planar_np(words: np.ndarray, d: int) -> np.ndarray:
    """HOST: planar device words -> byte-interleaved u8 (disk block format)."""
    w = np.asarray(words).astype(np.uint32)
    dw = w.shape[-1]
    nib = np.zeros(w.shape[:-1] + (8 * dw,), np.uint32)
    for s in range(8):
        nib[..., s * dw : (s + 1) * dw] = (w >> np.uint32(4 * s)) & 0xF
    dh = half_dims(d)
    nib = nib[..., : 2 * dh]
    if 2 * dh > d:
        nib[..., d:] = 0
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).astype(np.uint8)


def encode_int4_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = np.asarray(vectors, np.float32)
    if v.shape[-1] % 2:
        v = np.concatenate(
            [v, np.zeros(v.shape[:-1] + (1,), np.float32)], axis=-1
        )
    abs_max = np.max(np.abs(v), axis=-1)
    scale = abs_max / 7.0
    inv = np.where(scale > 0.0, 1.0 / np.where(scale > 0.0, scale, 1.0), 0.0)
    q = np.clip(np.round(v * inv[..., None]), -7, 7).astype(np.int32)
    u = (q & 0xF).astype(np.uint32)
    packed = (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32)


def decode_int4_np(packed: np.ndarray, scales: np.ndarray, d: int) -> np.ndarray:
    u = np.asarray(packed).astype(np.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    out = np.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)
    return out[..., :d].astype(np.float32) * np.asarray(scales)[..., None]


def encode_int8_np(vectors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = np.asarray(vectors, dtype=np.float32)
    abs_max = np.max(np.abs(v), axis=-1)
    scale = abs_max / 127.0
    inv = np.where(scale > 0.0, 1.0 / np.where(scale > 0.0, scale, 1.0), 0.0)
    codes = np.clip(np.round(v * inv[..., None]), -127, 127).astype(np.int8)
    return codes, scale.astype(np.float32)


def decode_int8_np(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return codes.astype(np.float32) * scales[..., None]

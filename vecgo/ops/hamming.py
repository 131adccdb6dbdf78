"""Packed-bit Hamming distance (reference: internal/simd/src/popcount_*.c, simd.Hamming).

Storage stays packed (uint32 words, 32x compression, the whole point of binary
quantization). Scoring has two paths:

1. `hamming_scores` (default): unpack a block of codes to {-1,0,+1} bf16 and use
   a matmul:  hamming(a, b) = (d_valid - a_pm . b_pm) / 2  for +-1 encodings with
   zero padding. Same FLOPs as a d-dim matmul but 32x less HBM traffic, which is
   what matters on a bandwidth-bound scan.

2. `hamming_scores_popcount`: XOR + SWAR popcount on uint32 lanes (VPU). Used as
   the equivalence reference and for tiny candidate sets where the unpack
   doesn't amortize.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def packed_words(d: int) -> int:
    return (d + 31) // 32


def pack_bits(bits: jax.Array) -> jax.Array:
    """Pack boolean/0-1 bits [..., d] into uint32 words [..., ceil(d/32)]."""
    d = bits.shape[-1]
    w = packed_words(d)
    pad = w * 32 - d
    b = bits.astype(jnp.uint32)
    if pad:
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    b = b.reshape(b.shape[:-1] + (w, 32))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jax.Array, d: int) -> jax.Array:
    """Unpack uint32 words [..., W] back to 0/1 int8 bits [..., d]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 32,))
    return bits[..., :d].astype(jnp.int8)


def unpack_to_pm1(packed: jax.Array, d: int, dtype=jnp.bfloat16) -> jax.Array:
    """Unpack to +-1 with zero padding beyond d (so padding is dot-neutral)."""
    bits = unpack_bits(packed, d).astype(dtype)
    return 2.0 * bits - 1.0


def popcount_u32(v: jax.Array) -> jax.Array:
    """SWAR popcount on uint32 lanes."""
    v = v.astype(jnp.uint32)
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((v * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def hamming_scores_popcount(q_packed: jax.Array, x_packed: jax.Array) -> jax.Array:
    """Hamming distances [B, N] via XOR+popcount (reference kernel semantics)."""
    x = jnp.bitwise_xor(q_packed[:, None, :], x_packed[None, :, :])
    return jnp.sum(popcount_u32(x), axis=-1).astype(jnp.float32)


def hamming_scores(q_packed: jax.Array, x_packed: jax.Array, d: int) -> jax.Array:
    """Hamming distances [B, N] via a matrix product (+-1 matmul identity)."""
    qpm = unpack_to_pm1(q_packed, d)
    xpm = unpack_to_pm1(x_packed, d)
    dot = jax.lax.dot_general(
        qpm,
        xpm,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return (d - dot) * 0.5

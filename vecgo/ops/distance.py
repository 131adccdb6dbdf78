"""Batched distance scoring as matrix products.

Replaces the reference's per-pair SIMD kernels (internal/simd/src/floats_*.c,
dispatch at simd/kernels.go:12-30; distance/distance.go:13-63). On the
accelerator the FLOPs live in a single [B, d] x [d, N] product:

    L2^2(Q, X) = |q|^2 + |x|^2 - 2 Q X^T

with |x|^2 precomputed once per segment and resident next to the vectors
(the reference precomputes nothing because its scalar kernels recompute; here
the norms column is the natural companion of the shard).

All functions return *smaller-is-better* scores, shape [B, N].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def row_norms_sq(x: jax.Array) -> jax.Array:
    """Per-row squared L2 norms, float32 [N]."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def normalize(x: jax.Array, eps: float = 1e-30) -> jax.Array:
    """L2-normalize rows (reference: distance.Normalize)."""
    n = jnp.sqrt(jnp.sum(x.astype(jnp.float32) ** 2, axis=-1, keepdims=True))
    return (x / jnp.maximum(n, eps)).astype(x.dtype)


# Dot algorithm of every f32 scan without an explicit compute dtype: three
# bf16 products with f32 accumulation (about 16 significant bits). This is
# the precision the "f32" scan profile and k-means were designed around;
# `Precision.HIGH` would silently mean TF32 (about 11 bits) on a GPU.
# chip_smoke.py phase 2 measures the profile's recall with it on the card.
F32_DOT = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def _matmul(q: jax.Array, x: jax.Array, compute_dtype=None, precision=None) -> jax.Array:
    """Q [B,d] @ X^T [d,N] -> [B,N] with float32 accumulation.

    compute_dtype (e.g. bfloat16) casts both operands for a single-pass
    product (approximate paths; callers rerank). f32 operands without a
    compute dtype use F32_DOT; rerank paths request Precision.HIGHEST.
    """
    if compute_dtype is not None:
        q = q.astype(compute_dtype)
        x = x.astype(compute_dtype)
    elif precision is None and (q.dtype == jnp.float32 or x.dtype == jnp.float32):
        precision = F32_DOT
    return jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def squared_l2(
    q: jax.Array,
    x: jax.Array,
    x_norms_sq: jax.Array | None = None,
    compute_dtype=None,
) -> jax.Array:
    """Squared L2 distances [B, N] (reference: simd.SquaredL2 / SquaredL2Batch)."""
    qf = q.astype(jnp.float32)
    qn = jnp.sum(qf * qf, axis=-1, keepdims=True)  # [B,1]
    if x_norms_sq is None:
        x_norms_sq = row_norms_sq(x)
    prod = _matmul(q, x, compute_dtype)  # [B,N]
    d = qn + x_norms_sq[None, :] - 2.0 * prod
    return jnp.maximum(d, 0.0)


def dot_scores(q: jax.Array, x: jax.Array, compute_dtype=None) -> jax.Array:
    """Negative inner product [B, N] (smaller = more similar)."""
    return -_matmul(q, x, compute_dtype)


def cosine_scores(
    q: jax.Array,
    x: jax.Array,
    x_normalized: bool = False,
    q_normalized: bool = False,
    compute_dtype=None,
) -> jax.Array:
    """Cosine distance 1 - cos(q, x), [B, N].

    The engine normalizes stored vectors at ingest for cosine metric (the
    reference normalizes the query copy at search: engine/search.go:172-185),
    so the common path is a pure matmul.
    """
    if not q_normalized:
        q = normalize(q)
    if not x_normalized:
        x = normalize(x)
    return 1.0 - _matmul(q, x, compute_dtype)


def pairwise_scores(
    q: jax.Array,
    x: jax.Array,
    metric,
    x_norms_sq: jax.Array | None = None,
    x_normalized: bool = True,
    q_normalized: bool = False,
    compute_dtype=None,
) -> jax.Array:
    """Metric-dispatched [B, N] scores (reference: distance.Provider :97-116)."""
    # Late import to avoid cycles.
    from vecgo.model import Metric

    metric = metric.compute()  # HAMMING scores as L2 over 0/1 vectors
    if metric == Metric.L2:
        return squared_l2(q, x, x_norms_sq, compute_dtype)
    if metric == Metric.DOT:
        return dot_scores(q, x, compute_dtype)
    if metric == Metric.COSINE:
        return cosine_scores(q, x, x_normalized, q_normalized, compute_dtype)
    raise ValueError(f"unsupported metric for float scoring: {metric}")


@functools.partial(jax.jit, static_argnames=("metric_name",))
def _scores_jit(q, x, x_norms_sq, metric_name):
    from vecgo.model import Metric

    return pairwise_scores(q, x, Metric(metric_name), x_norms_sq)

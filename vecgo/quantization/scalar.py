"""Scalar quantizers: SQ8 and INT4 (reference: quantization/quantizer.go:31-251,
quantization/int4.go:14-166; SIMD kernels sq8_*.c / int4_*.c).

Both are per-dimension affine codecs  x ~= offset + scale * u  with u in
[0, 255] (SQ8) or [0, 15] (INT4, nibble-packed). Scoring is a dequant-fused
matmul: with q' = q * scale,

    q . xhat = q . offset + q' . u

so the block scan multiplies the (small-int, exactly representable in bf16)
code matrix straight on the tensor cores — the device analogue of the reference's
Sq8uL2BatchPerDimension / Int4L2DistanceBatch AVX kernels.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from vecgo.model import Metric
from vecgo.quantization import Quantizer, register
from vecgo.ops import distance as D


def _affine_train(x: np.ndarray, levels: int):
    lo = x.min(axis=0).astype(np.float32)
    hi = x.max(axis=0).astype(np.float32)
    scale = (hi - lo) / (levels - 1)
    scale = np.where(scale <= 0, 1e-9, scale).astype(np.float32)
    return lo, scale


def _affine_encode(x: np.ndarray, offset, scale, levels: int):
    u = np.rint((x - offset[None, :]) / scale[None, :])
    return np.clip(u, 0, levels - 1).astype(np.uint8)


def _affine_scores(q, u_bf16, offset, scale, rnorm2, metric: Metric):
    """Shared scoring: u_bf16 [Nb, d] codes as bf16, offset/scale [d]."""
    qf = q.astype(jnp.float32)
    if metric == Metric.COSINE:
        qf = D.normalize(qf)
    qs = (qf * scale[None, :]).astype(jnp.bfloat16)
    dotp = jax.lax.dot_general(
        qs,
        u_bf16,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    dotp = dotp + (qf @ offset.astype(jnp.float32))[:, None]
    if metric == Metric.L2:
        qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
        return jnp.maximum(qn + rnorm2[None, :] - 2.0 * dotp, 0.0)
    if metric == Metric.DOT:
        return -dotp
    if metric == Metric.COSINE:
        inv = jax.lax.rsqrt(jnp.maximum(rnorm2, 1e-30))
        return 1.0 - dotp * inv[None, :]
    raise ValueError(f"metric {metric} unsupported by scalar quantizer")


@register
class SQ8Quantizer(Quantizer):
    """8-bit scalar quantization, 4x compression (reference: quantizer.go:31)."""

    kind = "sq8"

    def __init__(self, dim: int):
        super().__init__(dim)
        self.offset = None  # [d] f32
        self.scale = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        self.offset, self.scale = _affine_train(np.asarray(x, np.float32), 256)
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        codes = _affine_encode(x, self.offset, self.scale, 256)
        recon = self.offset[None, :] + self.scale[None, :] * codes.astype(np.float32)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": codes, "rnorm2": rnorm2}

    def decode(self, enc) -> np.ndarray:
        codes = np.asarray(enc["codes"], np.float32)
        return self.offset[None, :] + self.scale[None, :] * codes

    def score(self, q, enc, metric: Metric):
        u = enc["codes"].astype(jnp.bfloat16)  # 0..255: exact in bf16
        return _affine_scores(
            q,
            u,
            jnp.asarray(self.offset),
            jnp.asarray(self.scale),
            enc["rnorm2"],
            metric,
        )

    def code_bytes_per_vector(self) -> int:
        return self.dim + 4

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"offset": self.offset, "scale": self.scale}


def pack_nibbles(u: np.ndarray) -> np.ndarray:
    """Pack uint8 values <16, [N, d] -> [N, ceil(d/2)]; even dims in low nibble."""
    n, d = u.shape
    if d % 2:
        u = np.concatenate([u, np.zeros((n, 1), np.uint8)], 1)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles_jnp(packed, d: int):
    """[Nb, ceil(d/2)] uint8 -> [Nb, d] (device)."""
    lo = packed & jnp.uint8(0x0F)
    hi = packed >> 4
    inter = jnp.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)
    return inter[:, :d]


@register
class INT4Quantizer(Quantizer):
    """4-bit scalar quantization, 8x compression (reference: int4.go:14)."""

    kind = "int4"

    def __init__(self, dim: int):
        super().__init__(dim)
        self.offset = None
        self.scale = None

    def train(self, x: np.ndarray, seed: int = 42):
        self.offset, self.scale = _affine_train(np.asarray(x, np.float32), 16)
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        u = _affine_encode(x, self.offset, self.scale, 16)
        recon = self.offset[None, :] + self.scale[None, :] * u.astype(np.float32)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": pack_nibbles(u), "rnorm2": rnorm2}

    def decode(self, enc) -> np.ndarray:
        packed = np.asarray(enc["codes"])
        lo = packed & 0x0F
        hi = packed >> 4
        u = np.stack([lo, hi], -1).reshape(packed.shape[0], -1)[:, : self.dim]
        return self.offset[None, :] + self.scale[None, :] * u.astype(np.float32)

    def score(self, q, enc, metric: Metric):
        u = unpack_nibbles_jnp(enc["codes"], self.dim).astype(jnp.bfloat16)
        return _affine_scores(
            q,
            u,
            jnp.asarray(self.offset),
            jnp.asarray(self.scale),
            enc["rnorm2"],
            metric,
        )

    def code_bytes_per_vector(self) -> int:
        return (self.dim + 1) // 2 + 4

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"offset": self.offset, "scale": self.scale}

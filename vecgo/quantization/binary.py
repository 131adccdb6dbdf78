"""Binary quantizers: BQ and RaBitQ (reference: quantization/binary.go:23-158,
quantization/rabitq.go:26-187).

Storage: packed uint32 sign/threshold bits (32x compression) + small per-row
float corrections. Scoring unpacks blocks to +-1 bf16 and rides the tensor cores
(ops/hamming.py) — 32x less HBM traffic than fp32 at the same FLOPs, which is
a pure win on a bandwidth-bound scan.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from vecgo.model import Metric
from vecgo.quantization import Quantizer, register
from vecgo.ops import distance as D
from vecgo.ops import hamming as H


def _pm_matmul(q_weighted, packed_block, d):
    """q_weighted [B, d] . pm(codes) [Nb, d] -> [B, Nb] f32 via unpack+matmul."""
    pm = H.unpack_to_pm1(packed_block, d)  # [Nb, d] bf16, zero beyond d
    return jax.lax.dot_general(
        q_weighted.astype(jnp.bfloat16),
        pm,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@register
class BQQuantizer(Quantizer):
    """Binary (threshold) quantization (reference: binary.go).

    encode: bit_d = x_d > t_d with per-dim threshold t = sample mean.
    reconstruction: xhat = t + alpha * pm  with per-dim alpha = E|x - t|.
    Scoring: asymmetric (float query vs +-1 codes) for L2/DOT/COSINE;
    symmetric Hamming for Metric.HAMMING (binarized query).
    """

    kind = "bq"

    def __init__(self, dim: int):
        super().__init__(dim)
        self.threshold = None  # [d] f32
        self.alpha = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        x = np.asarray(x, np.float32)
        self.threshold = x.mean(axis=0).astype(np.float32)
        self.alpha = np.abs(x - self.threshold[None, :]).mean(0).astype(np.float32)
        self.alpha = np.where(self.alpha <= 0, 1e-9, self.alpha)
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        bits = x > self.threshold[None, :]
        packed = np.asarray(H.pack_bits(jnp.asarray(bits)))
        recon = self.threshold[None, :] + self.alpha[None, :] * np.where(bits, 1, -1)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": packed, "rnorm2": rnorm2}

    def decode(self, enc) -> np.ndarray:
        bits = np.asarray(H.unpack_bits(jnp.asarray(enc["codes"]), self.dim))
        return self.threshold[None, :] + self.alpha[None, :] * (
            2.0 * bits.astype(np.float32) - 1.0
        )

    def encode_query(self, q: np.ndarray) -> np.ndarray:
        """Binarize queries for symmetric Hamming scoring."""
        bits = np.asarray(q, np.float32) > self.threshold[None, :]
        return np.asarray(H.pack_bits(jnp.asarray(bits)))

    def score(self, q, enc, metric: Metric):
        if metric == Metric.HAMMING:
            # q is expected packed uint32 here (engine binarizes).
            return H.hamming_scores(q, enc["codes"], self.dim)
        qf = q.astype(jnp.float32)
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        t = jnp.asarray(self.threshold)
        a = jnp.asarray(self.alpha)
        dotp = _pm_matmul(qf * a[None, :], enc["codes"], self.dim)
        dotp = dotp + (qf @ t)[:, None]
        rnorm2 = enc["rnorm2"]
        if metric == Metric.L2:
            qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
            return jnp.maximum(qn + rnorm2[None, :] - 2.0 * dotp, 0.0)
        if metric == Metric.DOT:
            return -dotp
        if metric == Metric.COSINE:
            inv = jax.lax.rsqrt(jnp.maximum(rnorm2, 1e-30))
            return 1.0 - dotp * inv[None, :]
        raise ValueError(f"metric {metric} unsupported by BQ")

    def code_bytes_per_vector(self) -> int:
        return 4 * H.packed_words(self.dim) + 4

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"threshold": self.threshold, "alpha": self.alpha}


@register
class RaBitQQuantizer(Quantizer):
    """RaBitQ: centered sign bits + norm/cosine correction (reference: rabitq.go).

    encode (per row): res = x - centroid; store packed sign bits of res,
    norm = |res|, and corr = <res/|res|, pm/sqrt(d)> (the quantization cosine).
    The unbiased dot estimator is

        <q - c, res> ~= |res| * (<q - c, pm> / sqrt(d)) / corr

    which keeps the error bound the reference advertises (rabitq.go:26-187):
    relative error ~ 1/(corr*sqrt(d)) per row.
    """

    kind = "rabitq"

    def __init__(self, dim: int):
        super().__init__(dim)
        self.centroid = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        self.centroid = np.asarray(x, np.float32).mean(axis=0).astype(np.float32)
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        res = x - self.centroid[None, :]
        norm = np.linalg.norm(res, axis=1).astype(np.float32)
        bits = res > 0
        packed = np.asarray(H.pack_bits(jnp.asarray(bits)))
        pm = np.where(bits, 1.0, -1.0).astype(np.float32)
        sqrt_d = np.sqrt(self.dim)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = (res * pm).sum(1) / np.maximum(norm, 1e-30) / sqrt_d
        corr = np.clip(np.nan_to_num(corr, nan=1.0), 0.05, 1.0).astype(np.float32)
        # Fold everything per-row into one factor: est = <qc, pm> * fac
        fac = (norm / (corr * sqrt_d)).astype(np.float32)
        return {"codes": packed, "fac": fac, "norm2": (norm**2).astype(np.float32)}

    def decode(self, enc) -> np.ndarray:
        bits = np.asarray(H.unpack_bits(jnp.asarray(enc["codes"]), self.dim))
        pm = 2.0 * bits.astype(np.float32) - 1.0
        fac = np.asarray(enc["fac"], np.float64)  # |res| / (corr * sqrt(d))
        norm2 = np.asarray(enc["norm2"], np.float64)
        # Least-squares reconstruction: res ~= alpha * pm with
        # alpha = <res, pm>/d = |res|*corr/sqrt(d) = norm2 / (fac * d).
        alpha = norm2 / np.maximum(fac * self.dim, 1e-30)
        return (self.centroid[None, :] + pm * alpha[:, None]).astype(np.float32)

    def score(self, q, enc, metric: Metric):
        qf = q.astype(jnp.float32)
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        c = jnp.asarray(self.centroid)
        qc = qf - c[None, :]
        raw = _pm_matmul(qc, enc["codes"], self.dim)  # <qc, pm>
        est = raw * enc["fac"][None, :]  # ~= <qc, res>
        if metric == Metric.L2:
            qcn = jnp.sum(qc * qc, axis=-1, keepdims=True)
            return jnp.maximum(qcn + enc["norm2"][None, :] - 2.0 * est, 0.0)
        # <q, x> = <q, c> + <q, res>. Estimate <q, res> with the same
        # sign-vector estimator (q in place of q-c): <q,res> ~ <q,pm>*fac.
        qdotc = (qf @ c)[:, None]
        dotp = qdotc + _pm_matmul(qf, enc["codes"], self.dim) * enc["fac"][None, :]
        if metric == Metric.DOT:
            return -dotp
        if metric == Metric.COSINE:
            xn2 = jnp.sum(c * c) + enc["norm2"]
            inv = jax.lax.rsqrt(jnp.maximum(xn2, 1e-30))
            return 1.0 - dotp * inv[None, :]
        raise ValueError(f"metric {metric} unsupported by RaBitQ")

    def code_bytes_per_vector(self) -> int:
        return 4 * H.packed_words(self.dim) + 8

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"centroid": self.centroid}

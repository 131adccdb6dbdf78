"""Product quantization (PQ) and optimized PQ (OPQ).

Reference: quantization/pq.go:20-520 (codebooks + ADC tables), opq.go:28-215
(learned rotation via SVD iterations).

Device-first scoring: classic ADC  sum_m ||q_m - C_m[code]||^2  equals the exact
L2 between q and the PQ *reconstruction*, so scoring decodes each code block to
bf16 via one-hot matmuls (gather-free, rides the tensor cores) and runs the standard
norm-expanded matmul. Decode cost is Nb*K*d MACs per block, amortized over the
whole query batch — cheaper than per-query table gathers for B >~ 8, and it
keeps codes compressed in HBM (the point of PQ: memory, not FLOPs).

Training: all M subspace codebooks train simultaneously (vmapped k-means,
kmeans.train_kmeans_grouped) — replaces the reference's worker-pool training
(pq.go:353-387).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from vecgo.model import Metric
from vecgo.quantization import Quantizer, register
from vecgo.quantization import kmeans as km
from vecgo.ops import distance as D


def _pad_dim(x: np.ndarray, m: int) -> np.ndarray:
    d = x.shape[1]
    pad = (-d) % m
    if pad:
        x = np.concatenate([x, np.zeros((x.shape[0], pad), np.float32)], 1)
    return x


def _decode_block_jnp(codes, codebooks, out_dtype=jnp.bfloat16):
    """codes [Nb, M] int -> reconstruction [Nb, M*dsub] via one-hot matmuls."""
    m, k, dsub = codebooks.shape

    def one_sub(codes_m, cb_m):
        onehot = (
            codes_m[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
        ).astype(out_dtype)
        return jnp.dot(
            onehot, cb_m.astype(out_dtype), preferred_element_type=jnp.float32
        )

    recon = jax.vmap(one_sub, in_axes=(1, 0), out_axes=1)(
        codes.astype(jnp.int32), codebooks
    )  # [Nb, M, dsub] f32
    return recon.reshape(codes.shape[0], m * dsub).astype(out_dtype)


@register
class PQQuantizer(Quantizer):
    """Product quantizer, K=256 codebooks per subspace (reference: pq.go)."""

    kind = "pq"

    def __init__(self, dim: int, m: int = 8, ksub: int = 256):
        super().__init__(dim)
        self.m = m
        self.ksub = ksub
        self.dsub = (dim + m - 1) // m  # after zero-padding dim to multiple of m
        self.dim_padded = self.dsub * m
        self.codebooks = None  # [M, K, dsub] f32

    def train(self, x: np.ndarray, seed: int = 42):
        x = _pad_dim(np.asarray(x, np.float32), self.m)
        groups = x.reshape(x.shape[0], self.m, self.dsub).transpose(1, 0, 2)
        self.codebooks = km.train_kmeans_grouped(groups, self.ksub, seed=seed)
        self.trained = True

    def _assign(self, x: np.ndarray) -> np.ndarray:
        """codes [N, M] uint8/uint16."""
        x = _pad_dim(np.asarray(x, np.float32), self.m)
        n = x.shape[0]
        groups = x.reshape(n, self.m, self.dsub)
        cb = jnp.asarray(self.codebooks)

        block = 8192
        out = np.empty((n, self.m), np.int32)
        assign_fn = jax.jit(
            lambda g, c: jax.vmap(
                lambda gm, cm: jnp.argmin(D.squared_l2(gm, cm), axis=1),
                in_axes=(1, 0),
                out_axes=1,
            )(g, c)
        )
        for s in range(0, n, block):
            e = min(s + block, n)
            out[s:e] = np.asarray(assign_fn(jnp.asarray(groups[s:e]), cb))
        dtype = np.uint8 if self.ksub <= 256 else np.uint16
        return out.astype(dtype)

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        codes = self._assign(x)
        recon = self._decode_codes(codes)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": codes, "rnorm2": rnorm2}

    def _decode_codes(self, codes: np.ndarray) -> np.ndarray:
        recon = np.empty((codes.shape[0], self.dim_padded), np.float32)
        for m in range(self.m):
            recon[:, m * self.dsub : (m + 1) * self.dsub] = self.codebooks[m][
                codes[:, m].astype(np.int64)
            ]
        return recon[:, : self.dim]

    def decode(self, enc) -> np.ndarray:
        return self._decode_codes(np.asarray(enc["codes"]))

    def score(self, q, enc, metric: Metric):
        qf = q.astype(jnp.float32)
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        if self.dim_padded != self.dim:
            qf = jnp.pad(qf, ((0, 0), (0, self.dim_padded - self.dim)))
        recon = _decode_block_jnp(enc["codes"], jnp.asarray(self.codebooks))
        dotp = jax.lax.dot_general(
            qf.astype(jnp.bfloat16),
            recon,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        rnorm2 = enc["rnorm2"]
        if metric == Metric.L2:
            qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
            return jnp.maximum(qn + rnorm2[None, :] - 2.0 * dotp, 0.0)
        if metric == Metric.DOT:
            return -dotp
        if metric == Metric.COSINE:
            inv = jax.lax.rsqrt(jnp.maximum(rnorm2, 1e-30))
            return 1.0 - dotp * inv[None, :]
        raise ValueError(f"metric {metric} unsupported by PQ")

    def code_bytes_per_vector(self) -> int:
        return self.m * (1 if self.ksub <= 256 else 2) + 4

    def params(self):
        return {"dim": self.dim, "m": self.m, "ksub": self.ksub}

    def arrays(self):
        return {"codebooks": self.codebooks}


@register
class OPQQuantizer(Quantizer):
    """PQ with a learned orthogonal rotation (reference: opq.go:28-215).

    Alternates PQ training on rotated data with a procrustes rotation update
    R = U V^T from the SVD of X^T Xhat — the reference's SVD power iterations
    (svd.go) become one jnp.linalg.svd call.
    """

    kind = "opq"

    def __init__(self, dim: int, m: int = 8, ksub: int = 256, opq_iters: int = 5):
        super().__init__(dim)
        self.m = m
        self.ksub = ksub
        self.opq_iters = opq_iters
        self.pq = PQQuantizer(dim, m, ksub)
        self.rotation = None  # [d, d] f32, applied as x @ R

    def train(self, x: np.ndarray, seed: int = 42):
        x = np.asarray(x, np.float32)
        r = np.random.default_rng(seed)
        n = min(x.shape[0], 16384)
        xs = x[r.choice(x.shape[0], n, replace=False)] if x.shape[0] > n else x
        d = self.dim
        self.rotation = np.eye(d, dtype=np.float32)
        for it in range(self.opq_iters):
            xr = xs @ self.rotation
            self.pq.train(xr, seed=seed + it)
            recon = self.pq.decode(self.pq.encode(xr))
            # Procrustes: maximize tr(R^T X^T Xhat) over orthogonal R.
            u, _, vt = np.linalg.svd(xs.T @ recon, full_matrices=False)
            self.rotation = (u @ vt).astype(np.float32)
        # Final PQ fit in the converged rotation.
        self.pq.train(xs @ self.rotation, seed=seed + 1000)
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        return self.pq.encode(np.asarray(x, np.float32) @ self.rotation)

    def decode(self, enc) -> np.ndarray:
        return self.pq.decode(enc) @ self.rotation.T

    def score(self, q, enc, metric: Metric):
        qf = q.astype(jnp.float32)
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        qr = qf @ jnp.asarray(self.rotation)
        # Rotation is orthogonal: L2/dot/cosine are invariant, so score in
        # rotated space (pass COSINE as DOT-style since q is already unit and
        # rotated reconstruction norms are stored in rotated space).
        if metric == Metric.COSINE:
            dotp = -self.pq.score(qr, enc, Metric.DOT)
            inv = jax.lax.rsqrt(jnp.maximum(enc["rnorm2"], 1e-30))
            return 1.0 - dotp * inv[None, :]
        return self.pq.score(qr, enc, metric)

    def code_bytes_per_vector(self) -> int:
        return self.pq.code_bytes_per_vector()

    def params(self):
        return {
            "dim": self.dim,
            "m": self.m,
            "ksub": self.ksub,
            "opq_iters": self.opq_iters,
        }

    def arrays(self):
        return {"rotation": self.rotation, "codebooks": self.pq.codebooks}

    def load_arrays(self, arrays):
        self.rotation = arrays["rotation"]
        self.pq.codebooks = arrays["codebooks"]
        self.pq.trained = True
        self.trained = True

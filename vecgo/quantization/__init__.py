"""Quantization suite (reference: internal/quantization, types at types.go:6-14).

Families: none / SQ8 / INT4 / PQ / OPQ / BQ / RaBitQ — same lineup as the
reference. Device-first scoring design: every quantizer's approximate distance is
computed against its *reconstruction* via matmuls (decode-by-one-hot-matmul for
PQ, dequant-fused int8 matmul for SQ8/INT4, +-1 matmul for BQ/RaBitQ), with
per-row reconstruction norms precomputed at encode time so L2 is

    |q|^2 + rnorm2[n] - 2 q . xhat_n

on the tensor cores. Codes stay compressed in HBM; decode happens transiently per block.
"""

from __future__ import annotations

import abc
from typing import Any, ClassVar, Dict

import numpy as np

from vecgo.model import Metric


class Quantizer(abc.ABC):
    """Quantizer contract (reference: quantization.Quantizer, quantizer.go:12).

    Lifecycle: construct -> train(sample) -> encode(rows) -> score(q, codes).
    `score` must be pure/traceable (called under jit with jnp block arrays).
    State round-trips through state()/from_state (reference: MarshalBinary).
    """

    kind: ClassVar[str] = "none"

    def __init__(self, dim: int):
        self.dim = dim
        self.trained = False

    @abc.abstractmethod
    def train(self, x: np.ndarray, seed: int = 42) -> None:
        """Fit quantizer parameters on a training sample [N, d]."""

    @abc.abstractmethod
    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        """Encode rows into named code arrays (each leading dim N)."""

    @abc.abstractmethod
    def decode(self, enc: Dict[str, np.ndarray]) -> np.ndarray:
        """Reconstruct float32 approximations [N, d] (host-side, for tests/rerank)."""

    @abc.abstractmethod
    def score(self, q, enc: Dict[str, Any], metric: Metric):
        """Approximate distances [B, N] (traceable; enc holds jnp arrays)."""

    @abc.abstractmethod
    def code_bytes_per_vector(self) -> int:
        """Compressed bytes per vector (excluding shared codebooks)."""

    def params(self) -> Dict[str, Any]:
        """JSON-able constructor params."""
        return {"dim": self.dim}

    def arrays(self) -> Dict[str, np.ndarray]:
        """Trained parameter arrays."""
        return {}

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        for name, arr in arrays.items():
            setattr(self, name, arr)
        self.trained = True

    def state(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": self.params(), "arrays": self.arrays()}

    @staticmethod
    def from_state(state: Dict[str, Any]) -> "Quantizer":
        q = create(state["kind"], **state["params"])
        if q is not None:
            q.load_arrays(state["arrays"])
        return q


class NoneQuantizer(Quantizer):
    """Identity 'quantizer': full-precision float32 storage."""

    kind = "none"

    def train(self, x, seed: int = 42):
        self.trained = True

    def encode(self, x):
        from vecgo.ops.distance import row_norms_sq
        import jax.numpy as jnp

        x = np.asarray(x, np.float32)
        return {
            "vectors": x,
            "rnorm2": np.asarray(np.einsum("nd,nd->n", x, x, dtype=np.float64), np.float32),
        }

    def decode(self, enc):
        return np.asarray(enc["vectors"], np.float32)

    def score(self, q, enc, metric: Metric):
        from vecgo.ops import distance as D

        return D.pairwise_scores(
            q, enc["vectors"], metric, x_norms_sq=enc.get("rnorm2"), x_normalized=False
        )

    def code_bytes_per_vector(self) -> int:
        return self.dim * 4


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.kind] = cls
    return cls


register(NoneQuantizer)


def create(kind: str, **params) -> Quantizer:
    """Create an untrained quantizer by kind name."""
    # Populate the registry lazily.
    from vecgo.quantization import scalar, pq, binary  # noqa: F401

    if kind in (None, "", "none"):
        return NoneQuantizer(params.get("dim", 0))
    if kind not in _REGISTRY:
        raise ValueError(f"unknown quantizer kind {kind!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[kind](**params)


__all__ = ["Quantizer", "NoneQuantizer", "create", "register", "Metric"]

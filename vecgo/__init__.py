"""vecgo — an embeddable hybrid vector database on JAX/XLA for the GPU.

Re-implements the capabilities of the reference Go engine (hupe1980/vecgo,
see SURVEY.md) with a device-first architecture:

- distance computation as fused batch matmuls on the tensor cores
  (reference: internal/simd AVX/NEON kernels, simd/kernels.go:12-30)
- graph search as fixed-fanout batched lockstep beam search
  (reference: hnsw/hnsw.go:1755 KNNSearchWithContext, diskann/segment.go:503)
- quantizer training as jitted k-means, ADC scoring as decode-matmuls
  (reference: internal/quantization, internal/kmeans)
- LSM engine / MVCC / manifests on host, scoring on device
  (reference: internal/engine, internal/manifest)

Public API mirrors the reference facade (vecgo.go:17-448).
"""

from vecgo.model import (
    Candidate,
    Metric,
    QueryStats,
    Record,
    SearchOptions,
    SearchResult,
)
from vecgo.errors import (
    VecgoError,
    ErrNotFound,
    ErrDimensionMismatch,
    ErrInvalidVector,
    ErrReadOnly,
    ErrClosed,
    ErrBackpressure,
)

__version__ = "0.1.0"

__all__ = [
    "Candidate",
    "Metric",
    "QueryStats",
    "Record",
    "SearchOptions",
    "SearchResult",
    "VecgoError",
    "ErrNotFound",
    "ErrDimensionMismatch",
    "ErrInvalidVector",
    "ErrReadOnly",
    "ErrClosed",
    "ErrBackpressure",
    "Open",
    "DB",
]


def __getattr__(name):
    # Lazy imports keep `import vecgo` light (no jax import at module load).
    if name in ("Open", "DB", "Local", "Remote", "Memory", "Create", "Backend"):
        from vecgo import api

        return getattr(api, name)
    raise AttributeError(f"module 'vecgo' has no attribute {name!r}")

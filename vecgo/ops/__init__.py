"""Kernel substrate: every distance/scoring primitive as matmul-friendly batched ops.

This package replaces the reference's native SIMD layer (internal/simd, see
SURVEY.md §2.2) with:
  - jnp/lax implementations that XLA compiles for the device, and
  - a Pallas Triton kernel for the coded IVF scan (ops/coded_scan_triton).

Convention: all scores are *smaller-is-better* distances (see model.Metric).
"""

from vecgo.ops.distance import (
    squared_l2,
    dot_scores,
    cosine_scores,
    pairwise_scores,
    row_norms_sq,
    normalize,
)
from vecgo.ops.topk import topk_smallest, merge_topk, blockwise_topk_search

__all__ = [
    "squared_l2",
    "dot_scores",
    "cosine_scores",
    "pairwise_scores",
    "row_norms_sq",
    "normalize",
    "topk_smallest",
    "merge_topk",
    "blockwise_topk_search",
]

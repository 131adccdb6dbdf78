"""Top-k primitives and blockwise streaming search.

Replaces the reference's heap machinery (searcher/candidate_queue.go,
searcher/queue.go) with dense top-k over score tiles and a running-merge
scan — the device analogue of "stream blocks, keep a running top-k" (SURVEY.md §5.7).

Selection: wide unmasked rows go through `lax.approx_min_k`, which lowers to
an exact top-k on the GPU and CPU (a backend with a binned implementation
makes the selection approximate; distances are exact either way). Merges co-sort (dist, id) with multi-operand
`lax.sort` instead of `take_along_axis` gathers.

All distances are smaller-is-better; invalid/padded entries carry +inf distance
and id -1 in the final result.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vecgo.ops import distance as dist_ops

_INF = jnp.inf

# Use approx_min_k for block rows at least this wide.
_APPROX_MIN_WIDTH = 16_384
_APPROX_RECALL_TARGET = 0.99


def topk_smallest(scores: jax.Array, k: int):
    """Top-k smallest along the last axis. Returns (dists [.., k], idx [.., k])."""
    neg, idx = jax.lax.top_k(-scores, k)
    return -neg, idx


def topk_smallest_fast(scores: jax.Array, k: int, masked: bool = False):
    """Top-k smallest, allowing approx_min_k on wide rows.

    masked=True = the row is inf-sparse (filter mask / IVF probe mask) and
    selection is EXACT lax.top_k: approx_min_k's binned reduction (where the
    backend bins) loses entries on inf-sparse rows (measured per-op recall
    ~0.92 at rt=0.99 on a 90%-masked 131072-wide row — a true rank-5
    neighbor dropped from a 26-pool). Tightening recall_target instead
    degenerates: the reduction size k/(1-rt^(1/k)) exceeds the row width
    already at rt=0.999/k=26, which lowers to a FULL SORT. The planner keeps masked scans rare by compact-gathering eligible rows into
    a dense sub-corpus up to compact_gather_cutoff selectivity; this exact
    path is the fallback above the cutoff and for the memtable."""
    n = scores.shape[-1]
    if masked:
        return topk_smallest(scores, k)
    if n >= _APPROX_MIN_WIDTH and k <= 128:
        return jax.lax.approx_min_k(
            scores, k, recall_target=_APPROX_RECALL_TARGET
        )
    return topk_smallest(scores, k)


def merge_topk_sorted(d_a, i_a, d_b, i_b, k: int):
    """Sort-based merge of two candidate sets -> k smallest (no gathers)."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    sd, si = jax.lax.sort((d, i.astype(jnp.int32)), num_keys=1)
    return sd[..., :k], si[..., :k]


def topk_smallest_with_ids(d: jax.Array, i: jax.Array, k: int):
    """Top-k smallest of (d, i) pairs along the last axis."""
    dk, pos = topk_smallest(d, k)
    return dk, jnp.take_along_axis(i, pos, axis=-1)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two top-k sets (last axis) into the k smallest overall."""
    return merge_topk_sorted(d_a, i_a, d_b, i_b, k)


def _apply_mask(scores, mask):
    if mask is None:
        return scores
    return jnp.where(mask, scores, _INF)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "metric_name",
        "block_rows",
        "compute_dtype_name",
        "x_normalized",
        "exact",
        "masked",
    ),
)
def _blockwise_search_jit(
    q,
    x,  # [N_pad, d], N_pad % block_rows == 0
    x_norms_sq,  # [N_pad] or None
    mask,  # [N_pad] bool or None
    k: int,
    metric_name: str,
    block_rows: int,
    compute_dtype_name: Optional[str],
    x_normalized: bool,
    exact: bool,
    masked: bool = False,  # caller-supplied filter mask -> exact selection
):
    from vecgo.model import Metric

    metric = Metric(metric_name).compute()
    compute_dtype = jnp.dtype(compute_dtype_name) if compute_dtype_name else None
    b = q.shape[0]
    n_pad = x.shape[0]
    nblocks = n_pad // block_rows

    if metric == Metric.COSINE:
        q = dist_ops.normalize(q)
        if not x_normalized:
            x = dist_ops.normalize(x)

    if x_norms_sq is None and metric == Metric.L2:
        x_norms_sq = dist_ops.row_norms_sq(x)
    xb = x.reshape(nblocks, block_rows, x.shape[1])
    nb = (
        x_norms_sq.reshape(nblocks, block_rows)
        if x_norms_sq is not None
        else jnp.zeros((nblocks, block_rows), jnp.float32)
    )
    mb = (
        mask.reshape(nblocks, block_rows)
        if mask is not None
        else jnp.ones((nblocks, block_rows), jnp.bool_)
    )

    # Derive the carry init from the operands so it picks up their device-
    # varying axes when this runs inside shard_map (pvary-equivalent).
    vary = q[:, :1].astype(jnp.float32) * 0.0 + x.reshape(-1)[0] * 0.0
    init = (
        jnp.full((b, k), _INF, jnp.float32) + vary,
        jnp.full((b, k), -1, jnp.int32) + vary.astype(jnp.int32),
    )

    def body(carry, inputs):
        bi, xblk, nblk, mblk = inputs
        d_run, i_run = carry
        scores = dist_ops.pairwise_scores(
            q,
            xblk,
            metric,
            x_norms_sq=nblk if metric == Metric.L2 else None,
            x_normalized=True,
            q_normalized=True,
            compute_dtype=compute_dtype,
        )
        scores = _apply_mask(scores, mblk[None, :])
        if exact:
            d_loc, i_loc = topk_smallest(scores, min(k, block_rows))
        else:
            # NOTE: over-fetching here (k_block > k) was measured 5x slower in
            # approx_min_k for no recall gain — selection losses are not at the
            # boundary; ranking noise is precision-driven (see distance._matmul).
            d_loc, i_loc = topk_smallest_fast(
                scores, min(k, block_rows), masked=masked
            )
        i_loc = i_loc + bi * block_rows
        carry = merge_topk_sorted(d_run, i_run, d_loc, i_loc.astype(jnp.int32), k)
        return carry, None

    block_ids = jnp.arange(nblocks, dtype=jnp.int32)
    (d_fin, i_fin), _ = jax.lax.scan(body, init, (block_ids, xb, nb, mb))
    i_fin = jnp.where(jnp.isfinite(d_fin), i_fin, -1)
    return d_fin, i_fin


@functools.partial(
    jax.jit,
    static_argnames=("score_fn", "k", "block_rows", "n_valid", "masked"),
)
def _blockwise_scored_jit(q, enc, mask, extra, score_fn, k, block_rows, n_valid,
                          masked: bool = False):
    """Generic streaming top-k over encoded arrays.

    enc: dict of arrays, each [N_pad, ...] with N_pad % block_rows == 0.
    score_fn(q, extra, enc_block) -> [B, block_rows] smaller-is-better.
    mask: [N_pad] bool or None; rows >= n_valid are always excluded.
    extra: per-call pytree forwarded to score_fn (e.g. IVF probe lists).
    """
    sample = next(iter(enc.values()))
    n_pad = sample.shape[0]
    nblocks = n_pad // block_rows
    b = q.shape[0]

    enc_blocks = {k_: v.reshape((nblocks, block_rows) + v.shape[1:]) for k_, v in enc.items()}
    mb = None if mask is None else mask.reshape(nblocks, block_rows)

    init = (
        jnp.full((b, k), _INF, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, inputs):
        if mb is None:
            bi, blk = inputs
            blk_mask = None
        else:
            bi, blk, blk_mask = inputs
        scores = score_fn(q, extra, blk)
        row_ids = bi * block_rows + jax.lax.broadcasted_iota(
            jnp.int32, (1, block_rows), 1
        )
        valid = row_ids < n_valid
        if blk_mask is not None:
            valid = valid & blk_mask[None, :]
        scores = jnp.where(valid, scores, _INF)
        d_loc, i_loc = topk_smallest_fast(
            scores, min(k, block_rows), masked=masked
        )
        carry = merge_topk_sorted(
            carry[0], carry[1], d_loc, (i_loc + bi * block_rows).astype(jnp.int32), k
        )
        return carry, None

    block_ids = jnp.arange(nblocks, dtype=jnp.int32)
    xs = (block_ids, enc_blocks) if mb is None else (block_ids, enc_blocks, mb)
    (d_fin, i_fin), _ = jax.lax.scan(body, init, xs)
    i_fin = jnp.where(jnp.isfinite(d_fin), i_fin, -1)
    return d_fin, i_fin


@functools.partial(
    jax.jit,
    static_argnames=(
        "score_fn", "rr_fn", "k", "pool", "block_rows", "n_valid", "pad",
        "masked",
    ),
)
def _scored_pool_rerank_jit(
    q, enc, mask, extra, full, rn,
    score_fn, rr_fn, k, pool, block_rows, n_valid, pad, masked=False,
):
    """FUSED pool-scan + exact rerank + final top-k as ONE device program.

    The staged composition (scan jit -> rerank jit -> topk jit) pays a
    dispatch round per program. The inner jitted callees inline here,
    so callers get one executable per (shape, statics) and one dispatch.
    Tail padding to the block multiple happens IN-TRACE (static `pad`) — an
    eager per-call jnp.pad of corpus-sized arrays is itself a dispatch per
    array. rr_fn(q, rows, full, rn) -> exact [B, pool] distances (inf for
    -1 rows).
    """
    if pad:
        enc = {
            k_: jnp.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
            for k_, v in enc.items()
        }
        if mask is not None:
            mask = jnp.pad(mask, (0, pad))
    _, rows = _blockwise_scored_jit(
        q, enc, mask, extra, score_fn, pool, block_rows, n_valid, masked
    )
    d = rr_fn(q, rows, full, rn)
    return topk_smallest_with_ids(d, rows, k)


def blockwise_scored_pool_rerank(
    q,
    enc: dict,
    n: int,
    k: int,
    score_fn,
    rr_fn,
    full,
    rn,
    *,
    pool: int,
    mask=None,
    extra=None,
    block_rows: int = 8192,
):
    """Fused-program wrapper around _scored_pool_rerank_jit (same padding
    contract as blockwise_topk_scored; pass STABLE score_fn/rr_fn objects)."""
    block_rows = max(128, min(block_rows, n))
    return _scored_pool_rerank_jit(
        q, enc, mask, extra, full, rn,
        score_fn, rr_fn, k, pool, block_rows, n, (-n) % block_rows,
        mask is not None or extra is not None,
    )


def blockwise_topk_scored(
    q,
    enc: dict,
    n: int,
    k: int,
    score_fn,
    *,
    mask=None,
    extra=None,
    block_rows: int = 8192,
):
    """Pad-and-run wrapper around _blockwise_scored_jit.

    IMPORTANT for jit-cache hits: pass the *same* score_fn object across calls
    (segments cache their scoring closures).
    """
    block_rows = max(128, min(block_rows, n))
    # inf-sparse selection hazard: a filter mask or an IVF probe mask (extra)
    # makes most of each score row +inf -> exact selection
    # (topk_smallest_fast masked=True).
    masked = mask is not None or extra is not None
    pad = (-n) % block_rows
    if pad:
        enc = {
            k_: jnp.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)) for k_, v in enc.items()
        }
        if mask is not None:
            mask = jnp.pad(mask, (0, pad))
    return _blockwise_scored_jit(
        q, enc, mask, extra, score_fn, k, block_rows, n, masked
    )


@functools.partial(
    jax.jit, static_argnames=("score_fn", "k", "block_rows", "masked")
)
def _stream_step_jit(q, enc_blk, mask_blk, extra, carry_d, carry_i, base, n_valid,
                     score_fn, k: int, block_rows: int, masked: bool = False):
    """One streamed block: score an uploaded [block_rows]-row slice and merge
    into the running top-k."""
    scores = score_fn(q, extra, enc_blk)
    row_ids = base + jax.lax.broadcasted_iota(jnp.int32, (1, block_rows), 1)
    valid = row_ids < n_valid
    if mask_blk is not None:
        valid = valid & mask_blk[None, :]
    scores = jnp.where(valid, scores, _INF)
    d_loc, i_loc = topk_smallest_fast(
        scores, min(k, block_rows), masked=masked
    )
    return merge_topk_sorted(
        carry_d, carry_i, d_loc, (i_loc + base).astype(jnp.int32), k
    )


def streaming_topk_scored(
    q,  # jnp [B, d]
    enc_host: dict,  # name -> np.ndarray [N, ...] HOST-resident
    n: int,
    k: int,
    score_fn,
    *,
    mask=None,  # np bool [N] or None
    extra=None,
    block_rows: int = 131072,
):
    """Beyond-HBM streaming scan: the encoded arrays stay in HOST memory; row
    blocks upload on demand and fold into a running device top-k. Device
    memory stays bounded at O(block) regardless of segment size — the device
    analogue of the reference's lazy block-cached reads
    (diskann/segment.go:1151; two-tier cache engine.go:425-477).

    JAX async dispatch double-buffers automatically: block i+1's H2D upload
    is enqueued while block i's matmul runs.
    """
    b = q.shape[0]
    block_rows = max(128, min(block_rows, n))
    carry_d = jnp.full((b, k), _INF, jnp.float32)
    carry_i = jnp.full((b, k), -1, jnp.int32)
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        enc_blk = {}
        for name, arr in enc_host.items():
            blk = arr[s:e]
            if e - s < block_rows:  # pad the tail to the static shape
                blk = np.pad(blk, [(0, block_rows - (e - s))] + [(0, 0)] * (arr.ndim - 1))
            enc_blk[name] = jnp.asarray(blk)
        mask_blk = None
        if mask is not None:
            mb = mask[s:e]
            if e - s < block_rows:
                mb = np.pad(mb, (0, block_rows - (e - s)))
            mask_blk = jnp.asarray(mb)
        carry_d, carry_i = _stream_step_jit(
            q, enc_blk, mask_blk, extra, carry_d, carry_i,
            jnp.int32(s), jnp.int32(n), score_fn, k, block_rows,
            mask is not None or extra is not None,
        )
    carry_i = jnp.where(jnp.isfinite(carry_d), carry_i, -1)
    return carry_d, carry_i


def blockwise_topk_search(
    q: jax.Array,
    x: jax.Array,
    k: int,
    *,
    metric,
    x_norms_sq: jax.Array | None = None,
    mask: jax.Array | None = None,
    block_rows: int = 131072,
    compute_dtype=None,
    x_normalized: bool = False,
    exact: bool = False,
):
    """Exact top-k search of q [B, d] against x [N, d], streaming row blocks.

    This is the engine's brute-force scoring primitive (replaces the reference's
    flat segment scan, flat/segment.go:487-560, and the cursor brute-force path,
    engine/cursor_search.go:80). The scan keeps HBM-resident [B, block] score
    tiles only; XLA pipelines block loads against the matmul.

    `x` may be padded; padded rows must be masked out via `mask` or carry +inf
    norms. Returns (dists [B, k], ids [B, k]) with id -1 for missing.
    """
    n = x.shape[0]
    block_rows = max(128, min(block_rows, n))
    # Tighter approx selection only for a CALLER mask (inf-sparse rows): the
    # padding-only tail mask below is a short contiguous run that approx_min_k
    # handles fine at the default target.
    masked = mask is not None
    if n % block_rows != 0:
        pad = block_rows - (n % block_rows)
        x = jnp.pad(x, ((0, pad), (0, 0)))
        if x_norms_sq is not None:
            x_norms_sq = jnp.pad(x_norms_sq, (0, pad))
        base_mask = jnp.arange(n + pad) < n
        mask = base_mask if mask is None else jnp.pad(mask, (0, pad)) & base_mask
    from vecgo.model import Metric

    metric = Metric(metric) if not isinstance(metric, Metric) else metric
    cd = jnp.dtype(compute_dtype).name if compute_dtype is not None else None
    return _blockwise_search_jit(
        q, x, x_norms_sq, mask, k, metric.value, block_rows, cd, x_normalized,
        exact, masked,
    )

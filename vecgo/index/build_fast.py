"""Fast clustered Vamana build: cluster-local exact KNN + RobustPrune.

Reference semantics: internal/segment/diskann/writer.go:362-643 (greedySearch
candidate generation + RobustPrune alpha occlusion + reverse edges with
re-prune). The reference generates candidates by per-point graph SEARCH, which
on an accelerator is latency-bound random gathers — the round-1 build was
slow because of it.

Device-first restructuring — NO graph search during build; candidates come from
cluster-local exact KNN computed as batched [C, C] distance matmuls (brute
force is nearly free on the tensor cores):

  1. JL-project the corpus to 32d ON DEVICE; k-means partition + top-`overlap`
     assignment run in the projection (the partition is a coarse filter; the
     KNN itself scores full-dim),
  2. each point joins its `overlap` nearest clusters (capacity-capped, primary
     membership guaranteed),
  3. per cluster batch: [G, C, C] full-dim bf16 distance tensor -> exact
     top-knn per member,
  4. NN-descent rounds on a pure-KNN working list (one fused device program),
  5. RobustPrune with alpha occlusion (+ random far candidates for long-range
     edge material), then a fused reverse-edge + re-prune pass.

`restarts` repeats stage 1-3 under fresh projections; candidate unions from
independent partitions compound recall nearly independently (measured: one
restart lifts uniform-data candidate recall 0.32 -> 0.54) at pure-matmul cost.

The build is device-resident end-to-end: ONE bf16 corpus upload, small
k-means-sample and membership round-trips, ONE final graph download; the
device-side build time is the honest analogue of the reference's in-RAM build
benchmark (baseline.txt:90).
"""

from __future__ import annotations

import functools
import logging
import math
import os as _os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("vecgo")

OCC_DIM = 32  # JL projection dim: partition space + RobustPrune occlusion

_PROFILE = bool(__import__("os").environ.get("BUILD_PROFILE"))
_HOST_RAND = bool(__import__("os").environ.get("BUILD_HOST_RAND"))
_CANON_OPS = bool(__import__("os").environ.get("BUILD_CANON_OPS"))
_SORT_MEMBERSHIP = bool(__import__("os").environ.get("BUILD_SORT_MEMBERSHIP"))
# Build defaults (1M×128d ablation):
# - prune occlusion runs in its OWN 16-dim JL space (partition keeps OCC_DIM=32)
#   — occlusion is a coarse geometric filter; 16 dims cut prune time ~16% with
#   recall unchanged on every serving screen. BUILD_PRUNE_OCC_DIM=0 shares the
#   partition projection (the pre-ablation behavior).
# - ONE prune pass over [working list | random | reverse-of-knn] replaces
#   prune + reverse-re-prune: reverse edges come from the descent working
#   list's top-r (symmetrized KNN) instead of the pruned graph — recall
#   identical (headline and refine=1 screens), −21% build. BUILD_ONE_PASS=0
#   restores the two-pass pipeline.
_PRUNE_OCC_DIM = int(__import__("os").environ.get("BUILD_PRUNE_OCC_DIM", "16"))
_ONE_PASS = __import__("os").environ.get("BUILD_ONE_PASS", "1") != "0"


def _tick(times, name, t0, *arrs):
    """BUILD_PROFILE=1 stage timing (device-synced); no-op otherwise."""
    if not _PROFILE:
        return t0
    import time

    for a in arrs:
        jax.block_until_ready(a)
    t1 = time.time()
    times[name] = times.get(name, 0.0) + (t1 - t0)
    return t1


def _bucket_rows(n: int, block: int = 8192) -> int:
    """Round n up to a size bucket so differently-sized builds share compiled
    programs (every distinct padded row count is a full XLA recompile). Buckets: next power of two below `block`,
    1/8-octave steps above (<= 12.5% padding overhead)."""
    if n <= 256:
        return 256
    if n <= block:
        return 1 << (n - 1).bit_length()
    step = max(block, (1 << ((n - 1).bit_length() - 1)) // 8)
    return ((n + step - 1) // step) * step


def _tiny_graph(x: np.ndarray, r: int):
    """Fully-connected graph for n <= r+1."""
    n = x.shape[0]
    g = np.full((n, r), -1, np.int32)
    for i in range(n):
        others = [j for j in range(n) if j != i]
        g[i, : len(others)] = others
    centroid = x.mean(0)
    medoid = int(((x - centroid) ** 2).sum(1).argmin())
    return g, medoid


_APPROX_KNN = _os.environ.get("VECGO_BUILD_KNN", "approx") == "approx"


@functools.partial(jax.jit, static_argnames=("knn", "overlap", "n_out", "g"))
def _cluster_knn(x16, rnorm2, members, mem_slot, knn: int, overlap: int, n_out: int, g: int):
    """Exact KNN within every cluster, scattered into a per-point table.

    x16 [N, d] bf16; members/mem_slot [K_pad, Cmax] int32 (-1 pad), K_pad % g
    == 0. Processes g clusters per scan step (batched matmul keeps the tensor
    cores busy). Returns cand [n_out+1, overlap, knn] int32 (-1 pad); row n_out is
    the dump row for padded memberships.
    """
    k_pad, cmax = members.shape
    mem_b = members.reshape(k_pad // g, g, cmax)
    slot_b = mem_slot.reshape(k_pad // g, g, cmax)

    def body(cand, inputs):
        mem, slot = inputs  # [g, cmax]
        valid = mem >= 0
        safe = jnp.maximum(mem, 0)
        v = jnp.take(x16, safe.reshape(-1), axis=0).reshape(g, cmax, -1)
        rn = jnp.take(rnorm2, safe)
        prod = jnp.einsum("gcd,ged->gce", v, v, preferred_element_type=jnp.float32)
        dmat = rn[:, :, None] + rn[:, None, :] - 2.0 * prod
        eye = jax.lax.broadcasted_iota(jnp.int32, (1, cmax, cmax), 1) == (
            jax.lax.broadcasted_iota(jnp.int32, (1, cmax, cmax), 2)
        )
        dmat = jnp.where(valid[:, None, :] & ~eye, dmat, jnp.inf)
        if _APPROX_KNN:
            # approx_min_k replaces the full sort-based top_k over the
            # [g, cmax, cmax] tile (the costliest build stage after prune)
            # — per-row recall ~0.95 where the backend bins, absorbed by NN-descent +
            # the prune's candidate slack (graph recall tests hold).
            _, loc = jax.lax.approx_min_k(dmat, knn)
            loc = loc.astype(jnp.int32)
        else:
            _, loc = jax.lax.top_k(-dmat, knn)  # [g, cmax, knn] local indices
        gcand = jnp.take_along_axis(mem[:, None, :], loc, axis=2)
        vtake = jnp.take_along_axis(valid[:, None, :], loc, axis=2)
        gcand = jnp.where(vtake, gcand, -1)
        pt = jnp.where(valid, mem, n_out)
        cand = cand.at[pt, slot].set(gcand, mode="drop")
        return cand, None

    cand0 = jnp.full((n_out + 1, overlap, knn), -1, jnp.int32)
    cand, _ = jax.lax.scan(body, cand0, (mem_b, slot_b))
    return cand


def _score_merge(w_d, w_i, cand, x16, rnorm2, kw: int, block: int):
    """Score candidate ids and merge into the per-point working KNN list.

    w_d/w_i [N_pad, Kw] current list (sorted, -1 pad); cand [N_pad, C] int32.
    Traced helper (inlined into _descend); scan over row blocks.
    """
    from vecgo.ops import beam as beam_ops

    n_pad, c = cand.shape
    nb = n_pad // block
    cand_b = cand.reshape(nb, block, c)
    wd_b = w_d.reshape(nb, block, kw)
    wi_b = w_i.reshape(nb, block, kw)

    def body(_, inputs):
        bi, cands, wd, wi = inputs
        rows = bi * block + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
        q16 = jnp.take(x16, jnp.minimum(rows, x16.shape[0] - 1), axis=0)
        qn = jnp.take(rnorm2, jnp.minimum(rows, rnorm2.shape[0] - 1))[:, None]
        d_new = beam_ops._score_rows(q16, qn, x16, rnorm2, jnp.maximum(cands, 0))
        bad = (cands < 0) | (cands == rows[:, None])
        d_new = jnp.where(bad, jnp.inf, d_new)
        cands = jnp.where(bad, -1, cands)
        md = jnp.concatenate([wd, d_new], axis=1)
        mi = jnp.concatenate([wi, cands], axis=1)
        nd, ni = beam_ops._dedup_topk(md, mi, kw)
        return None, (nd, ni)

    _, (out_d, out_i) = jax.lax.scan(
        body, None, (jnp.arange(nb, dtype=jnp.int32), cand_b, wd_b, wi_b)
    )
    return out_d.reshape(n_pad, kw), out_i.reshape(n_pad, kw)


@functools.partial(jax.jit, static_argnames=("n_pad", "n", "n_rand", "seed"))
def _rand_cand(n_pad: int, n: int, n_rand: int, seed: int):
    """[n_pad, n_rand] pseudo-random node ids, generated on device."""
    key = jax.random.PRNGKey(seed ^ 0x5EED)
    return jax.random.randint(key, (n_pad, n_rand), 0, n, dtype=jnp.int32)


def _reverse_dev(edges, rev_cap: int):
    """Sampled in-edges via hash-scatter, on device (O(E), no sort): for edge
    u->v, u lands in rev[v, h(u)]; collisions drop edges pseudo-randomly.
    edges [N_pad, W] int32 (-1 pad). Returns [N_pad, rev_cap] int32."""
    n_pad, w = edges.shape
    src = jax.lax.broadcasted_iota(jnp.int32, (n_pad, w), 0)
    h = (
        src.astype(jnp.uint32) * jnp.uint32(2654435761) >> jnp.uint32(12)
    ) % jnp.uint32(rev_cap)
    dst = jnp.where(edges >= 0, edges, n_pad)  # dump row
    rev = jnp.full((n_pad + 1, rev_cap), -1, jnp.int32)
    return rev.at[dst, h.astype(jnp.int32)].set(src, mode="drop")[:n_pad]


def _descent_candidates(w_i, hop_a: int, hop_b: int, rev_cap: int):
    """NN-descent candidate generation, all on device: 2-hop samples from the
    working lists + hash-scattered reverse edges. w_i [N_pad, Kw] (row i's
    current approximate KNN). Returns cand [N_pad, hop_a*hop_b + rev_cap]."""
    n_pad, kw = w_i.shape
    nbr = w_i[:, :hop_a]
    hop = jnp.take(w_i, jnp.maximum(nbr, 0).reshape(-1), axis=0, mode="clip")[
        :, :hop_b
    ].reshape(n_pad, hop_a * hop_b)
    hop = jnp.where(jnp.repeat(nbr >= 0, hop_b, axis=1), hop, -1)
    return jnp.concatenate([hop, _reverse_dev(w_i, rev_cap)], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("rounds", "kw", "block", "hop_a", "hop_b", "rev_cap", "salt"),
)
def _descend(
    cand, x16, rnorm2,
    rounds: int, kw: int, block: int, hop_a: int, hop_b: int, rev_cap: int,
    salt: int = 0,
):
    """Initial merge + `rounds` NN-descent iterations as ONE device program.

    Running the feedback loop inside a single jit avoids per-round dispatch
    — the rounds pipeline on device with zero host syncs.
    Returns (w_d, w_i) [N_pad, kw].
    """
    n_pad = cand.shape[0]
    w_d = jnp.full((n_pad, kw), jnp.inf, jnp.float32)
    w_i = jnp.full((n_pad, kw), -1, jnp.int32)
    w_d, w_i = _score_merge(w_d, w_i, cand, x16, rnorm2, kw, block)

    def round_fn(carry, _):
        w_d, w_i = carry
        c2 = _descent_candidates(w_i, hop_a, hop_b, rev_cap)
        return _score_merge(w_d, w_i, c2, x16, rnorm2, kw, block), None

    if rounds > 0:
        (w_d, w_i), _ = jax.lax.scan(round_fn, (w_d, w_i), None, length=rounds)
    if salt:
        return (w_d, w_i), jnp.zeros((salt,), jnp.int32)
    return w_d, w_i


def _prune_blocks(cand_table, vectors, rnorm2, x_occ, rn_occ, r_out: int, alpha: float, block: int, impl: str = "batched", row0: int = 0, pick_batch: int = 8):
    """RobustPrune every row of cand_table [N_pad, L] (N_pad % block == 0),
    scanning row blocks. Traced helper. Returns [N_pad, r_out].

    row0: global row id of cand_table[0] — nonzero when a mesh shard prunes
    its row slice (self-exclusion needs global ids)."""
    from vecgo.ops import beam as beam_ops

    n_pad, l = cand_table.shape
    cand_b = cand_table.reshape(n_pad // block, block, l)

    def body(_, inputs):
        bi, cands = inputs
        rows = row0 + bi * block + jax.lax.broadcasted_iota(
            jnp.int32, (block,), 0
        )
        vecs = jnp.take(vectors, jnp.minimum(rows, vectors.shape[0] - 1), axis=0)
        out = beam_ops.robust_prune_traced(
            rows, vecs, cands, vectors, rnorm2,
            r_out=r_out, alpha=alpha,
            vectors_occ=x_occ, rnorm2_occ=rn_occ, impl=impl,
            pick_batch=pick_batch,
        )
        return None, out

    _, outs = jax.lax.scan(
        body, None, (jnp.arange(n_pad // block, dtype=jnp.int32), cand_b)
    )
    return outs.reshape(n_pad, r_out)


@functools.partial(
    jax.jit,
    static_argnames=("r_out", "alpha", "block", "salt", "impl", "pick_batch"),
)
def _prune_all(
    cand_table, vectors, rnorm2, x_occ, rn_occ,
    r_out: int, alpha: float, block: int, salt: int = 0, impl: str = "batched",
    pick_batch: int = 8,
):
    out = _prune_blocks(
        cand_table, vectors, rnorm2, x_occ, rn_occ, r_out, alpha, block, impl,
        pick_batch=pick_batch,
    )
    if salt:
        # Salted retry (utils/devbug): the extra dummy output changes the
        # executable signature so a poisoned runtime slot is bypassed.
        return out, jnp.zeros((salt,), jnp.int32)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "r_out", "alpha", "block", "rev_cap", "salt", "impl", "pick_batch"
    ),
)
def _prune_with_reverse(
    graph, vectors, rnorm2, x_occ, rn_occ,
    r_out: int, alpha: float, block: int, rev_cap: int, salt: int = 0,
    impl: str = "batched",
    pick_batch: int = 8,
):
    """Reverse-edge pass + re-prune (reference writer.go:627), fused: build
    sampled in-edges on device, concat with the forward graph, re-prune."""
    rev = _reverse_dev(graph, rev_cap)
    cand = jnp.concatenate([graph, rev], axis=1)
    out = _prune_blocks(
        cand, vectors, rnorm2, x_occ, rn_occ, r_out, alpha, block, impl,
        pick_batch=pick_batch,
    )
    if salt:
        return out, jnp.zeros((salt,), jnp.int32)
    return out


@functools.partial(jax.jit, static_argnames=("overlap", "block"))
def _assign_topk(z, znorm2, centers, overlap: int, block: int):
    """Per-point `overlap` nearest centroids in projection space.

    z [N_pad, d'] f32 device; centers [K, d']. Returns (assign [N_pad, ov]
    int32, dist [N_pad, ov] f32), both device."""
    n_pad = z.shape[0]
    c16 = centers.astype(jnp.bfloat16)
    cn = jnp.sum(centers.astype(jnp.float32) ** 2, axis=1)
    zb = z.reshape(n_pad // block, block, z.shape[1])
    nb_ = znorm2.reshape(n_pad // block, block)

    def body(_, inputs):
        blk, bn = inputs
        prod = jax.lax.dot_general(
            blk.astype(jnp.bfloat16), c16,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dmat = bn[:, None] + cn[None, :] - 2.0 * prod
        nd, idx = jax.lax.top_k(-dmat, overlap)
        return None, (idx.astype(jnp.int32), -nd)

    _, (a, dd) = jax.lax.scan(body, None, (zb, nb_))
    return a.reshape(n_pad, overlap), dd.reshape(n_pad, overlap)


@functools.partial(jax.jit, static_argnames=("k", "cmax"))
def _membership_sort(assign, dists, k: int, cmax: int):
    """Sort-based membership (round-1 implementation; kept as a toggle for
    bisecting runtime issues — BUILD_SORT_MEMBERSHIP=1). Costly to COMPILE
    on some backends (a sort lowering of O(log^2 m) stages), fast to run."""
    n, ov = assign.shape
    m = n * ov
    cl = assign.reshape(-1).astype(jnp.int32)
    dd = dists.reshape(-1)
    pt = jax.lax.broadcasted_iota(jnp.int32, (n, ov), 0).reshape(-1)
    sl = jax.lax.broadcasted_iota(jnp.int32, (n, ov), 1).reshape(-1)
    cl_s, sl_s, dd_s, pt_s = jax.lax.sort((cl, sl, dd, pt), num_keys=3)
    pos_all = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    boundary = jnp.concatenate([jnp.ones((1,), bool), cl_s[1:] != cl_s[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, pos_all, 0)
    )
    pos = pos_all - run_start
    keep = pos < cmax
    row = jnp.where(keep, cl_s, k)
    col = jnp.minimum(pos, cmax - 1)
    members = (
        jnp.full((k + 1, cmax), -1, jnp.int32).at[row, col].set(pt_s, mode="drop")[:k]
    )
    mem_slot = (
        jnp.zeros((k + 1, cmax), jnp.int32).at[row, col].set(sl_s, mode="drop")[:k]
    )
    entry_nodes = members[:, 0]
    covered = (
        jnp.zeros((n + 1,), bool)
        .at[jnp.where(keep, pt_s, n)].set(True, mode="drop")[:n]
    )
    return members, mem_slot, entry_nodes, covered


@functools.partial(jax.jit, static_argnames=("k", "cmax"))
def _membership_scatter(assign, dists, k: int, cmax: int):
    """Capacity-capped membership via HASH-SCATTER ROUNDS.

    assign/dists [N, ov] device (dists kept for interface parity; priority
    within a cluster is slot order, then hash luck). Returns (members
    [k, cmax] i32, mem_slot [k, cmax] i32, entry_nodes [k] i32, covered [n]).

    Design note: the previous implementation was a 3-key lax.sort over all
    N*ov memberships — correct and fast to RUN, but a sort lowering that
    emits O(log² m) kernel stages made XLA compile take minutes per distinct
    shape at m = 2-4M. Scatter rounds compile quickly: each (point, slot) membership tries `rounds` hashed
    positions in its cluster row; first-come-wins via a max-scatter, placed
    memberships retire, slot 0 (primary) goes first so it wins capacity.
    Collision drops are recovered by later rounds / later slots, and any
    still-uncovered points by the callers' host fix-up."""
    n, ov = assign.shape
    pt_col = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    members = jnp.full((k + 1, cmax), -1, jnp.int32)
    mem_slot = jnp.zeros((k + 1, cmax), jnp.int32)
    placed_any = jnp.zeros((n,), bool)
    # Distance-priority WAVES: under capacity overflow, the sort version kept
    # each cluster's NEAREST members; random drops instead evict core points
    # into unreachable clusters (measured 0.978 -> 0.894 recall@10 on the
    # serving table). Approximate that priority by placing global distance
    # quantiles nearest-first (thresholds from a device quantile of the slot-0
    # distances; coarse is fine — priority only matters between waves).
    waves = 4
    # Quantiles over VALID rows only: both callers route padded rows to the
    # dump cluster (assign == k-1) and their dists are +inf or zero-vector
    # artifacts; near a block boundary padding approaches 50% of rows and
    # would skew the wave thresholds badly.
    d0 = dists[:, 0].astype(jnp.float32)
    row_valid = (assign[:, 0] < (k - 1)) & jnp.isfinite(d0)
    qs = jnp.nanquantile(
        jnp.where(row_valid, d0, jnp.nan),
        jnp.asarray([0.25, 0.5, 0.75], jnp.float32),
    )
    bucket = (
        (dists > qs[0]).astype(jnp.int32)
        + (dists > qs[1]).astype(jnp.int32)
        + (dists > qs[2]).astype(jnp.int32)
    )  # [N, ov] in 0..3, 0 = nearest
    # Per-(slot, wave) placement-failure is ~load^rounds at that point in the
    # fill; 6 tries per wave x 4 waves bounds the miss rate while keeping the
    # op count (ov x waves x rounds scatters over [N]) in the hundreds.
    rounds = 6
    for s in range(ov):
        cl = assign[:, s].astype(jnp.int32)
        cl = jnp.minimum(cl, k)  # dump row guards stray ids
        need = jnp.ones((n,), bool)  # per-slot: overlap memberships all try
        for w in range(waves):
            eligible = bucket[:, s] <= w  # unplaced earlier waves retry
            for r in range(rounds):
                h = (
                    (pt_col.astype(jnp.uint32) * jnp.uint32(2654435761))
                    ^ jnp.uint32(
                        ((w * 7 + r) * 0x9E3779B9 + s * 0x85EBCA6B) & 0xFFFFFFFF
                    )
                )
                pos = (h % jnp.uint32(cmax)).astype(jnp.int32)
                trying = need & eligible
                row = jnp.where(trying, cl, k)  # retired -> dump row
                free = jnp.take(members.reshape(-1), row * cmax + pos) < 0
                row = jnp.where(free, row, k)
                members = members.at[row, pos].max(pt_col, mode="drop")
                won = jnp.take(members.reshape(-1), row * cmax + pos) == pt_col
                won = won & trying & free
                mem_slot = mem_slot.at[
                    jnp.where(won, row, k), pos
                ].set(jnp.int32(s), mode="drop")
                placed_any = placed_any | won
                need = need & ~won
    members = members[:k]
    mem_slot = mem_slot[:k]
    # Entry node per cluster: any member (first occupied column).
    first_col = jnp.argmax(members >= 0, axis=1)
    entry_nodes = jnp.take_along_axis(members, first_col[:, None], axis=1)[:, 0]
    return members, mem_slot, entry_nodes, placed_any


def _membership_dev(assign, dists, k: int, cmax: int):
    if _SORT_MEMBERSHIP:
        return _membership_sort(assign, dists, k, cmax)
    return _membership_scatter(assign, dists, k, cmax)



def _build_membership(assign: np.ndarray, dists: np.ndarray, k: int, cmax: int):
    """Capacity-capped membership table (host). Returns (members [K, Cmax]
    int32, mem_slot [K, Cmax] int32, entry_nodes [K] int32)."""
    n, overlap = assign.shape
    pt = np.repeat(np.arange(n, dtype=np.int64), overlap)
    slot = np.tile(np.arange(overlap, dtype=np.int64), n)
    cl = assign.reshape(-1).astype(np.int64)
    dd = dists.reshape(-1)
    # Within each cluster: slot-0 (primary) memberships first, then by dist —
    # primaries get capacity priority so every point keeps >= 1 membership.
    order = np.lexsort((dd, slot, cl))
    cl_s, pt_s, slot_s = cl[order], pt[order], slot[order]
    starts = np.searchsorted(cl_s, np.arange(k))
    pos = np.arange(len(cl_s)) - starts[cl_s]
    keep = pos < cmax
    members = np.full((k, cmax), -1, np.int32)
    mem_slot = np.zeros((k, cmax), np.int32)
    members[cl_s[keep], pos[keep]] = pt_s[keep]
    mem_slot[cl_s[keep], pos[keep]] = slot_s[keep]
    entry_nodes = members[:, 0].copy()  # nearest primary member per cluster
    covered = np.zeros(n, bool)
    covered[pt_s[keep]] = True
    n_dropped = int((~covered).sum())
    if n_dropped:
        # Pathological skew: spill uncovered points into spare slots anywhere
        # (their KNN will be poor; reverse edges keep them reachable).
        spare_rows, spare_cols = np.nonzero(members == -1)
        leftovers = np.flatnonzero(~covered)
        take = min(len(leftovers), len(spare_rows))
        members[spare_rows[:take], spare_cols[:take]] = leftovers[:take]
        mem_slot[spare_rows[:take], spare_cols[:take]] = 0
        logger.warning("clustered build: %d points spilled to spare slots", n_dropped)
    return members, mem_slot, entry_nodes


@jax.jit
def _complete_membership_dev(members, covered_n):
    """Coverage completion ON DEVICE: rows dropped by capacity pressure get
    any free (-1) slot, i-th uncovered row -> i-th free slot (same semantics
    as the host path below, minus its warning log). One 1-D sort + cumsums —
    keeps the membership device-resident for device_table_coded (a host
    round trip would move it twice for nothing).

    members [K, S] int32 (-1 free); covered_n [n] bool. Returns [K, S]."""
    k, s = members.shape
    n = covered_n.shape[0]
    flat = members.reshape(-1)
    free = flat < 0
    rank = jnp.clip(jnp.cumsum(free.astype(jnp.int32)) - 1, 0, n - 1)
    rows = jnp.arange(n, dtype=jnp.int32)
    # Compact uncovered rows to the front (row order preserved by the sort).
    lv_sorted = jax.lax.sort(jnp.where(covered_n, n, rows))
    n_left = jnp.sum((~covered_n).astype(jnp.int32))
    fill = jnp.take(lv_sorted, rank)
    fill_ok = free & (jnp.cumsum(free.astype(jnp.int32)) - 1 < n_left)
    return jnp.where(fill_ok, fill, flat).reshape(k, s)


def _reverse_scatter(g: np.ndarray, cap: int) -> np.ndarray:
    """Host-side hash-scatter of sampled in-edges (kept for tools/tests; the
    build itself uses the device twin _reverse_dev)."""
    n, r = g.shape
    src = np.repeat(np.arange(n, dtype=np.int32), r)
    dst = g.reshape(-1)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    h = (
        (src.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
    ) % np.uint64(cap)
    rev = np.full((n, cap), -1, np.int32)
    rev[dst, h.astype(np.int64)] = src
    return rev


def build_graph_clustered(
    x: np.ndarray,
    r: int = 32,
    alpha: float = 1.2,
    seed: int = 42,
    cluster_size: int = 1024,
    overlap: int = 2,
    knn: int = 0,
    n_rand: int = 8,
    rev_cap: int = 0,
    prune_block: int = 0,  # 0 = auto: 32768 at >=128k rows (measured -18%
    # prune time at 1M vs 8192 — fewer scan dispatches; same math), 8192
    # below (smaller padding waste).
    kmeans_iters: int = 5,
    cluster_group: int = 0,
    refine_rounds: int = 1,
    hop2: int = 64,
    restarts: int = 1,
    return_device: bool = False,
    return_membership: bool = False,
    mesh=None,  # jax.sharding.Mesh: shard the cluster-KNN stage across it
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Build a Vamana-style graph over x [N, d] without graph search.

    Returns (graph [N, r] int32, medoid, entry_centroids [K, d],
    entry_nodes [K]). entry_centroids are the entry nodes' own vectors —
    search-time probing only needs representative anchors, and this avoids a
    second full-corpus pass to compute exact means.

    return_membership=True appends the build's own capacity-capped cluster
    membership table [K, cluster_size] int32 (-1 padded, restart 0) to the
    return tuple — the SERVING shortlist structure derives from it directly
    (ops/ivf.device_table_coded), so no second k-means/assignment pass is
    ever run (VERDICT r2 #4). Coverage is
    completed host-side: rows dropped by capacity pressure go into free
    slots.

    return_device=True leaves the graph on device (the serving-side layout;
    callers that serialize pay the D2H themselves; it is not part of the
    build).
    """
    import ml_dtypes

    from vecgo.quantization import kmeans as km

    import time as _time

    times: dict = {}
    t0 = _time.time()
    n, d = x.shape
    device_input = isinstance(x, jax.Array)
    rng = np.random.default_rng(seed)
    if n == 0:
        return (
            np.zeros((0, r), np.int32), 0,
            np.zeros((0, d), np.float32), np.zeros(0, np.int32),
        )
    if n <= r + 1:
        xh = np.asarray(x, np.float32)
        g, medoid = _tiny_graph(xh, r)
        out = (
            g, medoid, xh[medoid : medoid + 1].copy(),
            np.asarray([medoid], np.int32),
        )
        if return_membership:
            out = out + (np.arange(n, dtype=np.int32)[None, :],)
        return out

    # Width economics (measured at 1M, r=32): the
    # serving path's recall rests on the IVF shortlist + exact rerank, so
    # graph-build candidate widths trade build time against refine/legacy
    # quality only. knn=3r/4 per membership (2 overlap clusters -> 1.5r
    # union) measured recall-IDENTICAL on the headline, p=6, and refine=1
    # screens at 1M while cutting cluster-KNN and descent time by about a
    # quarter. Trimming n_rand/rev_cap as well saved a little more but
    # broke the SMALL-corpus beam-path recall floor (0.931 < 0.95 at
    # n=1500/r=24) — long-range random edges and reverse coverage carry the
    # legacy graph path at small n, so those widths stay. The prune pool
    # (kw=1.5r working list + n_rand + rev_cap) is never narrower than r,
    # and knn never drops below 24.
    knn = knn or max(24, (3 * r) // 4)
    rev_cap = rev_cap or max(r // 2, 8)
    overlap = max(1, min(overlap, 4))
    if prune_block <= 0:
        prune_block = 32768 if n >= 131072 else 8192

    # Pad the corpus to a size bucket (compile reuse across builds). Padded
    # rows carry +inf norms: no distance path can ever select them, and the
    # partition stage routes them to a dump cluster explicitly.
    n_full = _bucket_rows(n, prune_block)
    if device_input:
        # Device-resident corpus (the serving/ingest-native case — e.g. bench
        # uploads once outside the timed region; flush data already in HBM):
        # pad + norms computed on device, no host prep, no upload.
        x16 = x.astype(jnp.bfloat16)
        if n_full > n:
            x16 = jnp.pad(x16, ((0, n_full - n), (0, 0)))
        rn_dev = jnp.sum(
            x16.astype(jnp.float32) ** 2, axis=1
        )
        row_ok = jnp.arange(n_full) < n
        rnorm2 = jnp.where(row_ok, rn_dev, jnp.inf)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as _P

            rep = NamedSharding(mesh, _P())
            x16 = jax.device_put(x16, rep)
            rnorm2 = jax.device_put(rnorm2, rep)
        mean16 = (
            jnp.sum(x16.astype(jnp.float32), axis=0) / n
        ).astype(jnp.bfloat16)
        t0 = _tick(times, "device_prep", t0, x16, rnorm2)
    else:
        x = np.ascontiguousarray(x, np.float32)
        xb = x.astype(ml_dtypes.bfloat16)
        if n_full > n:
            xb = np.concatenate(
                [xb, np.zeros((n_full - n, d), ml_dtypes.bfloat16)]
            )
        rn_host = np.full(n_full, np.inf, np.float32)
        rn_host[:n] = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
        t0 = _tick(times, "host_prep", t0)

        # ONE bf16 corpus upload; exact f32 norms ride along (host f64 reduce).
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as _P

            rep = NamedSharding(mesh, _P())
            x16 = jax.device_put(xb, rep)
            rnorm2 = jax.device_put(rn_host, rep)
        else:
            x16 = jnp.asarray(xb)
            rnorm2 = jnp.asarray(rn_host)
        mean16 = jnp.asarray(x.mean(0, dtype=np.float64).astype(ml_dtypes.bfloat16))
    medoid_dev = jnp.argmin(rnorm2 - 2.0 * (x16 @ mean16).astype(jnp.float32))
    t0 = _tick(times, "upload+medoid", t0, x16, rnorm2, medoid_dev)

    # JL projections (device): [0] doubles as the RobustPrune occlusion space;
    # each restart partitions under its own projection.
    pdim = min(OCC_DIM, d)

    def _to_dev(arr):
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as _P

            return jax.device_put(arr, NamedSharding(mesh, _P()))
        return jnp.asarray(arr)

    projs = [
        _to_dev(
            (rng.standard_normal((d, pdim)) / math.sqrt(pdim)).astype(
                ml_dtypes.bfloat16
            )
        )
        for _ in range(max(1, restarts))
    ]
    if d > pdim:
        x_occ = (x16 @ projs[0]).astype(jnp.float32)
        rn_occ = jnp.sum(x_occ * x_occ, axis=1)
    else:
        x_occ = x16.astype(jnp.float32)
        rn_occ = rnorm2
    if _PRUNE_OCC_DIM and _PRUNE_OCC_DIM < min(pdim, d) and n_full >= 100_000:
        # Decoupled prune-occlusion space: occlusion is a coarse geometric
        # filter and tolerates a narrower projection than the partition does
        # (prune cost scales with occ width; the partition drives serving
        # recall and keeps the full OCC_DIM). Large-n only: the 1M serving
        # screens are recall-neutral, but small corpora (n<=~10k, where every
        # edge matters and the prune pool is thin) measurably lose graph
        # recall under the 16-dim space — and their prune is cheap anyway.
        proj_p = _to_dev(
            (rng.standard_normal((d, _PRUNE_OCC_DIM))
             / math.sqrt(_PRUNE_OCC_DIM)).astype(ml_dtypes.bfloat16)
        )
        x_occ_p = (x16 @ proj_p).astype(jnp.float32)
        rn_occ_p = jnp.sum(x_occ_p * x_occ_p, axis=1)
    else:
        x_occ_p, rn_occ_p = x_occ, rn_occ
    t0 = _tick(times, "jl_project", t0, x_occ, rn_occ, x_occ_p)

    block = min(prune_block, n_full)
    pad_n = n_full  # bucket sizes are block-aligned by construction

    def _padded(tbl, fill=-1):
        if tbl.shape[0] < pad_n:
            tbl = jnp.concatenate(
                [tbl, jnp.full((pad_n - tbl.shape[0], tbl.shape[1]), fill, tbl.dtype)]
            )
        return tbl

    # ---- partition (projected) + cluster-local exact KNN (full-dim) ----
    entry_nodes_dev = None
    n_dropped_dev = None
    cand_parts = []
    for t in range(max(1, restarts)):
        if d > pdim:
            z = x_occ if t == 0 else (x16 @ projs[t]).astype(jnp.float32)
            zn = rn_occ if t == 0 else jnp.sum(z * z, axis=1)
        else:
            z, zn = x_occ, rn_occ
        cmax = min(cluster_size, n)
        g_batch = cluster_group or max(1, min(64, 65536 // cmax))
        if n <= 2 * cmax:
            # Small corpus: one global "cluster" = exact KNN over everything.
            k_clusters, ov_t, cmax = 1, 1, n_full
            g_batch = 1
            k_pad = 1
            ar = jnp.arange(n_full, dtype=jnp.int32)
            members = jnp.where(ar < n, ar, -1)[None, :]
            mem_slot = jnp.zeros((1, n_full), jnp.int32)
            enodes_t = medoid_dev.astype(jnp.int32)[None]
        else:
            ov_t = overlap
            k_clusters = max(2, math.ceil(n * ov_t * 1.4 / cmax))
            n_sample = min(n, max(32768, 12 * k_clusters))
            idx = rng.choice(n, n_sample, replace=False)
            # Device-resident sample + training: the old path moved the
            # sample D2H and the centers both ways. Only the (tiny) index
            # vectors cross the link now.
            z_sample = jnp.take(z, jnp.asarray(idx, dtype=jnp.int32), axis=0)
            t0 = _tick(times, "kmeans_sample", t0)
            centers, _ = km.train_kmeans_dev(
                z_sample, k_clusters, iters=kmeans_iters,
                seed=seed + 101 * t, sample=n_sample,
            )
            t0 = _tick(times, "kmeans_train", t0)
            a_dev, d_dev = _assign_topk(
                _padded(z, 0.0),
                _padded(zn[:, None], 0.0)[:, 0],
                centers,
                ov_t,
                block,  # divides pad_n by construction
            )
            # Membership stays on device (host lexsort costs 10-20s at 1M).
            # Padded assignment rows carry cluster ids too — point them at a
            # dump cluster beyond k_pad so they never join a real cluster.
            t0 = _tick(times, "assign_topk", t0, a_dev, d_dev)
            k_pad = ((k_clusters + g_batch - 1) // g_batch) * g_batch
            row_valid = jax.lax.broadcasted_iota(jnp.int32, (pad_n, 1), 0) < n
            a_dev = jnp.where(row_valid, a_dev, k_pad)
            members, mem_slot, enodes_t, covered = _membership_dev(
                a_dev, d_dev, k_pad + 1, cmax
            )
            t0 = _tick(times, "membership", t0, members, mem_slot)
            members, mem_slot = members[:k_pad], mem_slot[:k_pad]
            enodes_t = enodes_t[:k_clusters]
            nd = n - jnp.sum(covered[:n].astype(jnp.int32))
            n_dropped_dev = nd if n_dropped_dev is None else jnp.minimum(n_dropped_dev, nd)
        if t == 0 and return_membership:
            members_t0 = members
            covered_t0 = covered if n > 2 * cmax else None
        if entry_nodes_dev is None:
            entry_nodes_dev = jnp.where(
                enodes_t >= 0, enodes_t, medoid_dev.astype(jnp.int32)
            )
        knn_eff = min(knn, min(cmax, n) - 1)
        if mesh is not None:
            # The FLOP-dominant stage shards across the mesh: clusters are
            # independent work units (parallel/engine_shard.sharded_cluster_knn).
            from vecgo.parallel.engine_shard import sharded_cluster_knn

            cand_t = sharded_cluster_knn(
                x16, rnorm2, np.asarray(members), np.asarray(mem_slot),
                knn_eff, ov_t, pad_n, g_batch, mesh,
            )
        else:
            cand_t = _cluster_knn(
                x16, rnorm2, members, mem_slot,
                knn_eff, ov_t, pad_n, g_batch,
            )
        cand_parts.append(cand_t[:pad_n].reshape(pad_n, ov_t * knn_eff))
        t0 = _tick(times, "cluster_knn", t0, cand_parts[-1])
    cand = cand_parts[0] if len(cand_parts) == 1 else jnp.concatenate(cand_parts, axis=1)

    # ---- NN-descent on a pure-KNN working list (no pruning yet) ----
    # Descent converges the working list toward the true KNN graph on
    # semi-structured data. Pruning during descent would break it: alpha
    # diversification discards the near-duplicates descent climbs through.
    # (On truly uniform high-d data descent stalls — neighbors-of-neighbors
    # locality doesn't hold; `restarts` is the lever there.)
    # Working-list width; prune consumes the top-kw + random far edges.
    # Scales with r so the prune pool is never narrower than the out-degree.
    kw = max(48, int(1.5 * r))
    hop_a, hop_b = min(16, kw), max(1, hop2 // 16)

    def _retry(make, tag):
        # Executable-reuse bug containment — see utils/devbug.py. `make`
        # accepts salt: int; salt > 0 recompiles the stage with a changed
        # executable signature, bypassing a poisoned runtime slot that
        # clear_caches alone cannot evict (observed: _prune_all dispatch
        # deterministically fails after the full build sequence has run,
        # while the identical program runs fine in a fresh process).
        import time as _t

        from vecgo.utils.devbug import call_compiled

        try:
            return call_compiled(make)
        except Exception as e:  # noqa: BLE001
            if "INVALID_ARGUMENT" not in str(e):
                raise
        # The dispatch failure is FLAKY (the same salted recompile has been
        # observed to both fail and succeed): walk a ladder of
        # signature-changing recompiles with pauses, then the sequential
        # program shape as a last resort.
        last = None
        for attempt, kw in enumerate(
            ({"salt": 1}, {"salt": 2}, {"impl": "seq"},
             {"impl": "seq", "salt": 1}, {"salt": 3}),
        ):
            _t.sleep(2.0 * (attempt + 1))
            try:
                logger.warning("%s: retry %d with %r", tag, attempt, kw)
                out = jax.block_until_ready(make(**kw))
                return out[0] if kw.get("salt") else out
            except Exception as e:  # noqa: BLE001
                if "INVALID_ARGUMENT" not in str(e):
                    raise
                last = e
                jax.clear_caches()
        raise last

    w_d, w_i = _retry(
        lambda salt=0, impl=None: _descend(
            _padded(cand), x16, rnorm2,
            max(refine_rounds, 0), kw, block, hop_a, hop_b, rev_cap,
            salt=salt,
        ),
        "descend",
    )
    t0 = _tick(times, "descend", t0, w_d, w_i)

    # ---- RobustPrune the converged lists (+ random far candidates) ----
    cand_final = w_i
    if n_rand > 0:
        if _HOST_RAND:
            randc = _padded(jnp.asarray(
                rng.integers(0, n, size=(n, n_rand), dtype=np.int64).astype(np.int32)
            ))
        else:
            # Random far candidates generated ON DEVICE (host RNG would add a
            # 32 MB upload at 1M).
            randc = _rand_cand(pad_n, n, n_rand, seed)
        cand_final = jnp.concatenate([cand_final, randc], axis=1)
    t0 = _tick(times, "rand_cand", t0, cand_final)
    if _ONE_PASS:
        # Default: reverse candidates from the descent working list's top-r
        # (symmetrized KNN), folded into the single alpha-prune pass below —
        # measured recall-identical to the two-pass pipeline at 1M and one
        # full prune pass cheaper (module-constant comment above).
        cand_final = jnp.concatenate(
            [cand_final, _reverse_dev(w_i[:, :r], rev_cap)], axis=1
        )
    if _CANON_OPS:
        # Diagnostic/workaround: re-materialize the ACTUAL prune operands
        # (after the one-pass concat, in the decoupled occlusion space)
        # through a compiled identity — canonical layouts before dispatch.
        _ident = jax.jit(lambda a, b, c: (a + 0, b + 0.0, c + 0.0))
        cand_final, x_occ_p, rn_occ_p = jax.block_until_ready(
            _ident(cand_final, x_occ_p, rn_occ_p)
        )
    if mesh is not None:
        # Sharded prune: rows split across the mesh (one pass by default;
        # two passes + one all_gather with BUILD_ONE_PASS=0 —
        # parallel/engine_shard.sharded_prune).
        from vecgo.parallel.engine_shard import sharded_prune

        graph = jax.block_until_ready(
            sharded_prune(
                cand_final, x16, rnorm2, x_occ_p, rn_occ_p, r, alpha, block,
                rev_cap, mesh, one_pass=_ONE_PASS,
            )
        )
        t0 = _tick(times, "prune_sharded", t0, graph)
    elif _ONE_PASS:
        graph = _retry(
            lambda salt=0, impl="batched": _prune_all(
                cand_final, x16, rnorm2, x_occ_p, rn_occ_p, r, alpha, block,
                salt=salt, impl=impl,
            ),
            "prune(one-pass)",
        )
        t0 = _tick(times, "prune_one_pass", t0, graph)
    else:
        graph = _retry(
            lambda salt=0, impl="batched": _prune_all(
                cand_final, x16, rnorm2, x_occ_p, rn_occ_p, r, alpha, block,
                salt=salt, impl=impl,
            ),
            "prune",
        )
        t0 = _tick(times, "prune_all", t0, graph)

        # ---- reverse-edge pass + re-prune, fused on device ----
        graph = _retry(
            lambda salt=0, impl="batched": _prune_with_reverse(
                graph, x16, rnorm2, x_occ_p, rn_occ_p, r, alpha, block, rev_cap,
                salt=salt, impl=impl,
            ),
            "prune+reverse",
        )
        t0 = _tick(times, "prune_reverse", t0, graph)
    if _PROFILE and times:
        import sys as _sys

        total = sum(times.values())
        print(f"[build_fast profile] total {total:.2f}s", file=_sys.stderr)
        for k_, v in sorted(times.items(), key=lambda kv: -kv[1]):
            print(f"  {k_:24s} {v*1e3:9.1f} ms", file=_sys.stderr)

    medoid = int(np.asarray(medoid_dev))
    entry_nodes = np.asarray(entry_nodes_dev)
    if device_input:
        entry_centroids = np.asarray(
            jnp.take(x16, jnp.asarray(entry_nodes), axis=0).astype(jnp.float32)
        )
    else:
        entry_centroids = x[entry_nodes].copy()
    if n_dropped_dev is not None:
        nd = int(np.asarray(n_dropped_dev))
        if nd > 0:
            logger.info(
                "clustered build: %d/%d points had no cluster membership "
                "(capacity overflow); reverse edges keep them reachable", nd, n,
            )
    graph = graph[:n]
    if not return_device:
        graph = np.asarray(graph)  # the ONE big D2H
    if return_membership == "device":
        # Device-resident membership (bench / flush feed device_table_coded
        # directly): coverage completion runs on device, nothing crosses the
        # link. Callers that persist the membership pay the D2H themselves.
        if covered_t0 is not None:
            members_dev = _complete_membership_dev(members_t0, covered_t0[:n])
        else:
            members_dev = members_t0
        return graph, medoid, entry_centroids, entry_nodes, members_dev
    if return_membership:
        members_np = np.asarray(members_t0).astype(np.int32, copy=True)
        # Rows beyond n (bucket padding routed to the dump cluster) never
        # appear; rows dropped by capacity pressure get ANY free slot so the
        # serving scan can reach every row.
        if covered_t0 is not None:
            cov = np.asarray(covered_t0[:n])
            if not cov.all():
                free_r, free_c = np.nonzero(members_np == -1)
                leftovers = np.flatnonzero(~cov)
                take = min(len(leftovers), len(free_r))
                members_np[free_r[:take], free_c[:take]] = leftovers[:take]
                if take < len(leftovers):
                    logger.warning(
                        "build membership: %d rows uncovered (no free slots)",
                        len(leftovers) - take,
                    )
        return graph, medoid, entry_centroids, entry_nodes, members_np
    return graph, medoid, entry_centroids, entry_nodes

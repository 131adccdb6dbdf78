"""Blocked IVF scan: sublinear query scoring with query-grouped cluster visits.

The reference's DiskANN segment walks a graph per query (diskann/segment.go:503)
and its flat segment masks IVF partitions inside a full scan
(flat/segment.go:447, writer.go:101-147 trains the partitions). Neither shape
fits matrix hardware: per-query pointer chasing is latency-bound gathers, and the
masked full scan does all N rows of FLOPs regardless of nprobe.

This module is the device-side sublinear path. Layout: rows are bucketed into K
capacity-capped clusters and materialized as a padded dense tensor
`blocks [K, S, d]` (bf16) living in HBM. A query batch then:

  1. scores centroids [B, K] with one matmul and takes its `n_probe` clusters,
  2. INVERTS the probe lists — for each cluster, which queries probe it —
     with one device sort (run-position arithmetic, no host sync),
  3. scans cluster groups: each group loads `[g, S, d]` contiguous rows
     (a lax.scan slice — streaming HBM reads, zero gathers) and scores them
     against the [g, qcap, d] queries probing those clusters in one batched
     matmul, keeping per-(query, cluster) top-kk,
  4. scatters the per-cluster winners back to per-query candidate tables.

Total FLOPs ≈ K·qcap·S·d ≈ B·n_probe·S·d·(padding slack) — independent of N
for fixed probe budget. The candidates then feed graph refinement
(ops/beam.beam_search with per-query entries) and exact rerank.

Capacity caps: each cluster holds at most S rows (overflow spills to the
point's next-nearest cluster; guaranteed coverage via a host fix-up), and each
cluster serves at most `qcap` queries per batch (excess probes drop — bounded
recall loss under extreme query skew, controlled by qcap).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class IVFDeviceTable(NamedTuple):
    """Device-resident blocked layout (see module docstring).

    Blocks hold cluster-centered RESIDUALS (x - centroid) in bf16: the scan
    scores d(q,x) = |q-c|² + |x-c|² - 2(q-c)·(x-c), an exact identity whose
    bf16 rounding scales with the small residual magnitudes instead of the
    raw vector norms — near-f32 ranking inside tight clusters at bf16
    bandwidth (the IVF analogue of ScaNN's residual quantization)."""

    blocks: jax.Array  # [K, S, d] bf16 residuals (x - centroid), padding zero
    bnorm2: jax.Array  # [K, S] f32 |x - c|², +inf at padded slots
    rows: jax.Array  # [K, S] int32 segment row per slot, -1 padded
    centroids: jax.Array  # [K, d] f32 (cluster centers used for residuals)
    cnorm2: jax.Array  # [K] f32, +inf for empty/padded clusters


class IVFCodedTable(NamedTuple):
    """SQ8-residual blocked layout: the SERVING-memory representation.

    The reference's DiskANN core serves from quantized codes with only codes
    resident (segment.go:503-708, per-vector costs doc.go:52-59); this is the
    device analogue. Residuals (x - centroid) are int8-coded with a per-cluster
    scale — the scan streams 1 byte/dim (2x the bf16 table's bandwidth) and
    the table is the ONLY vector data in HBM: graph refinement and rerank
    both score codes through `slot_of_row` gathers, so the bf16/f32 full
    copies of round 2 are gone (8-9 bytes/dim/row -> ~1.4-2.8 + graph).

    Distances are vs the DECODED vector x̂ = c + s*code, computed by exact
    identity |q-x̂|² = |q-c|² + |x̂-c|² - 2(q-c)·(x̂-c); with residual
    |x̂-c| ~ cluster radius, the int8 step is radius/127 — ranking error far
    below bf16-on-raw-vectors. Final exact-on-x ranking, when required,
    reranks the tiny top-k window host-side (index/common.rerank_host_rows).
    """

    codes: jax.Array  # [K, S, d] int8 residual codes, padding zero
    scale: jax.Array  # [K] f32 dequant scale (max|res| / 127 per cluster)
    bnorm2: jax.Array  # [K, S] f32 |x̂ - c|² (decoded), +inf at padded slots
    xnorm2: jax.Array  # [K, S] f32 |x̂|² (decoded absolute), +inf padded
    rows: jax.Array  # [K, S] int32 segment row per slot, -1 padded
    slot_of_row: jax.Array  # [N] int32 a slot containing each row
    centroids: jax.Array  # [K, d] f32 (member means)
    cnorm2: jax.Array  # [K] f32, +inf for empty/padded clusters
    # Optional REFINEMENT PLANE (+2 B/dim/row): per-ROW int16 residual codes
    # at step scale*127/32767 (254x finer than the scan's int8), encoded from
    # the f32 source. The probed decomposition
    # showed the int8 x̂ rescore caps recall ~2 points below what the ef-pool
    # contains (0.977 vs 0.999 at 200k) — rescoring the pool against the
    # int16 decode recovers the pool bound without f32 rows in HBM.
    rcodes: Optional[jax.Array] = None  # [N, d] int16, None = no plane


# int16 refinement step as a multiple of the int8 scale: the int8 plane
# spans max|res| = 127*scale; the int16 plane re-encodes the same residual
# range at 32767 steps -> rscale = scale * (127/32767).
RSCALE_RATIO = 127.0 / 32767.0


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_probe", "block"))
def _assign_topk_full(x16, rnorm2, centroids, n_probe: int, block: int):
    """Per-row `n_probe` nearest centroids, full dimension. x16 [N_pad, d]
    bf16 (padded rows carry +inf rnorm2); returns (assign [N_pad, P] i32,
    dist [N_pad, P] f32)."""
    n_pad = x16.shape[0]
    c16 = centroids.astype(jnp.bfloat16)
    cn = jnp.sum(centroids.astype(jnp.float32) ** 2, axis=1)
    xb = x16.reshape(n_pad // block, block, x16.shape[1])
    nb = rnorm2.reshape(n_pad // block, block)

    def body(_, inputs):
        blk, bn = inputs
        prod = jax.lax.dot_general(
            blk, c16, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dmat = bn[:, None] + cn[None, :] - 2.0 * prod
        nd, idx = jax.lax.top_k(-dmat, n_probe)
        return None, (idx.astype(jnp.int32), -nd)

    _, (a, dd) = jax.lax.scan(body, None, (xb, nb))
    return a.reshape(n_pad, n_probe), dd.reshape(n_pad, n_probe)


def build_ivf_table(
    x: np.ndarray,
    *,
    capacity: int = 512,
    # 1.5x slots: cluster load ~67% — capacity overflow (which evicts points
    # into unreachable clusters) becomes rare. Scan cost is ∝ n_probe x
    # capacity, NOT slot count, so slack only costs HBM (measured at 1M:
    # containment@10 0.894 (1.3) -> 0.984 (1.5, with distance-wave placement).
    slack: float = 1.5,
    overlap: int = 4,
    seed: int = 42,
    kmeans_iters: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train centroids and bucket rows into capacity-capped clusters.

    Returns (centroids [K, d] f32, members [K, capacity] int32, -1 padded).
    Every row is guaranteed at least one slot (host fix-up for overflow).
    Persisted by VamanaWriter as the serving shortlist structure.
    """
    from vecgo.index import build_fast as bf
    from vecgo.quantization import kmeans as km

    n, d = x.shape
    x = np.ascontiguousarray(x, np.float32)
    k = max(2, math.ceil(n * slack / capacity))
    rng = np.random.default_rng(seed)

    n_sample = min(n, max(32768, 12 * k))
    idx = rng.choice(n, n_sample, replace=False)
    centroids, _ = km.train_kmeans(
        x[idx], k, iters=kmeans_iters, seed=seed, sample=n_sample
    )

    # Device assignment: pad rows to a block multiple with +inf norms.
    block = 8192
    n_pad = ((n + block - 1) // block) * block
    import ml_dtypes

    xb = x.astype(ml_dtypes.bfloat16)
    if n_pad > n:
        xb = np.concatenate([xb, np.zeros((n_pad - n, d), ml_dtypes.bfloat16)])
    rn = np.full(n_pad, np.inf, np.float32)
    rn[:n] = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    # Clamp overlap to the trained cluster count: with small n / large
    # capacity, k can drop below 4 and lax.top_k(k=ov) over [N, k] would fail.
    ov = max(1, min(overlap, 4, k))
    a_dev, d_dev = _assign_topk_full(
        jnp.asarray(xb), jnp.asarray(rn), jnp.asarray(centroids), ov, block
    )
    # Route padded rows to a dump cluster, then capacity-capped membership.
    row_valid = jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0) < n
    a_dev = jnp.where(row_valid, a_dev, k)
    members, _, _, covered = bf._membership_dev(a_dev, d_dev, k + 1, capacity)
    members = np.array(members[:k])  # writable copy (host fix-up below)
    covered = np.asarray(covered[:n])
    if not covered.all():
        _fixup_coverage(members, covered, np.asarray(a_dev[:n]))
    return np.asarray(centroids, np.float32), members


def _fixup_coverage(members: np.ndarray, covered: np.ndarray, assign: np.ndarray):
    """Place every uncovered point in a slot, preferring its own clusters.

    Capacity pressure can drop even primary memberships (a k-means cluster
    with more primaries than `capacity`). Free slots come from (a) unused
    padding and (b) EVICTING redundant overlap memberships — entries whose
    point is covered elsewhere — so coverage is guaranteed whenever
    total slots >= n (ensured by `slack` > 1). Mutates `members` in place.
    """
    n = len(covered)
    rows_idx, cols_idx = np.nonzero(members >= 0)
    pts = members[rows_idx, cols_idx]
    # Evictable = all-but-one slot of every multiply-covered point.
    order = np.argsort(pts, kind="stable")
    pe = pts[order]
    first = np.concatenate([[True], pe[1:] != pe[:-1]]) if len(pe) else np.zeros(0, bool)
    ev_ok = np.ones(len(pts), bool)
    ev_ok[order[first]] = False
    ev_sel = np.nonzero(ev_ok)[0]
    sp_rows, sp_cols = np.nonzero(members == -1)
    # Spares first in pool order so eviction is the last resort per cluster.
    pool_rows = np.concatenate([sp_rows, rows_idx[ev_sel]])
    pool_cols = np.concatenate([sp_cols, cols_idx[ev_sel]])
    porder = np.argsort(pool_rows, kind="stable")
    pr = pool_rows[porder]
    k = members.shape[0]
    starts = np.searchsorted(pr, np.arange(k))
    ends = np.searchsorted(pr, np.arange(k) + 1)
    cursor = starts.copy()
    used = np.zeros(len(pool_rows), bool)
    leftovers = np.flatnonzero(~covered)
    spill = []
    for p in leftovers:
        placed = False
        for c in assign[p]:
            c = int(c)
            if c >= k:
                continue
            if cursor[c] < ends[c]:
                i = porder[cursor[c]]
                cursor[c] += 1
                members[pool_rows[i], pool_cols[i]] = p
                used[i] = True
                placed = True
                break
        if not placed:
            spill.append(p)
    if spill:
        free = np.nonzero(~used)[0]
        take = min(len(spill), len(free))
        members[pool_rows[free[:take]], pool_cols[free[:take]]] = np.asarray(
            spill[:take], members.dtype
        )
        if take < len(spill):
            logger = __import__("logging").getLogger("vecgo")
            logger.warning("ivf table: %d rows uncovered", len(spill) - take)


def device_table(
    members: np.ndarray,
    centroids: np.ndarray,
    vectors_dev: jax.Array,  # [N, d] any float dtype (bf16 traversal copy ok)
    rnorm2_dev: jax.Array,  # [N] f32
    group: int = 8,
) -> IVFDeviceTable:
    """Materialize the padded blocked layout on device.

    K is padded to a `group` multiple with empty clusters (+inf centroid norm
    so probing never selects them).
    """
    k, s = members.shape
    k_pad = ((k + group - 1) // group) * group
    m = np.full((k_pad, s), -1, np.int32)
    m[:k] = members
    mdev = jnp.asarray(m)
    safe = jnp.maximum(mdev, 0)
    c = np.zeros((k_pad, centroids.shape[1]), np.float32)
    c[:k] = centroids
    cdev = jnp.asarray(c)
    gathered = jnp.take(vectors_dev, safe.reshape(-1), axis=0).reshape(
        k_pad, s, vectors_dev.shape[1]
    ).astype(jnp.float32)
    res = jnp.where(
        (mdev >= 0)[:, :, None], gathered - cdev[:, None, :], 0.0
    )
    bnorm2 = jnp.where(mdev >= 0, jnp.sum(res * res, axis=-1), jnp.inf)
    cn = np.full(k_pad, np.inf, np.float32)
    cn[:k] = np.einsum("kd,kd->k", centroids, centroids, dtype=np.float64)
    return IVFDeviceTable(
        blocks=res.astype(jnp.bfloat16),
        bnorm2=bnorm2,
        rows=mdev,
        centroids=cdev,
        cnorm2=jnp.asarray(cn),
    )


@functools.partial(jax.jit, static_argnames=("group",))
def _coded_build(mdev, x16, *, group: int):
    """Encode the blocked SQ8-residual layout (scan over cluster groups keeps
    the f32 transient at O(group*S*d)). Centroids = member MEANS — the Lloyd
    update of whatever assignment produced `members`, so no second k-means is
    ever needed (VERDICT r2 #4: the round-2 serving table redid k-means +
    full assignment)."""
    k_pad, s = mdev.shape
    n, d = x16.shape
    ngroups = k_pad // group
    m_g = mdev.reshape(ngroups, group, s)

    def body(_, mg):
        valid = mg >= 0
        v = jnp.take(x16, jnp.maximum(mg, 0).reshape(-1), axis=0).reshape(
            group, s, d
        ).astype(jnp.float32)
        v = jnp.where(valid[:, :, None], v, 0.0)
        cnt = jnp.sum(valid, axis=1).astype(jnp.float32)  # [g]
        cent = jnp.sum(v, axis=1) / jnp.maximum(cnt, 1.0)[:, None]  # [g, d]
        res = jnp.where(valid[:, :, None], v - cent[:, None, :], 0.0)
        scale = jnp.maximum(
            jnp.max(jnp.abs(res), axis=(1, 2)) / 127.0, 1e-12
        )  # [g]
        codes = jnp.clip(
            jnp.round(res / scale[:, None, None]), -127, 127
        ).astype(jnp.int8)
        res_hat = codes.astype(jnp.float32) * scale[:, None, None]
        bn = jnp.where(valid, jnp.sum(res_hat * res_hat, axis=-1), jnp.inf)
        xhat = cent[:, None, :] + res_hat
        xn = jnp.where(valid, jnp.sum(xhat * xhat, axis=-1), jnp.inf)
        cn = jnp.where(cnt > 0, jnp.sum(cent * cent, axis=-1), jnp.inf)
        return None, (codes, scale, bn, xn, cent, cn)

    _, (codes, scale, bn, xn, cent, cn) = jax.lax.scan(body, None, m_g)
    codes = codes.reshape(k_pad, s, d)
    # slot_of_row: one slot per row (later writes win; overlap rows keep any).
    flat_rows = mdev.reshape(-1)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (k_pad * s,), 0)
    target = jnp.where(flat_rows >= 0, flat_rows, n)
    slot_of_row = (
        jnp.zeros((n + 1,), jnp.int32).at[target].set(slot_ids, mode="drop")[:n]
    )
    return IVFCodedTable(
        codes=codes,
        scale=scale.reshape(-1),
        bnorm2=bn.reshape(k_pad, s),
        xnorm2=xn.reshape(k_pad, s),
        rows=mdev,
        slot_of_row=slot_of_row,
        centroids=cent.reshape(k_pad, d),
        cnorm2=cn.reshape(-1),
    )


@functools.partial(jax.jit, static_argnames=("s", "block"))
def _refine_codes(xf, slot_of_row, cents, scale, *, s: int, block: int):
    """Per-row int16 residual codes vs the row's OWN (slot_of_row) cluster
    centroid — the refinement plane for pool rescoring. Blockwise lax.map
    bounds the f32 transient at [block, d]."""
    n, d = xf.shape
    n_pad = ((n + block - 1) // block) * block
    xp = jnp.pad(xf, ((0, n_pad - n), (0, 0)))
    sp = jnp.pad(slot_of_row, (0, n_pad - n))

    def body(args):
        xb, sb = args
        cl = sb // s
        c = jnp.take(cents, cl, axis=0)
        rs = jnp.take(scale, cl) * RSCALE_RATIO
        q = jnp.round((xb.astype(jnp.float32) - c) / rs[:, None])
        return jnp.clip(q, -32767, 32767).astype(jnp.int16)

    out = jax.lax.map(
        body,
        (xp.reshape(-1, block, d), sp.reshape(-1, block)),
    )
    return out.reshape(n_pad, d)[:n]


@functools.partial(jax.jit, static_argnames=("group",))
def _member_res_norms(mdev, x16, *, group: int):
    """Per-slot |x - cluster_mean|² (pass 1 of the compact repack)."""
    k_pad, s = mdev.shape
    n, d = x16.shape
    m_g = mdev.reshape(k_pad // group, group, s)

    def body(_, mg):
        valid = mg >= 0
        v = jnp.take(x16, jnp.maximum(mg, 0).reshape(-1), axis=0).reshape(
            group, s, d
        ).astype(jnp.float32)
        v = jnp.where(valid[:, :, None], v, 0.0)
        cnt = jnp.sum(valid, axis=1).astype(jnp.float32)
        cent = jnp.sum(v, axis=1) / jnp.maximum(cnt, 1.0)[:, None]
        res = v - cent[:, None, :]
        rn = jnp.where(valid, jnp.sum(res * res, axis=-1), jnp.inf)
        return None, rn

    _, rn = jax.lax.scan(body, None, m_g)
    return rn.reshape(k_pad, s)


def compact_members_primary(members, vectors_dev, group: int = 8):
    """Repack a (possibly overlapping) membership so every row keeps ONE slot —
    the one whose cluster mean is nearest. Memory halves for an overlap-2
    build membership; per-probe containment drops (no boundary secondaries),
    so serving needs ~2x the probes for equal recall — the memory/compute
    knob (serve_compact).

    Returns a compacted host members table [K, S'] (S' = max post-dedup
    cluster occupancy, padded to a lane multiple)."""
    k, s = members.shape
    k_pad = ((k + group - 1) // group) * group
    if k_pad > k:
        if isinstance(members, jax.Array):
            members = jnp.pad(
                members, ((0, k_pad - k), (0, 0)), constant_values=-1
            )
        else:
            m = np.full((k_pad, s), -1, np.int32)
            m[:k] = np.asarray(members)
            members = m
    mdev = members if isinstance(members, jax.Array) else jnp.asarray(members)
    n = vectors_dev.shape[0]
    rn = _member_res_norms(mdev, vectors_dev, group=group)

    flat_rows = mdev.reshape(-1)
    flat_rn = rn.reshape(-1)
    safe = jnp.where(flat_rows >= 0, flat_rows, n)
    # Keeper per row: nearest-mean slot, ties broken by smallest slot id.
    best = jnp.full((n + 1,), jnp.inf, jnp.float32).at[safe].min(flat_rn)
    is_best = (flat_rn <= jnp.take(best, safe)) & (flat_rows >= 0)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, flat_rows.shape, 0)
    big = jnp.int32(2**30)
    best_slot = (
        jnp.full((n + 1,), big, jnp.int32)
        .at[jnp.where(is_best, safe, n)].min(
            jnp.where(is_best, slot_ids, big), mode="drop"
        )
    )
    keep = slot_ids == jnp.take(best_slot, safe)
    kept = jnp.where(keep, flat_rows, -1).reshape(mdev.shape)
    # Push valid entries left within each cluster (row-wise 2-D sort: key
    # invalid-first=False => sort by (is_invalid, original order preserved
    # is unnecessary — membership order carries no meaning)).
    kept_sorted = jax.lax.sort(
        (jnp.where(kept >= 0, 0, 1).astype(jnp.int32), kept), num_keys=1
    )[1]
    occupancy = int(jnp.max(jnp.sum(kept >= 0, axis=1)))
    s2 = max(32, ((occupancy + 127) // 128) * 128)
    return np.asarray(kept_sorted[:, :s2])


def device_table_coded(
    members: np.ndarray,
    vectors_dev: jax.Array,  # [N, d] float (bf16 fine; encode reads f32)
    group: int = 8,
    compact: bool = False,
    refine=None,  # optional f32-grade [N, d] source for the int16 plane
) -> IVFCodedTable:
    """Materialize the SQ8-residual serving table from a membership table
    (typically the graph build's own partition — build_fast
    build_graph_clustered(return_membership=True)). compact=True first
    repacks to one slot per row (half the memory of an overlap-2 build
    membership; see compact_members_primary).

    refine: when given (device or host [N, d] array, f32 recommended — a
    bf16 source would bake bf16 value error into the int16 decode), the
    table carries the per-row int16 refinement plane (`rcodes`) and pool
    rescoring ranks at effectively-exact precision (+2 B/dim/row HBM)."""
    if compact:
        members = compact_members_primary(members, vectors_dev, group=group)
    k, s = members.shape
    k_pad = ((k + group - 1) // group) * group
    if k_pad > k:
        if isinstance(members, jax.Array):
            members = jnp.pad(
                members, ((0, k_pad - k), (0, 0)), constant_values=-1
            )
        else:
            m = np.full((k_pad, s), -1, np.int32)
            m[:k] = members
            members = m
    mdev = members if isinstance(members, jax.Array) else jnp.asarray(members)
    table = _coded_build(mdev, vectors_dev, group=group)
    if refine is not None:
        xf = refine if isinstance(refine, jax.Array) else jnp.asarray(
            refine, jnp.float32
        )
        n = xf.shape[0]
        rcodes = _refine_codes(
            xf, table.slot_of_row, table.centroids, table.scale,
            s=int(table.rows.shape[1]), block=min(131072, max(1024, n)),
        )
        table = table._replace(rcodes=rcodes)
    return table


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _invert_probes(probes, k_pad: int, qcap: int):
    """probes [B, P] int32 cluster ids -> (qtab [k_pad, qcap] query index or
    B as dump, qslot [k_pad, qcap] probe slot). One sort + run arithmetic —
    the same trick as build_fast._membership_dev, without distances (probe
    rank is the priority: earlier probes survive qcap pressure first)."""
    b, p = probes.shape
    m = b * p
    cl = probes.reshape(-1)
    qid = jax.lax.broadcasted_iota(jnp.int32, (b, p), 0).reshape(-1)
    sl = jax.lax.broadcasted_iota(jnp.int32, (b, p), 1).reshape(-1)
    cl_s, sl_s, qid_s = jax.lax.sort((cl, sl, qid), num_keys=2)
    pos_all = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)
    boundary = jnp.concatenate([jnp.ones((1,), bool), cl_s[1:] != cl_s[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, pos_all, 0)
    )
    pos = pos_all - run_start
    keep = pos < qcap
    row = jnp.where(keep, cl_s, k_pad)  # dump row for qcap overflow
    col = jnp.minimum(pos, qcap - 1)
    qtab = (
        jnp.full((k_pad + 1, qcap), b, jnp.int32)
        .at[row, col].set(qid_s, mode="drop")[:k_pad]
    )
    qslot = (
        jnp.zeros((k_pad + 1, qcap), jnp.int32)
        .at[row, col].set(sl_s, mode="drop")[:k_pad]
    )
    return qtab, qslot


def ivf_scan(q, table, *, n_probe, kk, qcap=0, group=8, mask_flat=None):
    """Guarded jitted entry (see _ivf_scan; containment in utils/devbug.py).

    Accepts either table layout: IVFDeviceTable (bf16 residuals) or
    IVFCodedTable (SQ8 residual codes — the serving-memory default)."""
    from vecgo.utils.devbug import dispatch_guarded

    b = q.shape[0]
    k_pad = table.bnorm2.shape[0]
    n_probe = min(n_probe, k_pad)
    if qcap == 0:
        # 3x the average probes-per-cluster: headroom for probe skew
        # (clustered query batches concentrate onto few clusters; drops cost
        # recall directly) — the grouped-scan matmul/top-k work scales
        # linearly in qcap, so headroom is the main throughput knob.
        qcap = max(32, ((3 * b * n_probe // max(k_pad, 1)) + 31) // 32 * 32)
    qcap = min(qcap, b)
    coded = isinstance(table, IVFCodedTable)
    if mask_flat is not None:
        fn = _ivf_scan_coded if coded else _ivf_scan
        return dispatch_guarded(
            functools.partial(
                fn, n_probe=n_probe, kk=kk, qcap=qcap, group=group
            ),
            q, table, mask_flat,
        )
    fn = _ivf_scan_coded_nomask if coded else _ivf_scan_nomask
    return dispatch_guarded(
        functools.partial(
            fn, n_probe=n_probe, kk=kk, qcap=qcap, group=group
        ),
        q, table,
    )


@functools.partial(
    jax.jit, static_argnames=("n_probe", "kk", "qcap", "group")
)
def _ivf_scan_nomask(q, table, *, n_probe, kk, qcap, group):
    return _ivf_scan_body(q, table, None, n_probe, kk, qcap, group)


@functools.partial(
    jax.jit, static_argnames=("n_probe", "kk", "qcap", "group")
)
def _ivf_scan(q, table, mask_flat, *, n_probe, kk, qcap, group):
    return _ivf_scan_body(q, table, mask_flat, n_probe, kk, qcap, group)


# Separate jit objects for the coded layout (per-variant jits: devbug.py).
@functools.partial(
    jax.jit, static_argnames=("n_probe", "kk", "qcap", "group")
)
def _ivf_scan_coded_nomask(q, table, *, n_probe, kk, qcap, group):
    return _ivf_scan_body(q, table, None, n_probe, kk, qcap, group)


@functools.partial(
    jax.jit, static_argnames=("n_probe", "kk", "qcap", "group")
)
def _ivf_scan_coded(q, table, mask_flat, *, n_probe, kk, qcap, group):
    return _ivf_scan_body(q, table, mask_flat, n_probe, kk, qcap, group)


def _ivf_scan_body(
    q,  # [B, d] float32 (normalized upstream for cosine)
    table: IVFDeviceTable,
    mask_flat,  # [K*S] bool or None (tombstones/filters in slot space)
    n_probe: int,
    kk: int,
    qcap: int,
    group: int,
):
    """Blocked IVF scan. Returns (dists [B, n_probe*kk] f32, rows
    [B, n_probe*kk] int32 segment rows, -1 invalid). Residual-exact
    distances (see IVFDeviceTable); callers rerank exact anyway."""
    qf = q.astype(jnp.float32)
    probes = _probe_clusters(qf, table, n_probe)
    return _scan_groups(
        qf, table, probes, mask_flat, kk=kk, qcap=qcap, group=group
    )


def _probe_clusters(qf, table, n_probe: int):
    """Stage 1: each query's `n_probe` nearest centroids [B, P] int32."""
    qn = jnp.sum(qf * qf, axis=-1)  # [B]
    cd = (
        qn[:, None]
        + table.cnorm2[None, :]
        - 2.0
        * jax.lax.dot_general(
            qf.astype(jnp.bfloat16), table.centroids.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )
    return jax.lax.top_k(-cd, n_probe)[1]


def _scan_groups(
    qf,  # [B, d] f32
    table,  # IVFDeviceTable | IVFCodedTable (cluster axis may be a CACHE)
    probes,  # [B, P] int32 cluster indices into table's cluster axis
    mask_flat,  # [K*S] bool or None
    *,
    kk: int,
    qcap: int,
    group: int,
):
    """Stages 2-4 of the blocked scan (inversion + grouped scan + scatter),
    with probe selection supplied by the caller — the cluster-cache serving
    tier probes FULL-table centroids but scans a small device-resident cache,
    so its probe space and scan space differ (see ClusterCachedTable).

    Coded tables on a GPU run the Pallas Triton kernel
    (ops/coded_scan_triton) when d is a power of two >= 16 (its block
    shapes); everything else runs the XLA scan. Both give the same results;
    the kernel measured about 10x faster at 1M x 128 (PERF.md)."""
    if _triton_scan_applies(table, qf.shape[1]):
        from vecgo.ops import coded_scan_triton

        return coded_scan_triton.scan_groups(
            qf, table, probes, mask_flat, kk=kk, qcap=qcap
        )
    return _scan_groups_xla(
        qf, table, probes, mask_flat, kk=kk, qcap=qcap, group=group
    )


def _triton_scan_applies(table, d: int) -> bool:
    return (
        isinstance(table, IVFCodedTable)
        and jax.default_backend() == "gpu"
        and d >= 16
        and d & (d - 1) == 0
    )


def _scan_groups_xla(qf, table, probes, mask_flat, *, kk: int, qcap: int,
                     group: int):
    """The XLA scan: a lax.scan over cluster groups, each step scoring a
    [group, qcap, S] distance tile and selecting top-kk with lax.top_k."""
    b, d = qf.shape
    k_pad, s = table.bnorm2.shape
    n_probe = probes.shape[1]

    # 2. invert to per-cluster query lists
    qtab, qslot = _invert_probes(probes, k_pad, qcap)

    # 3. grouped scan over clusters (residual scoring — see IVFDeviceTable /
    #    IVFCodedTable; the coded branch streams int8 and rescales the matmul)
    coded = isinstance(table, IVFCodedTable)
    ngroups = k_pad // group
    if coded:
        blocks_g = table.codes.reshape(ngroups, group, s, d)
        scale_g = table.scale.reshape(ngroups, group)
    else:
        blocks_g = table.blocks.reshape(ngroups, group, s, d)
        scale_g = None
    bn_g = table.bnorm2.reshape(ngroups, group, s)
    cent_g = table.centroids.reshape(ngroups, group, d)
    qtab_g = qtab.reshape(ngroups, group, qcap)
    qslot_g = qslot.reshape(ngroups, group, qcap)
    mask_g = (
        None
        if mask_flat is None
        else mask_flat.reshape(ngroups, group, s)
    )
    # Query rows padded with a sentinel row (dump): index B maps to a zero row.
    q_ext = jnp.concatenate([qf, jnp.zeros((1, d), jnp.float32)])

    out_d0 = jnp.full((b + 1, n_probe, kk), jnp.inf, jnp.float32)
    out_r0 = jnp.full((b + 1, n_probe, kk), -1, jnp.int32)

    def body(carry, inputs):
        out_d, out_r = carry
        inputs = list(inputs)
        mblk = inputs.pop() if mask_g is not None else None
        sc = inputs.pop() if coded else None
        gi, xblk, bn, cent, qt, qs = inputs
        qv = jnp.take(q_ext, qt.reshape(-1), axis=0).reshape(group, qcap, d)
        qr = qv - cent[:, None, :]  # f32 residual per (cluster, query)
        qrn = jnp.sum(qr * qr, axis=-1)  # [g, qcap]
        prod = jnp.einsum(
            "gqd,gsd->gqs", qr.astype(jnp.bfloat16),
            xblk.astype(jnp.bfloat16) if coded else xblk,
            preferred_element_type=jnp.float32,
        )
        if coded:
            prod = prod * sc[:, None, None]
        dd = qrn[:, :, None] + bn[:, None, :] - 2.0 * prod  # [g, qcap, S]
        if mblk is not None:
            dd = jnp.where(mblk[:, None, :], dd, jnp.inf)
        ld, lc = jax.lax.top_k(-dd, kk)  # [g, qcap, kk]
        ld = -ld
        # flat slot index -> (cluster*S + col)
        base = (gi * group + jax.lax.broadcasted_iota(
            jnp.int32, (group, 1, 1), 0
        )) * s
        lrow = base + lc
        lrow = jnp.where(jnp.isfinite(ld), lrow, -1)
        out_d = out_d.at[qt, qs].set(ld, mode="drop")
        out_r = out_r.at[qt, qs].set(lrow, mode="drop")
        return (out_d, out_r), None

    xs = [jnp.arange(ngroups, dtype=jnp.int32), blocks_g, bn_g, cent_g,
          qtab_g, qslot_g]
    if coded:
        xs.append(scale_g)
    if mask_g is not None:
        xs.append(mask_g)
    (out_d, out_r), _ = jax.lax.scan(body, (out_d0, out_r0), tuple(xs))
    out_d = out_d[:b].reshape(b, n_probe * kk)
    out_r = out_r[:b].reshape(b, n_probe * kk)
    # Map flat slot ids -> segment rows (dedup happens downstream; overlap
    # memberships can surface the same segment row from two clusters).
    seg_rows = jnp.where(
        out_r >= 0, jnp.take(table.rows.reshape(-1), jnp.maximum(out_r, 0)), -1
    )
    out_d = jnp.where(seg_rows >= 0, out_d, jnp.inf)
    return out_d, seg_rows


def slot_mask_from_rows(table: IVFDeviceTable, row_mask) -> jax.Array:
    """Lift a [N] row mask into the [K*S] slot space (padding -> False)."""
    rows = table.rows.reshape(-1)
    ok = jnp.take(row_mask, jnp.maximum(rows, 0)) & (rows >= 0)
    return ok.reshape(table.rows.shape)


__all__ = [
    "IVFDeviceTable",
    "IVFCodedTable",
    "build_ivf_table",
    "device_table",
    "device_table_coded",
    "ivf_scan",
    "slot_mask_from_rows",
]

"""Search planner: adaptive filtered fan-out over memtable + segments.

Reference: internal/engine/search.go (strategy selection :286-311, segment
fan-out :740-909, rerank :913-965, materialization :982-1082, LSN visibility
:1092-1105), segment_pruning.go (manifest-stats pruning), cursor_search.go.

Device-first restructuring:
- Filters compile to exact dense masks per segment (selectivity is exact, not
  estimated) — the 30% cutoff decides graph-vs-brute for *vamana* segments only
  (flat segments are always a masked scan: that IS their search).
- Per-segment device calls dispatch asynchronously (JAX async dispatch replaces
  the goroutine-per-segment fan-out).
- Rerank = exact matmul over gathered candidates.
- Cross-source merge happens ON DEVICE: per-source (dist, coded-location)
  pairs sort in one lax.sort and only the [2, B, fetch_k+margin] winner tile
  crosses back to the host (the round-1 design shipped the full per-source
  candidate width; the D2H payload and the [B, W] host argsort were the
  planner tax).
- Query batches larger than one chunk PIPELINE: the plan (masks, strategy) is
  computed once per snapshot, every chunk's device work dispatches without a
  sync, and ALL chunks drain in a single stacked D2H (JAX async dispatch
  overlaps chunk i+1's upload/compute with chunk i's transfers — the device
  analogue of the reference's goroutine-per-query BatchSearch,
  engine.go:1303-1366).
- Visibility check compares the candidate row's insert LSN against the PK
  chain — immune to flush/compaction remaps.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

logger = logging.getLogger("vecgo")

from vecgo.index.flat import FlatSegment, bloom_may_contain
from vecgo.metadata import Op, as_filterset
from vecgo.model import Candidate, Metric, QueryStats, SearchOptions, SearchResult

# Coded device merge limits: row < 2^25 per segment, <= 64 sources
# (slot<<25 | row fits int32 exactly at slot 63).
_ROW_BITS = 25
_ROW_LIMIT = 1 << _ROW_BITS
_MAX_SLOTS = 64
# Extra merged candidates beyond fetch_k: headroom for entries dropped by the
# MVCC visibility check / dirty-id dedup on churned ids. Kept tight: the
# packed [2, B, fetch_k+margin] result transfer is the engine's throughput
# bound on slow links. Under churn the
# margin scales with the dirty-id count (each dirty id can surface one stale
# physical row per source in the merge window); past _VIS_MARGIN_CAP the
# planner falls back to the full-width merge instead of growing the transfer.
_VIS_MARGIN = 6
_VIS_MARGIN_CAP = 64

# Pipelined search chunk (queries per device program). Every chunk sweeps the
# full corpus once, so larger chunks amortize HBM traffic and per-program
# dispatch over more queries (at the cost of peak intermediate memory).
# Not yet measured on the GPU.
CHUNK_B = int(os.environ.get("VECGO_CHUNK_B", "4096"))


def can_prune_segment(stats: dict, fs) -> bool:
    """O(1) manifest-stats pruning (reference: segment_pruning.go:15,
    manifest CanPruneNumeric:234 / CanPruneCategorical:449)."""
    if fs is None or not stats:
        return False
    fields = stats.get("fields", {})
    for flt in fs:
        st = fields.get(flt.field)
        if st is None:
            # Field absent from the whole segment: EQ/IN/GT... match nothing.
            if flt.op != Op.NEQ:
                return True
            continue
        if st["kind"] == "num" and isinstance(flt.value, (int, float)):
            lo, hi = st["min"], st["max"]
            v = float(flt.value)
            if flt.op == Op.EQ and (v < lo or v > hi):
                return True
            if flt.op == Op.GT and hi <= v:
                return True
            if flt.op == Op.GTE and hi < v:
                return True
            if flt.op == Op.LT and lo >= v:
                return True
            if flt.op == Op.LTE and lo > v:
                return True
        elif st["kind"] == "str":
            if flt.op == Op.EQ and st.get("bloom"):
                if not bloom_may_contain(st["bloom"], str(flt.value)):
                    return True
            if flt.op == Op.IN and st.get("bloom"):
                if not any(bloom_may_contain(st["bloom"], str(v)) for v in flt.value):
                    return True
        elif st["kind"] == "bool":
            if flt.op == Op.EQ:
                if bool(flt.value) and st.get("true", 1) == 0:
                    return True
                if not bool(flt.value) and st.get("false", 1) == 0:
                    return True
        elif st["kind"] == "arr":
            if flt.op == Op.CONTAINS and st.get("bloom"):
                if not bloom_may_contain(st["bloom"], str(flt.value)):
                    return True
            if flt.op == Op.IN and st.get("bloom"):
                if not any(bloom_may_contain(st["bloom"], str(v)) for v in flt.value):
                    return True
    return False


@dataclass
class _Source:
    seg_id: int  # -1 = memtable
    source: Any  # MemTable or segment object
    kind: str  # mem | flat | flat_stream | graph | graph_stream | brute_masked
    mask: Optional[np.ndarray]
    rows_considered: int
    n: int  # row count of the source
    # Low-selectivity compact gather (flat segments): eligible rows gathered
    # ONCE per plan into a dense device sub-corpus — the scan then costs
    # O(selectivity * N) instead of a full masked sweep. (x16, rnorm2, rows
    # map, all device-resident; built lazily by _dispatch_chunk and retained
    # by the plan cache.)
    compact: Optional[dict] = None


@dataclass
class _Plan:
    sources: List[_Source] = field(default_factory=list)
    n_brute: int = 0
    n_graph: int = 0
    n_pruned: int = 0
    segments_total: int = 0
    rows_considered: int = 0
    rows_filtered_out: int = 0
    total_rows: int = 0
    filtered: bool = False


class PlanCache:
    """Engine-level LRU of (snapshot, filter) -> _Plan.

    A _Plan is chunk- AND batch-invariant: masks and strategy depend only on
    (lsn, version, segment set, filter, planner dials). Rebuilding it per
    search_arrays call was the sync path's dominant host tax at 1M rows —
    exact filter masks are O(N) columnar evaluations per call (VERDICT r4 #2;
    the reference keeps per-query planning near zero the same way, pooled
    scratch + precomputed bitmaps, engine/search.go:740-909). Entries age out
    by LRU; keys embed (lsn, version) so any write produces a new key and
    stale plans are never served.
    """

    def __init__(self, cap: int = 16):
        self._d: "OrderedDict[tuple, _Plan]" = OrderedDict()
        self._cap = cap
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            plan = self._d.get(key)
            if plan is not None:
                self._d.move_to_end(key)
            return plan

    def put(self, key, plan):
        with self._lock:
            self._d[key] = plan
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    @staticmethod
    def _gathered_bytes(plan) -> int:
        total = 0
        for src in plan.sources:
            c = getattr(src, "compact", None)
            if c:
                total += sum(int(getattr(v, "nbytes", 0)) for v in c.values())
        return total

    def sweep_gathered(self, budget_bytes: int):
        """Evict LRU plans until cached compact-gather sub-corpora fit the
        HBM budget. Gathers attach lazily at first dispatch, so this runs
        AFTER dispatch, not at put() (a 50%-selectivity filter at 1M x 128
        holds a ~128 MB bf16 sub-corpus per plan)."""
        if budget_bytes <= 0:
            return
        with self._lock:
            total = sum(self._gathered_bytes(p) for p in self._d.values())
            while total > budget_bytes and len(self._d) > 1:
                _, old = self._d.popitem(last=False)
                total -= self._gathered_bytes(old)

    def clear(self):
        with self._lock:
            self._d.clear()


def _plan_filter_key(filter) -> Optional[tuple]:
    """Hashable fingerprint of a filter expression; None = uncacheable."""
    if filter is None:
        return ("*",)
    fs = as_filterset(filter)
    if fs is None:
        return ("*",)
    try:
        return tuple((f.field, str(f.op), repr(f.value)) for f in fs)
    except Exception:  # noqa: BLE001 — exotic filter values: just don't cache
        return None


def _plan_still_resident(plan: "_Plan", device_budget) -> bool:
    """Re-touch HBM admissions for a cached plan (admit() is O(1)); a flipped
    residency decision invalidates the plan (segment was evicted since)."""
    if device_budget is None:
        return True
    for src in plan.sources:
        if src.seg_id < 0:
            continue
        seg = src.source
        if src.kind in ("flat", "flat_compact", "graph", "brute_masked"):
            if not device_budget.admit(
                ("seg", seg.seg_id), seg.device_bytes(), seg.release_device
            ):
                return False
        elif src.kind == "graph_cached":
            if not device_budget.admit(
                ("segcache", seg.seg_id), seg.cache_bytes(), seg.release_cache
            ):
                return False
    return True


def _plan_snapshot(snap, opts, options, device_budget) -> _Plan:
    """Per-snapshot strategy selection + mask construction (chunk-invariant)."""
    plan = _Plan()
    fs = as_filterset(opts.filter)
    plan.filtered = fs is not None

    mem = snap.memtable
    n_vis = snap.mem_rows
    plan.total_rows = n_vis + sum(h.segment.n for h in snap.segments)
    if n_vis:
        mask = None
        if fs is not None:
            mask = mem.filter_mask(fs, n_vis)
        dead = mem.deleted_mask(n_vis, snap.lsn)
        if dead is not None:
            mask = ~dead if mask is None else (mask & ~dead)
        if mask is None or mask.any():
            rows_c = n_vis if mask is None else int(mask.sum())
            plan.sources.append(_Source(-1, mem, "mem", mask, rows_c, n_vis))
            plan.rows_considered += rows_c

    for h in snap.segments:
        seg = h.segment
        if seg.n == 0:
            continue
        plan.segments_total += 1
        if can_prune_segment(h.info.stats, fs):
            plan.n_pruned += 1
            continue
        mask = None
        selectivity = 1.0
        if fs is not None:
            mask = seg.filter_mask(fs)
            selectivity = float(mask.mean())
            if selectivity == 0.0:
                plan.n_pruned += 1
                continue
        dead = snap.tombstones.deleted_mask(seg.seg_id, seg.n, snap.lsn)
        if dead is not None:
            mask = ~dead if mask is None else (mask & ~dead)
            if not mask.any():
                plan.n_pruned += 1
                continue
        # HBM residency: over-budget segments stream host blocks through the
        # device with a running top-k (reference: lazy block reads,
        # diskann/segment.go:1151; two-tier cache engine.go:425-477).
        resident = True
        if device_budget is not None:
            resident = device_budget.admit(
                ("seg", seg.seg_id), seg.device_bytes(), seg.release_device
            )
        rows_c = seg.n if mask is None else int(mask.sum())
        if mask is not None:
            plan.rows_filtered_out += seg.n - rows_c
        plan.rows_considered += rows_c
        if isinstance(seg, FlatSegment):
            kind = "flat" if resident else "flat_stream"
            if (
                resident
                and mask is not None
                and seg.quant.kind == "none"
                and 0
                < rows_c
                <= int(
                    getattr(options, "compact_gather_cutoff", 0.05) * seg.n
                )
            ):
                # Low-selectivity compact gather: eligible rows gather ONCE
                # (per cached plan) into a dense device sub-corpus; the scan
                # then costs O(sel * N) instead of a full masked sweep — this
                # is why the reference's filtered QPS RISES as selectivity
                # falls (search.go:286-311); ours now does too.
                kind = "flat_compact"
            plan.n_brute += 1
        elif not resident:
            # Beyond-HBM graph segment: prefer the cluster-cached coded
            # two-stage path (bounded HBM, probe-churn H2D — the reference's
            # lazy block cache, diskann/segment.go:1151) over the full
            # streaming scan; stream only if even the cache can't fit.
            if (
                getattr(seg, "ivf_members", None) is not None
                and device_budget.admit(
                    ("segcache", seg.seg_id),
                    seg.cache_bytes(),
                    seg.release_cache,
                )
            ):
                kind = "graph_cached"
                plan.n_graph += 1
            else:
                kind = "graph_stream"
                plan.n_brute += 1
        else:
            cutoff = (
                opts.selectivity_cutoff
                if opts.prefilter is None
                else (1.1 if opts.prefilter else -0.1)
            )
            if fs is not None and selectivity <= cutoff:
                # Brute-force the eligible rows (cheap as a matmul at low
                # selectivity; the graph only wins on very large segments —
                # cutoff is configurable).
                kind = "brute_masked"
                plan.n_brute += 1
            else:
                kind = "graph"
                plan.n_graph += 1
        plan.sources.append(
            _Source(seg.seg_id, seg, kind, mask, rows_c, seg.n)
        )
    return plan


def _dispatch_chunk(plan: _Plan, qd, opts, options, exact_k: int = 0):
    """Score + rerank one query chunk against every planned source.

    Pure device dispatch — no host sync. Returns (reranked, counters) where
    reranked = [(seg_id, d_dev [B,w], rows_dev [B,w])] and counters feed stats.
    """
    import jax.numpy as jnp

    from vecgo.ops import topk as T

    b = qd.shape[0]
    k = opts.k
    fetch_k = max(k * max(opts.refine_factor, 1), k)
    # Exact-distance sources (memtable brute force, unquantized flat) return
    # FINAL distances — their per-source top-k union already contains the
    # global top-k, so the refine_factor pool buys nothing and the scan's
    # per-block selection cost grows with pool width. exact_k = k plus
    # the churn margin (every dirty id can displace one merge-window row).
    exact_k = max(exact_k or fetch_k, k)
    metric = options.metric
    reranked = []
    dist_comps = 0
    nodes_visited = 0

    for src in plan.sources:
        kk = min(fetch_k, src.n)
        stream_rerank = False  # SQ8-streamed results need the exact host rerank
        if src.kind == "mem":
            kk = min(exact_k, src.n)
            d, rows = src.source.search(qd, kk, src.n, src.mask)
            dist_comps += b * src.rows_considered
        elif src.kind == "flat":
            if src.source.quant.kind == "none":
                kk = min(exact_k, src.n)
            d, rows = src.source.search(
                qd, kk, mask=src.mask, nprobes=opts.nprobes,
                scan_dtype=getattr(options, "flat_scan_dtype", "bf16"),
            )
            dist_comps += b * src.rows_considered
        elif src.kind == "flat_compact":
            seg = src.source
            kk = min(exact_k, src.rows_considered)
            scan_dtype = getattr(options, "flat_scan_dtype", "bf16")
            if src.compact is None:
                dev = seg.device_state()
                rows_elig = jnp.asarray(
                    np.flatnonzero(src.mask).astype(np.int32)
                )
                src.compact = {
                    "rows": rows_elig,
                    "x16": jnp.take(dev["vectors"], rows_elig, axis=0).astype(
                        jnp.bfloat16
                    ),
                    "rn": jnp.take(dev["rnorm2"], rows_elig),
                }
            cc = src.compact
            if scan_dtype == "f32" and "x32" not in cc:
                # f32 sub-corpus only for the exact profile (it doubles the
                # gather's HBM; the bf16 profile reranks from the FULL f32
                # table by global row id and never reads it).
                dev = seg.device_state()
                cc["x32"] = jnp.take(dev["vectors"], cc["rows"], axis=0)
            n_sub = int(cc["x16"].shape[0])
            if scan_dtype == "f32":
                # Exact sub-corpus scan: honors the engine's full-precision
                # profile (tight near-tie data overwhelms a bf16 pool margin).
                d, lrows = T.blockwise_topk_search(
                    qd, cc["x32"], kk, metric=metric, x_norms_sq=cc["rn"],
                    block_rows=min(131072, n_sub), exact=True,
                    x_normalized=True,
                )
                rows = jnp.where(
                    lrows >= 0,
                    jnp.take(cc["rows"], jnp.maximum(lrows, 0)),
                    -1,
                )
            else:
                # Pool margin 24 (vs the resident path's 8): the sub-corpus
                # scan is O(sel*N) so the wider approx pool is nearly free,
                # and it absorbs both bf16 ranking noise and approx_min_k's
                # dense selection losses before the exact rerank.
                _, lrows = T.blockwise_topk_search(
                    qd, cc["x16"], min(kk + 24, n_sub), metric=metric,
                    x_norms_sq=cc["rn"], block_rows=min(131072, n_sub),
                    compute_dtype=jnp.bfloat16, x_normalized=True,
                )
                rows = jnp.where(
                    lrows >= 0,
                    jnp.take(cc["rows"], jnp.maximum(lrows, 0)),
                    -1,
                )
                d = seg.rerank(qd, rows)  # exact f32-HIGHEST on device
                d, rows = T.topk_smallest_with_ids(d, rows, kk)
            dist_comps += b * src.rows_considered
        elif src.kind == "flat_stream":
            seg = src.source
            if seg.quant.kind == "none" and not (
                seg.ivf_centroids is not None and opts.nprobes > 0
            ):
                # Unquantized beyond-HBM flat segment: stream coded rows
                # (SQ8 = 1 byte/dim H2D, 4x less than f32; PQ = d/2 bytes/row,
                # ~1.9x less again but coarser, so pool 4x) + exact host
                # rerank below — same economics as the graph_stream path.
                transport = options.stream_transport
                enc_host, sfn = seg.stream_state(transport)
                # PQ transport orders coarsely: pool >= 128 before the exact
                # rerank (m=d/2 pool 128 -> recall 1.0 at 1M).
                kks = min(src.n, max(4 * kk, 128)) if transport == "pq" else kk
                d, rows = T.streaming_topk_scored(
                    qd, enc_host, seg.n, kks, sfn, mask=src.mask,
                )
                stream_rerank = True
            else:
                d, rows = seg.search_streaming(
                    qd, kk, mask=src.mask, nprobes=opts.nprobes
                )
            dist_comps += b * src.rows_considered
        elif src.kind == "graph_cached":
            # Beyond-HBM two-stage: fixed-size cluster cache in HBM, probe
            # misses upload on demand; exact host rerank below.
            seg = src.source
            kk2 = kk
            if str((seg.meta.get("ivf") or {}).get("codes_stored")) in (
                "pq", "opq",
            ):
                # PQ transport: coded ordering is coarse — hand the exact
                # rerank a wider pool (per-source result widths may differ).
                kk2 = min(src.n, 4 * kk)
            ef = max(opts.ef or options.ef_search, kk2)
            d, rows = seg.search_cached(qd, kk2, mask=src.mask, ef=ef)
            stream_rerank = True
            dist_comps += b * kk2
        elif src.kind == "graph_stream":
            # Beyond-HBM graph segment: streaming scan over host-resident
            # coded rows (SQ8 = 1 byte/dim H2D instead of 4; PQ = d/2
            # bytes/row, pooled 4x — quantization IS the beyond-memory story,
            # as in the reference); winners get an exact host rerank below.
            seg = src.source
            transport = options.stream_transport
            enc_host, sfn = seg.stream_state(transport)
            # see flat_stream: PQ transport pools >= 128 for the exact rerank
            kks = min(src.n, max(4 * kk, 128)) if transport == "pq" else kk
            d, rows = T.streaming_topk_scored(
                qd, enc_host, seg.n, kks, sfn, mask=src.mask,
            )
            dist_comps += b * src.rows_considered
        elif src.kind == "brute_masked":
            seg = src.source
            if getattr(seg, "ivf_members", None) is not None:
                # Coded graph segment: brute force scores the SQ8 slot space
                # (no full-precision device residency exists).
                d, rows = seg.masked_scan(qd, kk, src.mask)
            else:
                dev = seg.device_state()
                d, rows = T.blockwise_topk_search(
                    qd,
                    dev["full"],
                    kk,
                    metric=metric,
                    x_norms_sq=dev["rnorm2"],
                    mask=jnp.asarray(src.mask),
                    x_normalized=True,
                )
            dist_comps += b * src.rows_considered
        else:  # graph
            seg = src.source
            ef = max(opts.ef or options.ef_search, kk)
            if src.mask is not None and 0 < src.rows_considered < src.n:
                # Selectivity-adaptive ef (reference: dynamic EF expansion
                # ef/selectivity capped 20,000, hnsw.go:1858-1895): a mask
                # rides the graph only above the brute cutoff (~30%), but a
                # 35%-selectivity filter still drops ~2/3 of traversal
                # candidates — widen the working set so post-filter survivors
                # keep k winners. Cap: batched lockstep cost ~linear in ef.
                sel = src.rows_considered / src.n
                ef = min(
                    int(ef / max(sel, 1e-3)),
                    max(ef, getattr(options, "ef_filtered_cap", 2048)),
                )
            bw = opts.beam_width or options.beam_width
            gkw = {}
            if opts.graph_refine >= 0:
                gkw["refine_steps"] = opts.graph_refine
            if opts.graph_rescore is not None:
                gkw["rescore"] = opts.graph_rescore
            if opts.nprobes:
                gkw["n_probe"] = opts.nprobes
            if opts.graph_qcap_factor > 0:
                gkw["qcap_factor"] = opts.graph_qcap_factor
            d, rows = seg.search(
                qd, kk, mask=src.mask, ef=ef, beam_width=bw, **gkw
            )
            # Lockstep traversal: static per-query step budget x beam width
            # nodes expanded, each scoring R neighbors (two-stage IVF path
            # adds its probe matmul, counted as n_probe block scans).
            import math as _math

            steps = ef // max(bw, 1) + 8 + int(
                _math.ceil(_math.log2(max(seg.n, 2)))
            )
            nodes_visited += b * steps * bw
            dist_comps += b * steps * bw * seg.r

        # ---- exact rerank (graph results are bf16; quantized approximate) ----
        if src.seg_id >= 0:
            seg = src.source
            if src.kind in ("flat_stream", "graph_stream", "graph_cached"):
                if (
                    stream_rerank
                    or (not isinstance(seg, FlatSegment))
                    or seg.quant.kind != "none"
                ):
                    d = seg.rerank_host(qd, rows)
            else:
                if (not isinstance(seg, FlatSegment)) or seg.quant.kind != "none":
                    d = seg.rerank(qd, rows)
        reranked.append((src.seg_id, d, rows))
        dist_comps += b * (rows.shape[1] if hasattr(rows, "shape") else 0)
    return reranked, dist_comps, nodes_visited


@functools.lru_cache(maxsize=64)
def _merge_jit(widths: tuple, out_w: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _merge(*parts):
        half = len(parts) // 2
        ds, rs = parts[:half], parts[half:]
        coded = []
        for slot, r in enumerate(rs):
            coded.append(
                jnp.where(
                    r >= 0,
                    jnp.int32(slot << _ROW_BITS) | r.astype(jnp.int32),
                    jnp.int32(-1),
                )
            )
        d_all = jnp.concatenate([d.astype(jnp.float32) for d in ds], axis=1)
        c_all = jnp.concatenate(coded, axis=1)
        d_all = jnp.where(c_all >= 0, d_all, jnp.inf)
        sd, sc = jax.lax.sort((d_all, c_all), num_keys=1)
        sd, sc = sd[:, :out_w], sc[:, :out_w]
        return jnp.stack(
            [jax.lax.bitcast_convert_type(sd, jnp.int32), sc]
        )

    return _merge


def _merge_device(reranked, fetch_k: int, margin: int = _VIS_MARGIN):
    """Sort every source's candidates on device; return packed [2, B, W]
    (f32-bits-as-i32 distances, coded slot<<25|row locations)."""
    widths = tuple(int(r[2].shape[1]) for r in reranked)
    out_w = min(sum(widths), fetch_k + margin)
    fn = _merge_jit(widths, out_w)
    parts = [d for _, d, _ in reranked] + [rows for _, _, rows in reranked]
    return fn(*parts), out_w


def _loc_lists(sel_seg, sel_row, got):
    """Per-query [(seg_id, row), ...] lists from compacted arrays. Python
    tuple materialization is O(B*k) interpreter work — the arrays stay
    vectorized until a caller actually needs locations (search_batch does;
    the search_arrays hot path does not)."""
    b, kk = sel_seg.shape
    return [
        [
            (int(sel_seg[bi, j]), int(sel_row[bi, j]))
            for j in range(kk)
            if got[bi, j]
        ]
        for bi in range(b)
    ]


def _finish_chunk(
    packed_host: np.ndarray,  # [2, B, W]
    slot_seg_ids: List[int],
    snap,
    pk,
    opts,
):
    """Decode + MVCC visibility + compact to k (host, vectorized)."""
    k = opts.k
    D = packed_host[0].view(np.float32)
    C = packed_host[1]
    b, w = D.shape
    valid = np.isfinite(D) & (C >= 0)
    S_slot = np.where(valid, C >> _ROW_BITS, 0)
    R = np.where(valid, C & (_ROW_LIMIT - 1), -1)

    seg_ids_arr = np.asarray(slot_seg_ids, np.int32)
    S = seg_ids_arr[S_slot]  # [B, W] actual seg ids (-1 memtable)

    # Gather candidate ids/lsns per source slot.
    IDS = np.full((b, w), -1, np.int64)
    LSNS = np.full((b, w), -1, np.int64)
    mem_ids = (
        np.asarray(snap.memtable.ids[: snap.mem_rows], np.int64)
        if snap.mem_rows
        else None
    )
    mem_lsns = (
        np.asarray(snap.memtable.lsns[: snap.mem_rows], np.int64)
        if snap.mem_rows
        else None
    )
    segmap = {h.seg_id: h.segment for h in snap.segments}
    for slot, seg_id in enumerate(seg_ids_arr):
        m = valid & (S_slot == slot)
        if not m.any():
            continue
        if seg_id == -1:
            ids_src, lsns_src = mem_ids, mem_lsns
        else:
            seg = segmap[int(seg_id)]
            ids_src = seg.ids.astype(np.int64, copy=False)
            lsns_src = seg.lsns
        rr = R[m]
        IDS[m] = ids_src[rr]
        LSNS[m] = lsns_src[rr]

    # MVCC visibility fast path: ids with a single chain version are trivially
    # visible; only multi-version ("dirty") ids need a chain lookup.
    dirty = pk.dirty_sorted()
    if len(dirty):
        from vecgo.engine.pk import DELETED

        flagged = valid & np.isin(IDS, dirty, assume_unique=False)
        for bi, j in zip(*np.nonzero(flagged)):
            ent = pk.get_entry(int(IDS[bi, j]), snap.lsn)
            if ent is None or ent[1] == DELETED or ent[0] != int(LSNS[bi, j]):
                valid[bi, j] = False
        # Dedup within a row can only involve dirty ids (single-version ids
        # exist in exactly one physical location).
        for bi in set(np.nonzero(flagged.any(axis=1))[0]):
            seen = set()
            for j in range(valid.shape[1]):
                if not valid[bi, j]:
                    continue
                cid = int(IDS[bi, j])
                if cid in seen:
                    valid[bi, j] = False
                else:
                    seen.add(cid)

    # Stable-compact the first k valid entries per row.
    sel = np.argsort(~valid, axis=1, kind="stable")[:, :k]
    kk = sel.shape[1]
    got = np.take_along_axis(valid, sel, axis=1)
    out_ids = np.full((b, k), -1, np.int64)
    out_d = np.full((b, k), np.inf, np.float32)
    out_ids[:, :kk] = np.where(got, np.take_along_axis(IDS, sel, axis=1), -1)
    out_d[:, :kk] = np.where(
        got, np.take_along_axis(D, sel, axis=1), np.inf
    )
    sel_seg = np.take_along_axis(S, sel, axis=1)
    sel_row = np.take_along_axis(R, sel, axis=1)
    return out_ids, out_d, (sel_seg, sel_row, got)


def _coded_mergeable(plan: _Plan) -> bool:
    return len(plan.sources) <= _MAX_SLOTS and all(
        s.n < _ROW_LIMIT for s in plan.sources
    )


def search_snapshot(
    snap,
    pk,
    q,  # [B, d] float32 (np or device array)
    opts: SearchOptions,
    options,  # EngineOptions
    device_budget=None,  # resource.DeviceBudget or None (unlimited HBM)
    need_locations: bool = True,  # False skips per-query (seg,row) tuple lists
    plan_cache: Optional[PlanCache] = None,
):
    """Execute a (batched) search against a snapshot.

    Query batches larger than CHUNK_B are pipelined: per-chunk device programs
    dispatch back-to-back and drain through ONE stacked D2H transfer.

    Returns (ids [B, k] int64 (-1 pad), dists [B, k] f32, locations list of
    per-query [(seg_id, row), ...], stats).

    Dispatch-bug containment (jax-0.9.0 executable-reuse, utils/devbug.py):
    ONE clear-caches + re-upload retry on the documented INVALID_ARGUMENT
    signature. The former in-path backend-teardown ladder was retired
    (VERDICT r4 #9): heavy containment now lives at process boundaries —
    builds quarantine the runtime when they finish (Engine's post-build
    quarantine after an in-process vamana compaction).
    """
    from vecgo.utils.devbug import _errors

    try:
        return _search_snapshot_impl(
            snap, pk, q, opts, options, device_budget, need_locations,
            plan_cache,
        )
    except _errors() as e:
        if "INVALID_ARGUMENT" not in str(e):
            raise
        import jax

        logger.warning(
            "search dispatch hit the executable-reuse bug (%s); clearing jit "
            "caches + re-uploading device state, one retry", e
        )
        jax.clear_caches()
        # Device arrays uploaded while the runtime was poisoned can be bad
        # handles — release segment/memtable device state so it re-uploads
        # (and drop cached plans, which may hold compact-gather device state).
        if plan_cache is not None:
            plan_cache.clear()
        for h in snap.segments:
            rel = getattr(h.segment, "release_device", None)
            if rel is not None:
                rel()
        mt_rel = getattr(snap.memtable, "release_device", None)
        if mt_rel is not None:
            mt_rel()
        return _search_snapshot_impl(
            snap, pk, np.asarray(q), opts, options, device_budget,
            need_locations, plan_cache,
        )


@dataclass
class _PendingBatch:
    """A dispatched-but-not-drained query batch.

    Device work (and, for single-chunk coded batches, the D2H copy) is already
    in flight when this object exists; `_drain_batch` blocks only on the
    transfer. Streaming callers keep several of these alive so batch i+1's
    upload/compute overlaps batch i's drain."""

    plan: Any
    chunks: list
    coded: bool
    slot_seg_ids: list
    b: int
    n_chunks: int
    dist_comps: int
    nodes_visited: int
    stats: Any
    t0: float
    t_plan: float
    t_score: float
    q: Any  # original query batch, retained for dispatch-bug replays


def _dispatch_batch(
    snap, pk, q, opts: SearchOptions, options, device_budget=None,
    plan_cache: Optional[PlanCache] = None,
) -> _PendingBatch:
    import jax
    import jax.numpy as jnp

    from vecgo.ops.distance import normalize

    t0 = time.perf_counter()
    stats = QueryStats() if opts.with_stats else None
    k = opts.k

    qd = q if isinstance(q, jax.Array) else jnp.asarray(q, jnp.float32)
    qd = qd.astype(jnp.float32)
    if options.metric == Metric.COSINE:
        qd = normalize(qd)
    b = qd.shape[0]

    plan = None
    cache_key = None
    if plan_cache is not None:
        fkey = _plan_filter_key(opts.filter)
        if fkey is not None:
            cache_key = (
                snap.lsn, snap.version, snap.mem_rows,
                tuple(h.seg_id for h in snap.segments),
                fkey, opts.selectivity_cutoff, opts.prefilter,
            )
            plan = plan_cache.get(cache_key)
            if plan is not None and not _plan_still_resident(
                plan, device_budget
            ):
                plan = None
    if plan is None:
        plan = _plan_snapshot(snap, opts, options, device_budget)
        if cache_key is not None:
            plan_cache.put(cache_key, plan)
    t_plan = time.perf_counter()

    if not plan.sources:
        return _PendingBatch(
            plan, [], True, [], b, 0, 0, 0, stats, t0, t_plan, t_plan, q
        )

    # Churn-aware merge width: every dirty (multi-version) id can surface one
    # stale row per source inside the merge window, silently displacing valid
    # neighbors if the margin is fixed. Scale the margin with the dirty count;
    # past the cap, take the full-width merge path instead.
    dirty_n = len(pk.dirty_sorted())
    # A clean snapshot (no multi-version ids) cannot lose candidates to
    # visibility filtering or dedup — merge exactly k and skip the margin
    # bytes on the packed D2H (the bound on slow host links).
    vis_margin = (
        0 if dirty_n == 0 else max(_VIS_MARGIN, min(dirty_n, _VIS_MARGIN_CAP))
    )
    coded = _coded_mergeable(plan) and dirty_n <= _VIS_MARGIN_CAP
    slot_seg_ids = [s.seg_id for s in plan.sources]

    # ---- dispatch all chunks (device, async) ----
    chunks = []
    dist_comps = nodes_visited = 0
    n_chunks = (b + CHUNK_B - 1) // CHUNK_B if b > CHUNK_B else 1
    for ci in range(n_chunks):
        qc = qd[ci * CHUNK_B : (ci + 1) * CHUNK_B] if n_chunks > 1 else qd
        reranked, dc, nv = _dispatch_chunk(
            plan, qc, opts, options, exact_k=k + vis_margin
        )
        dist_comps += dc
        nodes_visited += nv
        if coded:
            # Merge width k (+ churn margin), NOT fetch_k: every approximate
            # source is exactly reranked inside _dispatch_chunk before the
            # merge, so truncating the globally sorted union at k is lossless
            # — fetch_k only sizes the per-source rerank pools. This shrinks
            # the packed D2H (the engine's bound on slow links) ~2x.
            packed, _ = _merge_device(reranked, k, vis_margin)
            chunks.append(packed)
        else:
            chunks.append(reranked)
    if coded and len(chunks) == 1:
        # Start the D2H now: a streaming caller dispatches the NEXT batch
        # before draining this one, so the transfer rides under that batch's
        # compute. (Multi-chunk batches stack on device at drain time.)
        try:
            chunks[0].copy_to_host_async()
        except Exception:  # noqa: BLE001 — an eager-copy miss is perf-only
            pass
    if plan_cache is not None:
        # Compact-gather sub-corpora attach to plans at first dispatch —
        # enforce the HBM budget now (LRU-evict over-budget plans).
        plan_cache.sweep_gathered(
            getattr(options, "plan_gather_budget_bytes", 2 << 30)
        )
    t_score = time.perf_counter()
    return _PendingBatch(
        plan,
        chunks,
        coded,
        slot_seg_ids,
        b,
        n_chunks,
        dist_comps,
        nodes_visited,
        stats,
        t0,
        t_plan,
        t_score,
        q,
    )


def _drain_batch(pending: _PendingBatch, snap, pk, opts, need_locations=True):
    import jax.numpy as jnp

    k = opts.k
    plan = pending.plan
    b = pending.b
    stats = pending.stats
    t0, t_plan, t_score = pending.t0, pending.t_plan, pending.t_score

    if not plan.sources:
        empty_ids = np.full((b, k), -1, np.int64)
        empty_d = np.full((b, k), np.inf, np.float32)
        if stats:
            stats.strategy = "empty"
            stats.total_time_s = time.perf_counter() - t0
        return empty_ids, empty_d, [[] for _ in range(b)], stats

    chunks = pending.chunks
    coded = pending.coded
    slot_seg_ids = pending.slot_seg_ids
    n_chunks = pending.n_chunks
    dist_comps = pending.dist_comps
    nodes_visited = pending.nodes_visited

    out_ids = np.empty((b, k), np.int64)
    out_d = np.empty((b, k), np.float32)
    out_loc: List[List] = []
    if coded:
        if len(chunks) == 1:
            packed_all = [np.asarray(chunks[0])]
        else:
            # All full chunks share a shape; only the tail can be smaller.
            # Transfer the uniform prefix as ONE stacked D2H.
            shape0 = chunks[0].shape
            uniform = [c for c in chunks if c.shape == shape0]
            stacked = np.asarray(jnp.stack(uniform)) if len(uniform) > 1 else None
            packed_all = []
            ui = 0
            for c in chunks:
                if c.shape == shape0 and stacked is not None:
                    packed_all.append(stacked[ui])
                    ui += 1
                else:
                    packed_all.append(np.asarray(c))
        t_rerank = time.perf_counter()
        for ci, ph in enumerate(packed_all):
            ids_c, d_c, loc_c = _finish_chunk(ph, slot_seg_ids, snap, pk, opts)
            s = ci * CHUNK_B if n_chunks > 1 else 0
            out_ids[s : s + ids_c.shape[0]] = ids_c
            out_d[s : s + ids_c.shape[0]] = d_c
            if need_locations:
                out_loc.extend(_loc_lists(*loc_c))
    else:
        # Fallback (many sources / huge segment): wide packed transfer.
        t_rerank = time.perf_counter()
        for ci, reranked in enumerate(chunks):
            ids_c, d_c, loc_c = _finish_wide(reranked, snap, pk, opts)
            s = ci * CHUNK_B if n_chunks > 1 else 0
            out_ids[s : s + ids_c.shape[0]] = ids_c
            out_d[s : s + ids_c.shape[0]] = d_c
            if need_locations:
                out_loc.extend(_loc_lists(*loc_c))

    t_end = time.perf_counter()
    if stats:
        stats.planning_time_s = t_plan - t0
        stats.scoring_time_s = t_score - t_plan
        stats.rerank_time_s = t_rerank - t_score
        stats.materialize_time_s = t_end - t_rerank
        stats.total_time_s = t_end - t0
        stats.segments_total = plan.segments_total
        stats.segments_pruned = plan.n_pruned
        stats.segments_brute_force = plan.n_brute
        stats.segments_graph = plan.n_graph
        stats.rows_considered = plan.rows_considered
        stats.rows_filtered_out = plan.rows_filtered_out
        stats.nodes_visited = nodes_visited
        stats.distance_computations = dist_comps
        if plan.filtered:
            stats.selectivity = plan.rows_considered / max(plan.total_rows, 1)
        stats.strategy = (
            f"brute={plan.n_brute} graph={plan.n_graph} pruned={plan.n_pruned}"
            + (" filtered" if plan.filtered else "")
        )
    return out_ids, out_d, out_loc, stats


def _search_snapshot_impl(
    snap,
    pk,
    q,
    opts: SearchOptions,
    options,
    device_budget=None,
    need_locations: bool = True,
    plan_cache: Optional[PlanCache] = None,
):
    pending = _dispatch_batch(
        snap, pk, q, opts, options, device_budget, plan_cache
    )
    return _drain_batch(pending, snap, pk, opts, need_locations)


def search_snapshot_stream(
    snap,
    pk,
    batches,
    opts: SearchOptions,
    options,
    device_budget=None,
    need_locations: bool = False,
    depth: int = 3,
    plan_cache: Optional[PlanCache] = None,
):
    """Sustained-throughput serving over ONE snapshot: keep up to `depth`
    query batches in flight, yielding (ids, dists, locs, stats) per batch in
    input order.

    A synchronous `search_snapshot` call costs one host↔device round trip per
    batch, which caps serving on slow links regardless of device speed.
    Here batch i+1's
    upload/compute dispatches BEFORE batch i's drain blocks, and single-chunk
    coded results start their D2H copy at dispatch (`copy_to_host_async`), so
    transfers ride under the next batch's compute. This is the device analogue of
    the reference's concurrent BatchSearch (engine.go:1303-1366, semaphore
    100) — concurrency in the device queue instead of goroutines.

    Dispatch-bug containment (utils/devbug.py): a failing batch replays
    through the retry-laddered synchronous path; already-inflight batches
    drain first so output order is preserved.
    """
    from collections import deque

    from vecgo.utils.devbug import _errors

    inflight: "deque[_PendingBatch]" = deque()

    def _finish(pend: _PendingBatch):
        try:
            return _drain_batch(pend, snap, pk, opts, need_locations)
        except _errors() as e:
            # Only the documented dispatch bug (INVALID_ARGUMENT buffer-count
            # mismatch, utils/devbug.py) warrants a full synchronous replay —
            # it is the one failure the sync path's retry ladder can contain.
            # Any other deterministic error would fail the replay too: paying
            # a second full execution (and a retry ladder that can release
            # device state the OTHER inflight batches' chunks depend on,
            # cascading every remaining batch into a sync replay) just buries
            # the original traceback. Match the sync ladder's gate.
            if "INVALID_ARGUMENT" not in str(e):
                raise
            logger.warning(
                "pipelined drain hit the dispatch bug (%s); replaying the "
                "batch through the synchronous retry path", e
            )
            return search_snapshot(
                snap, pk, pend.q, opts, options, device_budget,
                need_locations, plan_cache,
            )

    for q in batches:
        try:
            inflight.append(
                _dispatch_batch(
                    snap, pk, q, opts, options, device_budget, plan_cache
                )
            )
        except _errors() as e:
            if "INVALID_ARGUMENT" not in str(e):
                raise
            logger.warning(
                "pipelined dispatch hit the dispatch bug (%s); draining "
                "inflight batches and replaying synchronously", e
            )
            while inflight:
                yield _finish(inflight.popleft())
            yield search_snapshot(
                snap, pk, q, opts, options, device_budget, need_locations,
                plan_cache,
            )
            continue
        if len(inflight) >= depth:
            yield _finish(inflight.popleft())
    while inflight:
        yield _finish(inflight.popleft())


def _finish_wide(reranked, snap, pk, opts):
    """Legacy wide merge: full per-source candidate width crosses to the host
    in one packed transfer (used when the coded merge's row/slot limits do not
    hold: > 64 sources or a segment with >= 2^25 rows)."""
    import jax
    import jax.numpy as jnp

    k = opts.k
    packed = jnp.stack(
        [
            jax.lax.bitcast_convert_type(
                jnp.concatenate(
                    [d.astype(jnp.float32) for _, d, _ in reranked], axis=1
                ),
                jnp.int32,
            ),
            jnp.concatenate(
                [rows.astype(jnp.int32) for _, _, rows in reranked], axis=1
            ),
        ]
    )
    packed_host = np.asarray(packed)
    dist_host = packed_host[0].view(np.float32)
    rows_host = packed_host[1]
    b = dist_host.shape[0]
    all_d, all_rows, all_seg, all_ids, all_lsns = [], [], [], [], []
    mem_ids = (
        np.asarray(snap.memtable.ids[: snap.mem_rows], np.int64)
        if snap.mem_rows
        else None
    )
    mem_lsns = (
        np.asarray(snap.memtable.lsns[: snap.mem_rows], np.int64)
        if snap.mem_rows
        else None
    )
    segmap = {h.seg_id: h.segment for h in snap.segments}
    col = 0
    for seg_id, d, rows in reranked:
        w = rows.shape[1]
        dn = dist_host[:, col : col + w]
        rn = rows_host[:, col : col + w]
        col += w
        safe = np.maximum(rn, 0)
        if seg_id == -1:
            ids_src, lsns_src = mem_ids, mem_lsns
        else:
            seg = segmap[seg_id]
            ids_src = seg.ids.astype(np.int64, copy=False)
            lsns_src = seg.lsns
        all_d.append(np.where(rn >= 0, dn, np.inf))
        all_rows.append(rn)
        all_seg.append(np.full(rn.shape, seg_id, np.int32))
        all_ids.append(np.where(rn >= 0, ids_src[safe], -1))
        all_lsns.append(np.where(rn >= 0, lsns_src[safe], -1))

    D = np.concatenate(all_d, axis=1)
    order = np.argsort(D, axis=1, kind="stable")
    D = np.take_along_axis(D, order, axis=1)
    R = np.take_along_axis(np.concatenate(all_rows, axis=1), order, axis=1)
    S = np.take_along_axis(np.concatenate(all_seg, axis=1), order, axis=1)
    IDS = np.take_along_axis(np.concatenate(all_ids, axis=1), order, axis=1)
    LSNS = np.take_along_axis(np.concatenate(all_lsns, axis=1), order, axis=1)

    valid = np.isfinite(D) & (R >= 0)
    dirty = pk.dirty_sorted()
    if len(dirty):
        from vecgo.engine.pk import DELETED

        flagged = valid & np.isin(IDS, dirty, assume_unique=False)
        for bi, j in zip(*np.nonzero(flagged)):
            ent = pk.get_entry(int(IDS[bi, j]), snap.lsn)
            if ent is None or ent[1] == DELETED or ent[0] != int(LSNS[bi, j]):
                valid[bi, j] = False
        for bi in set(np.nonzero(flagged.any(axis=1))[0]):
            seen = set()
            for j in range(valid.shape[1]):
                if not valid[bi, j]:
                    continue
                cid = int(IDS[bi, j])
                if cid in seen:
                    valid[bi, j] = False
                else:
                    seen.add(cid)

    sel = np.argsort(~valid, axis=1, kind="stable")[:, :k]
    kk = sel.shape[1]
    got = np.take_along_axis(valid, sel, axis=1)
    out_ids = np.full((b, k), -1, np.int64)
    out_d = np.full((b, k), np.inf, np.float32)
    out_ids[:, :kk] = np.where(got, np.take_along_axis(IDS, sel, axis=1), -1)
    out_d[:, :kk] = np.where(got, np.take_along_axis(D, sel, axis=1), np.inf)
    sel_seg = np.take_along_axis(S, sel, axis=1)
    sel_row = np.take_along_axis(R, sel, axis=1)
    return out_ids, out_d, (sel_seg, sel_row, got)


def _seg_by_id(snap, seg_id: int):
    for h in snap.segments:
        if h.seg_id == seg_id:
            return h.segment
    raise KeyError(seg_id)

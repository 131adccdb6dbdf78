"""Benchmark: QPS per GPU at recall@10 >= 0.95 over a 1M x 128d corpus.

Measures the engine paths on the GPU and reports the best one as the headline
(all in extras):
  - flat exact scan: one bf16 matmul sweep + exact f32 rerank of a (k+8) pool
    (full-precision distances at near-bf16 speed),
  - engine-level serving through the full planner/MVCC stack (search_arrays),
  - Vamana/coded-IVF beam serving (the larger-than-device-memory path),
  - beyond-device streaming + cluster-cached tiers.

PROCESS-ISOLATED PHASES: each phase runs in its own subprocess over a shared
corpus/ground-truth cache (np.save), one after another, so exactly one
process holds the GPU at a time (a JAX process reserves most of the card's
memory when it first touches it) and a phase crash (even a segfault) cannot
destroy the other phases' results.

Refuses to run without a GPU (exit 1, no result line). Otherwise prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}, emitted
from a finally block with whatever phases succeeded; extras carry the device (platform, device_kind, count) and
the card's name and power limit from nvidia-smi. Also emits "curve":
[{path, qps, recall, ...config}] — the recall-vs-QPS frontier — plus
best_qps_at_{95,97,99} summary points and P50/P95/P99 latency. The full
payload goes to bench_out/BENCH_FULL.json (gitignored).

vs_baseline compares against the reference's best committed unfiltered search
throughput (10,759 QPS on its 10k x 128d fixture, benchmark_test/baseline.txt:33
— see BASELINE.md; the reference commits no 1M number, so this is the most
favorable-to-the-reference comparison available; our corpus is 100x larger).

Env knobs: BENCH_N (default 1_000_000), BENCH_D (128), BENCH_BATCH (4096),
BENCH_MODE (auto|flat|vamana), BENCH_BUDGET_S (1800), BENCH_CACHE (corpus
cache dir), BENCH_INPROC=1 (single-process debug mode).

JIT RULE: never close a jitted function over a corpus-sized array — captured
arrays are baked into the program as constants. Pass them as arguments.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

BASELINE_QPS = 10_759.0
K = 10
N_QUERIES = 1024

N = int(os.environ.get("BENCH_N", 1_000_000))
D = int(os.environ.get("BENCH_D", 128))
BATCH = int(os.environ.get("BENCH_BATCH", 4096))
MODE = os.environ.get("BENCH_MODE", "auto")
N_CLUSTERS = 1024


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _cache_dir():
    base = os.environ.get("BENCH_CACHE", "/tmp/vecgo_bench_cache")
    d = os.path.join(base, f"{N}x{D}")
    os.makedirs(d, exist_ok=True)
    return d


def _jax_setup():
    """Import jax with the persistent compile cache on; refuses to run on
    anything but a GPU (numbers from another backend are not GPU numbers)."""
    import jax

    from vecgo.utils.device import device_info
    from vecgo.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    device_info(expect_gpu=True)
    return jax


def _device_extras():
    """Which device the numbers come from."""
    from vecgo.utils.device import card_info, device_info

    d = device_info(expect_gpu=True)
    return {
        "platform": d["platform"], "device_kind": d["kind"],
        "device_count": d["count"], "card": card_info(),
    }


def _load(name, mmap=True):
    return np.load(os.path.join(_cache_dir(), name + ".npy"),
                   mmap_mode="r" if mmap else None)


def _recall_fn(gt_i):
    def recall(ids, nq=None, gt=gt_i):
        nq = nq or len(gt)
        hits = sum(
            len(set(map(int, ids[b])) & set(map(int, gt[b])))
            for b in range(nq)
        )
        return hits / (nq * K)

    return recall


@functools.lru_cache(maxsize=1)
def _rerank_coded_jit():
    """f32 rescore of the DECODED pool (mirrors VamanaSegment.rerank coded)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _rrq(q, rows, codes, scale, xnorm2, slot_of_row, cents):
        k_pad, s, d = codes.shape
        b, c = rows.shape
        safe = jnp.maximum(rows, 0)
        slot = jnp.take(slot_of_row, safe)
        cl = slot // s
        cv = jnp.take(
            codes.reshape(-1, d), slot.reshape(-1), axis=0
        ).reshape(b, c, d).astype(jnp.float32)
        sc = jnp.take(scale, cl)
        xhat = (
            jnp.take(cents, cl.reshape(-1), axis=0).reshape(b, c, d)
            + cv * sc[:, :, None]
        )
        qf = q.astype(jnp.float32)
        prod = jnp.einsum(
            "bcd,bd->bc", xhat, qf, precision=jax.lax.Precision.HIGHEST
        )
        dd = (
            jnp.sum(qf * qf, -1, keepdims=True)
            + jnp.take(xnorm2.reshape(-1), slot)
            - 2.0 * prod
        )
        return jnp.where(rows >= 0, jnp.maximum(dd, 0.0), jnp.inf)

    return _rrq


@functools.lru_cache(maxsize=1)
def _rerank_refined_jit():
    """Pool rescore against the int16 REFINEMENT plane (mirrors
    VamanaSegment.rerank refined): one direct row-indexed 2 B/dim gather,
    decode error ~scale/516 — recall recovers the pool bound
    (recall 0.999 vs the int8 plateau 0.977)."""
    import jax
    import jax.numpy as jnp

    from vecgo.ops.ivf import RSCALE_RATIO

    @functools.partial(jax.jit, static_argnames=("s",))
    def _rrq16(q, rows, rcodes, scale, slot_of_row, cents, *, s):
        b, c = rows.shape
        safe = jnp.maximum(rows, 0)
        cl = jnp.take(slot_of_row, safe) // s
        cv = jnp.take(rcodes, safe.reshape(-1), axis=0).reshape(
            b, c, -1
        ).astype(jnp.float32)
        rs = jnp.take(scale, cl) * RSCALE_RATIO
        xhat = (
            jnp.take(cents, cl.reshape(-1), axis=0).reshape(b, c, -1)
            + cv * rs[:, :, None]
        )
        qf = q.astype(jnp.float32)
        prod = jnp.einsum(
            "bcd,bd->bc", xhat, qf, precision=jax.lax.Precision.HIGHEST
        )
        dd = (
            jnp.sum(qf * qf, -1, keepdims=True)
            + jnp.sum(xhat * xhat, -1)
            - 2.0 * prod
        )
        return jnp.where(rows >= 0, jnp.maximum(dd, 0.0), jnp.inf)

    return _rrq16


@functools.lru_cache(maxsize=1)
def _rerank_jit():
    """Exact f32-HIGHEST rerank of a row pool. The corpus (xd) and its norms
    (rnorm2) are ARGUMENTS, not closure captures — see the JIT RULE above."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _rr(q, rows, xd, rnorm2):
        safe = jnp.maximum(rows, 0)
        v = jnp.take(xd, safe, axis=0)
        qf = q.astype(jnp.float32)
        prod = jnp.einsum(
            "bcd,bd->bc", v, qf, precision=jax.lax.Precision.HIGHEST
        )
        qn = jnp.sum(qf * qf, axis=-1, keepdims=True)
        dd = qn + jnp.take(rnorm2, safe) - 2.0 * prod
        return jnp.where(rows >= 0, jnp.maximum(dd, 0.0), jnp.inf)

    return _rr


def _timed(fn, reps=10):
    import jax

    jax.block_until_ready(fn())  # warm
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _percentiles(fn, reps=40):
    """Single-call latency distribution (ms): p50/p95/p99."""
    import jax

    jax.block_until_ready(fn())  # warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)
    return (
        round(float(np.percentile(ts, 50)), 2),
        round(float(np.percentile(ts, 95)), 2),
        round(float(np.percentile(ts, 99)), 2),
    )


# =========================================================================
# Phases. Each fills (results, curve, extras) and runs in its own process.
# =========================================================================


def phase_prep(results, curve, extras):
    """Generate corpus + queries + exact ground truth into the cache dir."""
    cd = _cache_dir()
    _jax_setup()
    extras.update(_device_extras())
    marker = os.path.join(cd, "ready.json")
    if os.path.exists(marker):
        log("prep: cache hit")
        extras["prep_cached"] = True
        return
    import jax.numpy as jnp

    from vecgo.model import Metric
    from vecgo.ops import topk as T

    rng = np.random.default_rng(42)
    log(f"generating {N}x{D} clustered corpus...")
    centers = rng.standard_normal((N_CLUSTERS, D)).astype(np.float32)
    assign = rng.integers(0, N_CLUSTERS, size=N)
    x = centers[assign] + 0.35 * rng.standard_normal((N, D)).astype(np.float32)
    q = centers[rng.integers(0, N_CLUSTERS, size=N_QUERIES)] + 0.35 * (
        rng.standard_normal((N_QUERIES, D)).astype(np.float32)
    )
    np.save(os.path.join(cd, "x.npy"), x)
    np.save(os.path.join(cd, "q.npy"), q)
    np.save(os.path.join(cd, "centers.npy"), centers)
    log("computing exact ground truth...")
    xd = jnp.asarray(x)
    rnorm2 = jnp.sum(xd.astype(jnp.float32) ** 2, axis=1)
    _, gt_i = T.blockwise_topk_search(
        jnp.asarray(q), xd, K, metric=Metric.L2, x_norms_sq=rnorm2,
        block_rows=131072, exact=True,
    )
    np.save(os.path.join(cd, "gt.npy"), np.asarray(gt_i))
    with open(marker, "w") as f:
        json.dump({"n": N, "d": D}, f)
    log("ground truth done")


def phase_ingest(results, curve, extras):
    """Deferred-style bulk ingest (reference: BatchInsertDeferred ~2M vec/s,
    doc.go:33-35). Host-only path in a FRESH process."""
    # mmap=False: np.asarray on a memmap is a no-op (memmap IS an ndarray),
    # so an mmap'd load would lazy-fault disk reads inside the timed loop.
    x = _load("x", mmap=False)
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions

    # Best of 3 trials (fresh engine each): host scheduling noise is the
    # same order as the work, so the best trial is the machine's capability
    # (Go's testing.B likewise reports the steady-state minimum).
    times = []
    for _ in range(3):
        eng = Engine.open(
            MemoryStore(), EngineOptions(dim=D, flush_threshold=2**62),
            create=True,
        )
        t0 = time.perf_counter()
        eng.insert_batch(x)
        times.append(time.perf_counter() - t0)
        eng.close()
    dt = min(times)
    extras["ingest_vps"] = round(N / dt, 1)
    extras["ingest_vps_median"] = round(N / sorted(times)[1], 1)
    extras["ingest_vs_go_deferred"] = round(N / dt / 2_064_326.0, 2)


def phase_flat(results, curve, extras):
    """Raw flat-scan operating points: bf16 / bf16+exact-rerank / f32."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo.model import Metric
    from vecgo.ops import topk as T

    x = _load("x")
    q_all = np.asarray(_load("q"))
    gt_i = np.asarray(_load("gt"))
    recall = _recall_fn(gt_i)
    xd = jnp.asarray(np.asarray(x))
    rnorm2 = jnp.sum(xd.astype(jnp.float32) ** 2, axis=1)
    xb16 = xd.astype(jnp.bfloat16)
    qd = jnp.asarray(q_all)
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])

    def flat16(queries):
        return T.blockwise_topk_search(
            queries, xb16, K, metric=Metric.L2, x_norms_sq=rnorm2,
            block_rows=min(131072, N), compute_dtype=jnp.bfloat16,
        )

    def flat32(queries):
        return T.blockwise_topk_search(
            queries, xd, K, metric=Metric.L2, x_norms_sq=rnorm2,
            block_rows=min(131072, N),
        )

    @jax.jit
    def _flat_rr_fused(queries, xb16, xd, rnorm2):
        # ONE device program: scan + exact rerank + final top-k (one
        # dispatch and one sync per batch instead of three).
        _, rows = T.blockwise_topk_search(
            queries, xb16, K + 8, metric=Metric.L2, x_norms_sq=rnorm2,
            block_rows=min(131072, N), compute_dtype=jnp.bfloat16,
        )
        dd = _rerank_jit()(queries, rows, xd, rnorm2)
        return T.topk_smallest_with_ids(dd, rows, K)

    def flat_rr(queries):
        return _flat_rr_fused(queries, xb16, xd, rnorm2)

    for name, fn in (
        ("flat_bf16", flat16), ("flat_rr", flat_rr), ("flat_f32", flat32),
    ):
        try:
            log(f"flat variant {name}...")
            _, ids = fn(qd)
            rec = recall(np.asarray(ids))
            dt = _timed(lambda: fn(qb)[1])
            results[name] = (BATCH / dt, rec)
            extras[f"{name}_qps"] = round(BATCH / dt, 1)
            extras[f"{name}_recall"] = round(rec, 4)
            extras[f"{name}_ms_per_batch"] = round(dt * 1e3, 1)
            curve.append({
                "path": name, "qps": round(BATCH / dt, 1),
                "recall": round(rec, 4),
            })
        except Exception as e:  # noqa: BLE001
            log(f"flat variant {name} failed: {e!r}")
            log(traceback.format_exc())
            extras[f"{name}_error"] = repr(e)

    try:
        q1 = qd[:1]
        p50, p95, p99 = _percentiles(lambda: flat_rr(q1)[1])
        extras["flat_rr_p50_ms"] = p50
        extras["flat_rr_p95_ms"] = p95
        extras["flat_rr_p99_ms"] = p99
    except Exception as e:  # noqa: BLE001
        log(f"flat latency failed: {e!r}")
        extras["flat_latency_error"] = repr(e)


def phase_engine(results, curve, extras):
    """Engine-level serving through the FULL planner/MVCC stack — the
    reference's kind of number (baseline.txt:33 goes through the engine)."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions

    x = np.asarray(_load("x"))
    q_all = np.asarray(_load("q"))
    gt_i = np.asarray(_load("gt"))
    qd = jnp.asarray(q_all)
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])

    eng = Engine.open(
        MemoryStore(), EngineOptions(dim=D, flush_threshold=2**62), create=True
    )
    ids_list = eng.insert_batch(x)
    ids_arr = np.asarray(ids_list, np.int64)
    log("engine commit (memtable -> flat segment)...")
    t0 = time.perf_counter()
    eng.commit()
    extras["commit_s"] = round(time.perf_counter() - t0, 1)

    def eng_run(queries):
        return eng.search_arrays(queries, k=K)[0]

    ids_e = np.asarray(eng_run(qd))
    hits = sum(
        len(set(map(int, ids_e[b])) & set(map(int, ids_arr[gt_i[b]])))
        for b in range(N_QUERIES)
    )
    rec_e = hits / (N_QUERIES * K)
    dt = _timed(lambda: eng_run(qb), reps=5)
    results["engine_flat"] = (BATCH / dt, rec_e)
    extras["engine_flat_qps"] = round(BATCH / dt, 1)
    extras["engine_flat_recall"] = round(rec_e, 4)
    extras["engine_flat_ms_per_batch"] = round(dt * 1e3, 1)
    curve.append({
        "path": "engine_flat", "qps": round(BATCH / dt, 1),
        "recall": round(rec_e, 4),
    })
    try:
        q1 = qd[:1]
        p50, p95, p99 = _percentiles(lambda: eng_run(q1), reps=30)
        extras["engine_p50_ms"] = p50
        extras["engine_p95_ms"] = p95
        extras["engine_p99_ms"] = p99
        extras["engine_underload_ms_per_query"] = round(dt * 1e3 / BATCH, 4)
    except Exception as e:  # noqa: BLE001
        log(f"engine latency failed: {e!r}")
        extras["engine_latency_error"] = repr(e)
    try:
        n_stream = 8
        stream_batches = [qb] * n_stream

        def stream_all():
            outs = None
            for outs in eng.search_arrays_stream(
                iter(stream_batches), k=K, depth=3
            ):
                pass
            return outs

        stream_all()  # warm
        t0 = time.perf_counter()
        stream_all()
        dt_s = time.perf_counter() - t0
        qps_s = n_stream * BATCH / dt_s
        extras["engine_stream_qps"] = round(qps_s, 1)
        # Under-load latency series (reference: P50/P95/P99 under
        # concurrency, baseline.txt:88): batch-completion intervals during a
        # saturated pipelined stream, normalized per query.
        t_prev = time.perf_counter()
        gaps = []
        for _ in eng.search_arrays_stream(iter([qb] * 16), k=K, depth=3):
            now = time.perf_counter()
            gaps.append((now - t_prev) * 1e3)
            t_prev = now
        gaps = np.sort(np.asarray(gaps[1:]))  # first carries warm skew
        extras["engine_underload_p50_us_per_q"] = round(
            float(gaps[len(gaps) // 2]) / BATCH * 1e3, 2
        )
        extras["engine_underload_p95_us_per_q"] = round(
            float(gaps[int(len(gaps) * 0.95)]) / BATCH * 1e3, 2
        )
        extras["engine_underload_p99_us_per_q"] = round(
            float(gaps[min(int(len(gaps) * 0.99), len(gaps) - 1)]) / BATCH
            * 1e3, 2,
        )
        # Stream results are bit-identical to the sync path (pinned by
        # test_search_arrays_stream_matches_sync), so rec_e applies.
        results["engine_flat_stream"] = (qps_s, rec_e)
        curve.append({
            "path": "engine_flat_stream", "qps": round(qps_s, 1),
            "recall": round(rec_e, 4),
        })
    except Exception as e:  # noqa: BLE001
        log(f"engine stream failed: {e!r}")
        extras["engine_stream_error"] = repr(e)
    eng.close()


def phase_engine_graph(results, curve, extras):
    """Engine-level GRAPH serving at full N (the reference's baseline is
    engine-level, baseline.txt:33). Topology: ingest -> commit (flat
    segment) -> compact to a Vamana segment IN THIS PROCESS (one process owns
    the GPU) -> reopen -> serve through the full planner/MVCC stack."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo.blobstore import LocalStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.index.vamana import VamanaSegment

    cd = _cache_dir()
    dbdir = os.path.join(cd, "enginedb")
    q_all = np.asarray(_load("q"))
    gt_i = np.asarray(_load("gt"))
    # Small-N smoke runs must still exercise the graph path.
    graph_thresh = min(32_768, max(1024, N // 4))
    opts = EngineOptions(
        dim=D, flush_threshold=2**62, graph_threshold=graph_thresh
    )

    marker = os.path.join(cd, "enginedb_ready.json")
    if not os.path.exists(marker):
        x = np.asarray(_load("x"))
        shutil.rmtree(dbdir, ignore_errors=True)
        eng = Engine.open(LocalStore(dbdir), opts, create=True)
        ids_arr = np.asarray(eng.insert_batch(x), np.int64)
        log("engine_graph: commit (memtable -> flat segment)...")
        t0 = time.perf_counter()
        eng.commit()
        extras["engine_graph_commit_s"] = round(time.perf_counter() - t0, 1)
        log("engine_graph: compacting to Vamana...")
        t0 = time.perf_counter()
        eng.compact([h.seg_id for h in eng._segments])
        extras["engine_graph_compact_s"] = round(time.perf_counter() - t0, 1)
        kind = type(eng._segments[-1].segment).__name__
        eng.close()
        del eng, x
        if kind != "VamanaSegment":
            raise RuntimeError(f"expected VamanaSegment, got {kind}")
        np.save(os.path.join(cd, "enginedb_ids.npy"), ids_arr)
        with open(marker, "w") as f:
            json.dump({"segment": kind}, f)
    else:
        log("engine_graph: built db cache hit")
        extras["engine_graph_cached"] = True
    ids_arr = np.asarray(_load("enginedb_ids", mmap=False))
    qd = jnp.asarray(q_all)
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])

    log("engine_graph: reopening for serving...")
    eng = Engine.open(LocalStore(dbdir), opts)
    assert isinstance(eng._segments[-1].segment, VamanaSegment)
    gt_ids = [set(map(int, ids_arr[gt_i[b]])) for b in range(N_QUERIES)]
    # Two operating points from the serving-profile dial (the reference's
    # RefineFactor/NProbes analogue): the measured-fast coded profile and the
    # exact-leaning default (f32 pool rescore + 1 refine round).
    for name, kw in (
        ("engine_graph", dict(ef=48, nprobes=4, graph_refine=0,
                              graph_rescore=False)),
        # Tight query-capacity cap: the raw-path sweep's dominant speed knob
        # (probe drops are rescued by the ef-pool rerank).
        ("engine_graph_qcap", dict(ef=48, nprobes=4, graph_refine=0,
                                   graph_rescore=False,
                                   graph_qcap_factor=1.25)),
        # int16-plane pool rescore, no beam step: the high-recall engine
        # profile (serve_refine tables rank the ef-pool at effectively-exact
        # precision before the k-cut).
        ("engine_graph_rescore", dict(ef=48, nprobes=8, graph_refine=0,
                                      graph_rescore=True)),
        ("engine_graph_refine", dict(ef=48, nprobes=4)),
    ):
        try:
            def eng_run(queries, kw=kw):
                return eng.search_arrays(queries, k=K, **kw)[0]

            ids_e = np.asarray(eng_run(qd))
            hits = sum(
                len(set(map(int, ids_e[b])) & gt_ids[b])
                for b in range(N_QUERIES)
            )
            rec_e = hits / (N_QUERIES * K)
            dt = _timed(lambda: eng_run(qb), reps=5)
            results[name] = (BATCH / dt, rec_e)
            extras[f"{name}_qps"] = round(BATCH / dt, 1)
            extras[f"{name}_recall"] = round(rec_e, 4)
            extras[f"{name}_ms_per_batch"] = round(dt * 1e3, 1)
            curve.append({
                "path": name, "qps": round(BATCH / dt, 1),
                "recall": round(rec_e, 4), **kw,
            })
        except Exception as e:  # noqa: BLE001
            log(f"engine_graph config {name} failed: {e!r}")
            log(traceback.format_exc())
            extras[f"{name}_error"] = repr(e)
    try:
        q1 = qd[:1]
        p50, p95, p99 = _percentiles(
            lambda: eng.search_arrays(
                q1, k=K, ef=48, nprobes=4, graph_refine=0,
                graph_rescore=False,
            )[0],
            reps=30,
        )
        extras["engine_graph_p50_ms"] = p50
        extras["engine_graph_p95_ms"] = p95
        extras["engine_graph_p99_ms"] = p99
    except Exception as e:  # noqa: BLE001
        log(f"engine_graph latency failed: {e!r}")
        extras["engine_graph_latency_error"] = repr(e)
    try:
        # Pipelined serving (the production mode): per-call transfers hide
        # under the next batch's compute; recall equals the sync fast profile.
        # Use whichever fast profile measured faster above.
        n_stream = 8
        fast_kw = dict(ef=48, nprobes=4, graph_refine=0, graph_rescore=False)
        fast_name = "engine_graph"
        if extras.get("engine_graph_qcap_qps", 0) > extras.get(
            "engine_graph_qps", 0
        ):
            fast_kw["graph_qcap_factor"] = 1.25
            fast_name = "engine_graph_qcap"

        def stream_all():
            for _ in eng.search_arrays_stream(
                iter([qb] * n_stream), k=K, depth=3, **fast_kw
            ):
                pass

        stream_all()  # warm
        t0 = time.perf_counter()
        stream_all()
        dt_s = time.perf_counter() - t0
        qps_s = n_stream * BATCH / dt_s
        rec_fast = extras.get(f"{fast_name}_recall")
        extras["engine_graph_stream_qps"] = round(qps_s, 1)
        if rec_fast is not None:
            results["engine_graph_stream"] = (qps_s, rec_fast)
            curve.append({
                "path": "engine_graph_stream", "qps": round(qps_s, 1),
                "recall": rec_fast, **fast_kw,
            })
    except Exception as e:  # noqa: BLE001
        log(f"engine_graph stream failed: {e!r}")
        extras["engine_graph_stream_error"] = repr(e)
    eng.close()


def phase_filtered(results, curve, extras):
    """FILTERED search at 1M x 128 on the chip — the reference's HEADLINE
    benchmark axis (benchmark_test/baseline.txt:33-37: 41.5k/22.1k/8.6k QPS
    at sel=1/10/50% with recall@10=1.000 on its 10k fixture; :5-8 adversarial
    50k at 9.5k/4.8k/1.8k; its adaptive planner exists for exactly this,
    search.go:286-311). Three category distributions (uniform / zipf /
    cluster-correlated) x three selectivities through the FULL engine stack:
    planner -> exact dense masks (cached per (snapshot, filter)) -> masked
    bf16 scan + exact f32 rerank -> MVCC visibility. Reports sync QPS,
    pipelined-stream QPS, and recall@10 against exact masked ground truth."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo import metadata as md
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.model import Metric
    from vecgo.ops import distance as Dist
    from vecgo.ops import topk as T

    x = np.asarray(_load("x"))
    q_all = np.asarray(_load("q"))
    centers = np.asarray(_load("centers"))
    qd = jnp.asarray(q_all)
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])
    xd = jnp.asarray(x)
    rnorm2 = jnp.sum(xd * xd, axis=1)

    # --- category distributions (reference fixture families) ---
    rng = np.random.default_rng(77)
    cats_u = rng.integers(0, 100, N).astype(np.int64)  # uniform
    cats_z = np.minimum(rng.zipf(1.5, N) - 1, 9999).astype(np.int64)  # zipf
    # cluster-correlated: the corpus' own nearest natural center
    log("filtered: computing cluster-correlated categories...")
    cd_dev = jnp.asarray(centers)
    cats_c = np.empty(N, np.int64)
    for s in range(0, N, 131072):
        ch = xd[s : s + 131072]
        cats_c[s : s + ch.shape[0]] = np.asarray(
            jnp.argmin(Dist.squared_l2(ch, cd_dev), axis=1)
        )

    log("filtered: ingesting 1M rows with metadata...")
    eng = Engine.open(
        MemoryStore(), EngineOptions(dim=D, flush_threshold=2**62), create=True
    )
    t0 = time.perf_counter()
    metas = [
        {"u": int(u), "z": int(z), "c": int(c)}
        for u, z, c in zip(cats_u, cats_z, cats_c)
    ]
    ids_list = eng.insert_batch(x, metadatas=metas)
    extras["filtered_ingest_s"] = round(time.perf_counter() - t0, 1)
    ids_arr = np.asarray(ids_list, np.int64)
    del metas
    log("filtered: commit (builds the columnar metadata index)...")
    t0 = time.perf_counter()
    eng.commit()
    extras["filtered_commit_s"] = round(time.perf_counter() - t0, 1)

    def pick_values(cats, target):
        """Greedy value subset whose realized selectivity ~ target: descend
        the frequency-sorted values, taking any that still fits under
        1.02 * target (so a zipf head value of 38% never lands in a 1%
        filter); fall back to the closest single value if nothing fits."""
        vals, counts = np.unique(cats, return_counts=True)
        order = np.argsort(-counts)
        want = target * len(cats)
        chosen, acc = [], 0
        for j in order:
            if acc + counts[j] <= want * 1.02:
                chosen.append(int(vals[j]))
                acc += int(counts[j])
            if acc >= want * 0.98:
                break
        if not chosen:
            j = int(np.argmin(np.abs(counts - want)))
            chosen = [int(vals[j])]
        return chosen

    t_phase = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 1800))
    points = []
    for dist_name, field, cats in (
        ("uniform", "u", cats_u),
        ("zipf", "z", cats_z),
        ("clustered", "c", cats_c),
    ):
        for target in (0.01, 0.10, 0.50):
            points.append((dist_name, field, cats, target))
    for dist_name, field, cats, target in points:
        if time.perf_counter() - t_phase > budget_s:
            log("filtered: budget reached")
            break
        values = pick_values(cats, target)
        mask = np.isin(cats, np.asarray(values, np.int64))
        sel = float(mask.mean())
        tag = f"{dist_name}@{int(target * 100)}pct"
        log(f"filtered[{tag}]: |values|={len(values)} sel={sel:.4f}")
        f = md.isin(field, values) if len(values) > 1 else md.eq(
            field, values[0]
        )
        try:
            # exact masked ground truth (device)
            _, gt_f = T.blockwise_topk_search(
                qd, xd, K, metric=Metric.L2, x_norms_sq=rnorm2,
                mask=jnp.asarray(mask), block_rows=131072, exact=True,
            )
            gt_f = np.asarray(gt_f)
            ids_e = np.asarray(eng.search_arrays(qd, k=K, filter=f)[0])
            hits = sum(
                len(
                    set(int(i) for i in ids_e[b] if i >= 0)
                    & set(int(ids_arr[j]) for j in gt_f[b] if j >= 0)
                )
                for b in range(N_QUERIES)
            )
            denom = sum(
                min(K, int((gt_f[b] >= 0).sum())) for b in range(N_QUERIES)
            )
            rec = hits / max(denom, 1)
            dt = _timed(lambda: eng.search_arrays(qb, k=K, filter=f)[0], reps=3)
            qps = BATCH / dt
            extras[f"filtered_{tag}_qps"] = round(qps, 1)
            extras[f"filtered_{tag}_recall"] = round(rec, 4)
            extras[f"filtered_{tag}_sel"] = round(sel, 4)
            curve.append({
                "path": f"filtered_{dist_name}", "qps": round(qps, 1),
                "recall": round(rec, 4), "sel": round(sel, 4),
            })
            results[f"filtered_{tag}"] = (qps, rec)
            # pipelined stream at the same point (production serving mode)
            def stream_all(f=f):
                for _ in eng.search_arrays_stream(
                    iter([qb] * 6), k=K, depth=3, filter=f
                ):
                    pass

            stream_all()  # warm
            t0 = time.perf_counter()
            stream_all()
            extras[f"filtered_{tag}_stream_qps"] = round(
                6 * BATCH / (time.perf_counter() - t0), 1
            )
        except Exception as e:  # noqa: BLE001
            log(f"filtered[{tag}] failed: {e!r}")
            log(traceback.format_exc())
            extras[f"filtered_{tag}_error"] = repr(e)
    # summary: worst filtered point vs the reference's committed numbers
    pairs = [
        (extras.get(f"filtered_uniform@{p}pct_qps"), p)
        for p in (1, 10, 50)
    ]
    ref = {1: 41529.0, 10: 22061.0, 50: 8596.0}
    for qps, p in pairs:
        if qps:
            extras[f"filtered_vs_ref@{p}pct"] = round(qps / ref[p], 2)
    eng.close()


def phase_hybrid(results, curve, extras):
    """Hybrid (BM25 + vector, RRF) serving throughput (reference: 216 us/query
    = 4,620 QPS hybrid on its fixture, baseline.txt:69). Corpus: 200k docs
    with zipf text + the bench vectors. Measures the batched engine path
    (hybrid_search_batch): exact host BM25 and the device-resident DeviceBM25
    (bf16 matmul sweep + exact-f32 rescore), plus lexical-only throughput."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions

    n_h = min(N, 200_000)
    x = np.asarray(_load("x"))[:n_h]
    q_all = np.asarray(_load("q"))
    rng = np.random.default_rng(99)
    vocab = [f"w{i}" for i in range(20_000)]
    log(f"hybrid: generating {n_h} docs...")
    word_ids = np.minimum(rng.zipf(1.3, (n_h, 12)) - 1, 19_999)
    texts = [" ".join(vocab[w] for w in row) for row in word_ids]
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(dim=D, flush_threshold=2**62, lexical=True),
        create=True,
    )
    log("hybrid: ingesting...")
    t0 = time.perf_counter()
    eng.insert_batch(x, texts=texts)
    extras["hybrid_ingest_s"] = round(time.perf_counter() - t0, 1)
    eng.commit()

    # queries: 3 hot-ish words + a vector near the corpus
    qw = np.minimum(rng.zipf(1.3, (BATCH, 3)) - 1, 19_999)
    qtexts = [" ".join(vocab[w] for w in row) for row in qw]
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])

    log("hybrid: exact host BM25 path...")
    try:
        # Pin the device snapshot OFF for this leg: lexical_device="auto"
        # would otherwise build it at this corpus size.
        eng.options.lexical_device = "off"
        eng.hybrid_search_batch(qb, qtexts, k=K)  # warm
        t0 = time.perf_counter()
        ids_exact, _ = eng.hybrid_search_batch(qb, qtexts, k=K)
        dt = time.perf_counter() - t0
        extras["hybrid_exact_qps"] = round(BATCH / dt, 1)
        extras["hybrid_exact_vs_ref"] = round(BATCH / dt / 4620.0, 2)
    except Exception as e:  # noqa: BLE001
        log(f"hybrid exact failed: {e!r}")
        log(traceback.format_exc())
        extras["hybrid_exact_error"] = repr(e)
        ids_exact = None

    log("hybrid: device BM25 path...")
    try:
        eng.options.lexical_device = "auto"
        # H=2048: the bf16 weight table is 200k x 2048 x 2 B = 819 MB, one
        # upload; the per-batch H2D is just the [B, 16] int32 term columns.
        dev = eng.enable_device_lexical(max_hot_terms=2048, min_df=8)
        extras["hybrid_dev_hbm_mb"] = round(dev.device_bytes() / 1e6, 1)
        eng.hybrid_search_batch(qb, qtexts, k=K)  # warm (compiles)
        t0 = time.perf_counter()
        ids_dev, _ = eng.hybrid_search_batch(qb, qtexts, k=K)
        dt = time.perf_counter() - t0
        extras["hybrid_device_qps"] = round(BATCH / dt, 1)
        extras["hybrid_device_vs_ref"] = round(BATCH / dt / 4620.0, 2)
        if ids_exact is not None:
            # agreement with the exact path (bf16 near-ties may differ)
            agree = np.mean(
                [
                    len(set(ids_dev[b]) & set(ids_exact[b]))
                    / max(1, (ids_exact[b] >= 0).sum())
                    for b in range(BATCH)
                ]
            )
            extras["hybrid_device_agreement"] = round(float(agree), 4)
        # lexical-only throughput (reference: 35 us/q lexical, baseline.txt:71)
        dev.search_batch(qtexts[:BATCH], K)  # warm
        t0 = time.perf_counter()
        dev.search_batch(qtexts[:BATCH], K)
        extras["lexical_device_qps"] = round(
            BATCH / (time.perf_counter() - t0), 1
        )
    except Exception as e:  # noqa: BLE001
        log(f"hybrid device failed: {e!r}")
        log(traceback.format_exc())
        extras["hybrid_device_error"] = repr(e)
    eng.close()


def phase_vamana(results, curve, extras):
    """Graph build + coded-IVF serving + beyond-HBM streaming/cached tiers.
    One subprocess for all four: the latter three share the coded table."""
    jax = _jax_setup()
    import jax.numpy as jnp

    from vecgo.index.build_fast import build_graph_clustered
    from vecgo.model import Metric
    from vecgo.ops import beam as beam_ops
    from vecgo.ops import ivf as ivf_ops
    from vecgo.ops import topk as T

    x = np.asarray(_load("x"))
    q_all = np.asarray(_load("q"))
    gt_i = np.asarray(_load("gt"))
    centers = np.asarray(_load("centers"))
    qd = jnp.asarray(q_all)
    qb = jnp.asarray(np.tile(q_all, (max(1, BATCH // N_QUERIES), 1))[:BATCH])
    t_phase = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 1800))

    r = int(os.environ.get("BENCH_R", 32))
    alpha = float(os.environ.get("BENCH_ALPHA", 1.5))
    n_vam = N if MODE == "vamana" else min(
        N, int(os.environ.get("BENCH_VAMANA_N", N))
    )
    xv = x[:n_vam]
    extras["vamana_n"] = n_vam
    log(f"building vamana graph (clustered, n={n_vam}, r={r}, alpha={alpha})...")
    # ONE corpus upload outside the timed region (recorded as build_h2d_s);
    # warm-timed builds mirror the reference's in-RAM build benchmark
    # (baseline.txt:90 excludes data loading).
    t0 = time.perf_counter()
    xv_dev = jax.block_until_ready(jnp.asarray(xv, jnp.bfloat16))
    extras["build_h2d_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    build_graph_clustered(
        xv_dev, r=r, alpha=alpha, refine_rounds=0, return_device=True,
        return_membership="device",
    )
    extras["build_cold_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    graph_dev, medoid, bcentroids, bentry, members = build_graph_clustered(
        xv_dev, r=r, alpha=alpha, refine_rounds=0, return_device=True,
        return_membership="device",
    )
    jax.block_until_ready((graph_dev, members))
    t_build = time.perf_counter() - t0
    extras["build_s"] = round(t_build, 1)
    extras["build_vps"] = round(n_vam / t_build, 1)
    # Reference build baseline: HNSW 25,368 vec/s (baseline.txt:90).
    extras["build_vs_go_hnsw"] = round(n_vam / t_build / 25368.0, 2)

    xvd = jnp.asarray(xv)
    rnv = jnp.sum(xvd * xvd, axis=1)
    if n_vam == N:
        gt_v = gt_i
    else:
        _, gt_v = T.blockwise_topk_search(
            qd, xvd, K, metric=Metric.L2, x_norms_sq=rnv,
            block_rows=min(131072, n_vam), exact=True,
        )
        gt_v = np.asarray(gt_v)
    recall_v = _recall_fn(gt_v)

    # ---- serving table: SQ8 residual codes (+ int16 refinement plane for
    # pool rescoring) + graph are the ONLY HBM data (derives from the
    # build's own membership; no second k-means). refine=xvd (f32): the
    # int16 plane must encode from the f32 source or bf16 value error caps
    # the rescore.
    t0 = time.perf_counter()
    table = ivf_ops.device_table_coded(members, xv_dev[:n_vam], refine=xvd)
    jax.block_until_ready(table.codes)
    _ = np.asarray(table.codes[:1, :1, :1])
    extras["ivf_table_cold_s"] = round(time.perf_counter() - t0, 1)
    del table
    t0 = time.perf_counter()
    table = ivf_ops.device_table_coded(members, xv_dev[:n_vam], refine=xvd)
    jax.block_until_ready(table.codes)
    _ = np.asarray(table.codes[:1, :1, :1])
    extras["ivf_table_s"] = round(time.perf_counter() - t0, 1)
    extras["build_total_s"] = round(t_build + time.perf_counter() - t0, 1)
    extras["build_total_vps"] = round(
        n_vam / (t_build + time.perf_counter() - t0), 1
    )
    kt, st, _d = table.codes.shape
    extras["serve_hbm_bytes_per_row"] = round(
        (kt * st * (D + 12) + n_vam * (4 + 4 * r + 2 * D) + kt * (4 * D + 8))
        / n_vam, 1,
    )
    extras["serve_hbm_bytes_per_row_norefine"] = round(
        (kt * st * (D + 12) + n_vam * (4 + 4 * r) + kt * (4 * D + 8))
        / n_vam, 1,
    )
    kt_clusters = int(table.bnorm2.shape[0])

    def vam_run(queries, ef, n_probe, refine, qf=0.0, kk=16, rescore=0):
        # qf: qcap as a multiple of the average probes/cluster for THIS batch
        # size (0 = ivf_scan's auto 3x). Tighter qcaps trade probe drops
        # (rescued by refinement + the ef-pool rerank) for linear scan-cost
        # savings — the round-2 ablation's dominant knob.
        # rescore=1: rank the ef-pool against the int16 refinement plane
        # before the k-cut — recall rises to the pool bound (~0.999 at wide
        # probes) for one [B, ef] 2 B/dim gather.
        qcap = 0
        if qf:
            b_ = queries.shape[0]
            qcap = max(
                32,
                (int(qf * b_ * n_probe / max(kt_clusters, 1)) + 31)
                // 32 * 32,
            )
        sd, srows = ivf_ops.ivf_scan(
            queries, table, n_probe=n_probe, kk=kk, qcap=qcap
        )
        cd, crows = beam_ops._dedup_topk(sd, srows, ef)
        pool = jnp.where(jnp.isfinite(cd), crows, -1)
        if not refine and not rescore:
            # No-rescore fast path (mirrors VamanaSegment.search): the scan's
            # bf16-residual distances already rank within SQ8 error.
            return cd[:, :K], pool[:, :K]
        if refine:
            qc = jnp.einsum(
                "bd,kd->bk", queries.astype(jnp.float32), table.centroids
            )
            _, pool = beam_ops.beam_search_coded(
                queries, table, graph_dev, pool, qc,
                ef=ef, k=ef, beam_width=4, max_steps=refine,
            )
        if rescore and table.rcodes is not None:
            rd = _rerank_refined_jit()(
                queries, pool, table.rcodes, table.scale,
                table.slot_of_row, table.centroids,
                s=int(table.rows.shape[1]),
            )
        else:
            rd = _rerank_coded_jit()(
                queries, pool, table.codes, table.scale, table.xnorm2,
                table.slot_of_row, table.centroids,
            )
        sd2, si2 = jax.lax.sort((rd, pool.astype(jnp.int32)), num_keys=1)
        return sd2[:, :K], si2[:, :K]

    # Phase 1: recall-screen configs cheapest-first; keep screening past the
    # first passers so the published curve spans the frontier. Phase 2: TIME
    # the passers (plus the best non-passer as a low-recall curve point).
    screened = []
    # (ef, n_probe, refine, qf, rescore): rescore=1 ranks the ef-pool on the
    # int16 refinement plane before the k-cut — the recall dial the int8
    # rescore could not turn (the pool holds ~0.999 but
    # the x-hat(int8) cut plateaus ~2 points lower).
    sweep = (
        (48, 4, 0, 1.25, 0), (48, 4, 0, 2.0, 0), (48, 4, 0, 0, 0),
        (48, 4, 0, 2.0, 1), (48, 8, 0, 1.5, 1), (48, 8, 0, 0, 1),
        (48, 16, 0, 0, 1), (96, 16, 0, 0, 1),
        (48, 6, 0, 1.5, 0), (48, 8, 0, 0, 0), (48, 4, 1, 1.5, 0),
        (48, 12, 0, 0, 0), (96, 16, 1, 0, 1), (96, 24, 1, 0, 1),
    )
    n_pass = 0
    for ef, n_probe, refine, qf, rs in sweep:
        if time.perf_counter() - t_phase > budget_s:
            log("budget reached; stopping vamana screens")
            break
        log(f"vamana config ef={ef} p={n_probe} r={refine} qf={qf} rs={rs}...")
        try:
            _, ids = vam_run(qd, ef, n_probe, refine, qf, rescore=rs)
            rec = recall_v(np.asarray(ids))
        except Exception as e:  # noqa: BLE001
            log(f"  screen failed: {e!r}")
            continue
        extras[f"vamana_recall@ef{ef}p{n_probe}r{refine}qf{qf}rs{rs}"] = (
            round(rec, 4)
        )
        screened.append((ef, n_probe, refine, qf, rs, rec))
        if rec >= 0.95:
            n_pass += 1
        # Stop only once the screen has BOTH enough cheap passers and a
        # high-recall point — the published curve must show what recall
        # costs on the graph path, not five copies of one operating point.
        if n_pass >= 5 and max(s[5] for s in screened) >= 0.99:
            break
    passers = [s for s in screened if s[5] >= 0.95]
    to_time = passers[:6]
    hi = max(passers, key=lambda s: s[5], default=None)
    if hi is not None and hi not in to_time:
        to_time.append(hi)
    below = [s for s in screened if s[5] < 0.95]
    if below:
        to_time.append(max(below, key=lambda s: s[5]))
    if not to_time and screened:
        to_time = [max(screened, key=lambda s: s[5])]
    best = None
    for ef, n_probe, refine, qf, rs, rec in to_time:
        if time.perf_counter() - t_phase > budget_s * 1.2:
            log("budget reached; stopping vamana timing")
            break
        try:
            dt = _timed(
                lambda: vam_run(qb, ef, n_probe, refine, qf, rescore=rs)[1],
                reps=5,
            )
        except Exception as e:  # noqa: BLE001
            log(f"  timing failed: {e!r}")
            continue
        qps = BATCH / dt
        log(
            f"  timed ef={ef} p={n_probe} r={refine} qf={qf} rs={rs}: "
            f"{qps:.0f} qps"
        )
        extras[f"vamana_qps@ef{ef}p{n_probe}r{refine}qf{qf}rs{rs}"] = (
            round(qps, 1)
        )
        curve.append({
            "path": "vamana", "qps": round(qps, 1), "recall": round(rec, 4),
            "ef": ef, "n_probe": n_probe, "refine": refine, "qf": qf,
            "rescore": rs,
        })
        if rec >= 0.95 and (best is None or qps > best[0]):
            best = (qps, ef, n_probe, refine, qf, rs, rec)
    if best is None and curve:
        vc = [c for c in curve if c["path"] == "vamana"]
        if vc:
            b = max(vc, key=lambda c: c["recall"])
            best = (b["qps"], b["ef"], b["n_probe"], b["refine"], b["qf"],
                    b.get("rescore", 0), b["recall"])
    if best is not None:
        qps, ef, n_probe, refine, qf, rs, rec = best
        extras["vamana_ef"] = ef
        extras["vamana_nprobe"] = n_probe
        extras["vamana_refine"] = refine
        extras["vamana_qcap_factor"] = qf
        extras["vamana_rescore"] = rs
        results["vamana"] = (qps, rec)
        extras["vamana_qps"] = round(qps, 1)
        extras["vamana_recall"] = round(rec, 4)
        try:
            q1 = qd[:1]
            p50, p95, p99 = _percentiles(
                lambda: vam_run(q1, ef, n_probe, refine, qf, rescore=rs)[1],
                reps=30,
            )
            extras["vamana_p50_ms"] = p50
            extras["vamana_p95_ms"] = p95
            extras["vamana_p99_ms"] = p99
        except Exception as e:  # noqa: BLE001
            log(f"vamana latency failed: {e!r}")
            extras["vamana_latency_error"] = repr(e)

    # ---------------- beyond-HBM streaming scan ----------------
    # Host-resident corpus, bounded device memory: row blocks stream through
    # a running top-k (reference: lazy block reads + RAM->NVMe tier); bound
    # by host-to-device bandwidth.
    try:
        from vecgo.index.common import sq8_stream_state
        from vecgo.ops import topk as TT

        enc_host, sfn = sq8_stream_state(x, Metric.L2)  # 1 byte/dim H2D
        qs_small = jnp.asarray(q_all[:256])

        def stream_once():
            return TT.streaming_topk_scored(qs_small, enc_host, N, K, sfn)[1]

        ids_s = np.asarray(stream_once())
        rec_s = sum(
            len(set(map(int, ids_s[b])) & set(map(int, gt_i[b])))
            for b in range(256)
        ) / (256 * K)
        t0 = time.perf_counter()
        jax.block_until_ready(stream_once())
        dt = time.perf_counter() - t0
        extras["stream_qps"] = round(256 / dt, 1)
        extras["stream_recall"] = round(rec_s, 4)
        extras["stream_pass_s"] = round(dt, 2)
        extras["stream_h2d_mb_per_pass"] = round(N * D / 1e6, 1)
    except Exception as e:  # noqa: BLE001
        log(f"streaming phase failed: {e!r}")
        extras["stream_error"] = repr(e)

    # PQ transport: d/2 B/row H2D (~1.9x less than SQ8) + 128-wide pool +
    # exact HOST-numpy rerank (zero H2D — the candidate tile never uploads;
    # the engine's stream_transport="pq" path). m/pool from the measured
    # selection screen (m=d/2 pool 128 -> recall 1.0 at 1M; m=d/4 would
    # need a 512-pool for 0.991).
    try:
        from vecgo.index.common import pq_stream_state

        log("pq-transport streaming phase...")
        enc_pq, sfn_pq = pq_stream_state(x, Metric.L2)
        rn_host_s = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(
            np.float32
        )
        q_np = np.asarray(q_all[:256])
        pool_pq = max(4 * K, 128)

        def stream_pq_once():
            _, rows_p = TT.streaming_topk_scored(
                qs_small, enc_pq, N, pool_pq, sfn_pq
            )
            rows_p = np.asarray(rows_p)
            safe = np.maximum(rows_p, 0)
            v = x[safe]  # [B, pool, d] host gather — no device round-trip
            prod = np.einsum("bcd,bd->bc", v, q_np, dtype=np.float64)
            qn = np.einsum("bd,bd->b", q_np, q_np, dtype=np.float64)
            de = qn[:, None] + rn_host_s[safe] - 2.0 * prod
            de = np.where(rows_p >= 0, de, np.inf)
            si = np.argsort(de, axis=1)[:, :K]
            return np.take_along_axis(rows_p, si, axis=1)

        ids_p = stream_pq_once()
        rec_p = sum(
            len(set(map(int, ids_p[b])) & set(map(int, gt_i[b])))
            for b in range(256)
        ) / (256 * K)
        t0 = time.perf_counter()
        stream_pq_once()
        dt = time.perf_counter() - t0
        extras["stream_pq_qps"] = round(256 / dt, 1)
        extras["stream_pq_recall"] = round(rec_p, 4)
        extras["stream_pq_pass_s"] = round(dt, 2)
        extras["stream_pq_h2d_mb_per_pass"] = round(
            sum(a[:N].nbytes for a in enc_pq.values()) / 1e6, 1
        )
    except Exception as e:  # noqa: BLE001
        log(f"pq streaming phase failed: {e!r}")
        extras["stream_pq_error"] = repr(e)

    # ---------------- beyond-HBM cluster-cached coded serving --------------
    # The cloud/cache tier (ops/ivf_cache): a fixed 256-cluster device cache
    # (~1/4 of the table's HBM at 1M) over a host-resident coded table under
    # CLUSTERED query traffic — the tier's stated economics (reference: lazy
    # block reads + block cache, segment.go:1151).
    try:
        from vecgo.index.common import rerank_host_rows
        from vecgo.ops.ivf_cache import ClusterCachedTable, MemHostTable

        log("cluster-cached serving phase...")
        t0 = time.perf_counter()
        host_tbl = MemHostTable({
            "codes": np.asarray(table.codes),
            "bn": np.asarray(table.bnorm2),
            "scale": np.asarray(table.scale),
            "cent": np.asarray(table.centroids),
            "cnorm2": np.asarray(table.cnorm2),
            "rows": np.asarray(table.rows),
        })
        extras["cached_d2h_s"] = round(time.perf_counter() - t0, 1)
        cc = ClusterCachedTable(host=host_tbl, cache_clusters=256)
        extras["cached_hbm_mb"] = round(cc.device_bytes() / 1e6, 1)
        # Queries restricted to 32 natural clusters. Do NOT sample membership
        # slots: overlap slots are boundary rows — worst-case probes.
        rngc = np.random.default_rng(7)
        sub = rngc.choice(N_CLUSTERS, 32, replace=False)
        qc = (
            centers[np.repeat(sub, 32)]
            + 0.35 * rngc.standard_normal((32 * 32, D)).astype(np.float32)
        )
        qc_dev = jnp.asarray(qc, jnp.float32)
        _, gt_c = T.blockwise_topk_search(
            qc_dev, xvd, K, metric=Metric.L2, x_norms_sq=rnv,
            block_rows=min(131072, n_vam), exact=True,
        )
        gt_c = np.asarray(gt_c)
        rn_host = np.asarray(rnv)

        def cached_once():
            return cc.probe_and_scan(qc_dev, n_probe=4, kk=16)[1]

        t0 = time.perf_counter()
        rows_c = jax.block_until_ready(cached_once())
        extras["cached_cold_s"] = round(time.perf_counter() - t0, 2)
        extras["cached_h2d_mb"] = round(cc.stats["h2d_bytes"] / 1e6, 1)
        rr = np.asarray(rows_c)
        de = np.asarray(
            rerank_host_rows(qc_dev, rr, x[:n_vam], rn_host, Metric.L2)
        )
        # Dedup before the top-K cut: overlap membership returns the same row
        # from several probed clusters.
        hits = 0
        for b in range(len(qc)):
            seen = []
            for j in np.argsort(de[b]):
                rrow = int(rr[b, j])
                if rrow >= 0 and rrow not in seen:
                    seen.append(rrow)
                if len(seen) == K:
                    break
            hits += len(set(seen) & set(map(int, gt_c[b])))
        rec_c = hits / (len(qc) * K)
        dt = _timed(cached_once, reps=5)
        extras["cached_qps"] = round(len(qc) / dt, 1)
        extras["cached_recall"] = round(rec_c, 4)
        extras["cached_misses"] = cc.stats["misses"]
        extras["cached_dropped"] = cc.stats["dropped_probes"]
        extras["cached_h2d_bytes_per_query"] = round(
            cc.stats["h2d_bytes"] / max(1, len(qc)), 1
        )
    except Exception as e:  # noqa: BLE001
        log(f"cached phase failed: {e!r}")
        extras["cached_error"] = repr(e)


PHASES = {
    "prep": (phase_prep, 1500),
    "ingest": (phase_ingest, 600),
    "flat": (phase_flat, 900),
    "engine": (phase_engine, 1200),
    "filtered": (phase_filtered, 1800),
    "hybrid": (phase_hybrid, 1200),
    "vamana": (phase_vamana, 2400),
    "engine_graph": (phase_engine_graph, 2400),
}


def _phase_list():
    if MODE == "flat":
        return ["prep", "ingest", "flat", "engine"]
    if MODE == "vamana":
        return ["prep", "vamana"]
    return [
        "prep", "ingest", "flat", "engine", "filtered", "hybrid", "vamana",
        "engine_graph",
    ]


def _run_phase_inline(name):
    results, curve, extras = {}, [], {}
    PHASES[name][0](results, curve, extras)
    return results, curve, extras


def _orchestrate(results, curve, extras):
    """Run each phase in its own subprocess, one at a time; merge their JSON
    payloads (whatever a failed child collected is kept)."""
    for name in _phase_list():
        _, timeout_s = PHASES[name]
        log(f"=== phase {name} (subprocess) ===")
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--phase", name],
                capture_output=True, text=True, timeout=timeout_s,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            sys.stderr.write(r.stderr[-6000:])
            payload = None
            if r.stdout.strip():
                try:
                    payload = json.loads(r.stdout.strip().splitlines()[-1])
                except ValueError:
                    payload = None
            if payload is not None:
                for k, v in payload.get("results", {}).items():
                    results[k] = tuple(v)
                curve.extend(payload.get("curve", []))
                extras.update(payload.get("extras", {}))
            if r.returncode != 0 and f"{name}_error" not in extras:
                extras[f"{name}_error"] = f"rc={r.returncode}: " + (
                    r.stderr.strip().splitlines()[-1]
                    if r.stderr.strip() else ""
                )
        except subprocess.TimeoutExpired:
            extras[f"{name}_error"] = f"timeout after {timeout_s}s"
        extras[f"{name}_phase_s"] = round(time.perf_counter() - t0, 1)


def main(results, curve, extras):
    """Fills results/curve/extras IN PLACE so a fatal crash still emits
    whatever was collected (the __main__ block prints from a finally)."""
    extras.update({"n": N, "d": D, "mode": MODE, "batch": BATCH})
    if os.environ.get("BENCH_INPROC") == "1":
        _jax_setup()
        extras.update(_device_extras())
        for name in _phase_list():
            try:
                r, c, e = _run_phase_inline(name)
                results.update(r)
                curve.extend(c)
                extras.update(e)
            except Exception as ex:  # noqa: BLE001
                log(f"phase {name} failed: {ex!r}")
                log(traceback.format_exc())
                extras[f"{name}_error"] = repr(ex)
    else:
        _orchestrate(results, curve, extras)


def _emit(results, curve, extras):
    # frontier summary: best QPS at each recall tier. FILTERED points scan
    # only sel*N rows — they stay in the curve/extras but are excluded from
    # the full-corpus headline and frontier tiers.
    full = [c for c in curve if not c["path"].startswith("filtered")]
    for tier, key in ((0.95, "best_qps_at_95"), (0.97, "best_qps_at_97"),
                      (0.99, "best_qps_at_99")):
        pts = [c for c in full if c["recall"] >= tier]
        if pts:
            b = max(pts, key=lambda c: c["qps"])
            extras[key] = b["qps"]
            extras[key + "_path"] = b["path"]
    if curve:
        extras["curve"] = sorted(curve, key=lambda c: -c["qps"])
    results = {
        k: v for k, v in results.items() if not k.startswith("filtered")
    } or results
    ok = {k: v for k, v in results.items() if v[1] >= 0.95} or results
    if ok:
        name, (qps, rec) = max(ok.items(), key=lambda kv: kv[1][0])
        out = {
            "metric": f"QPS/chip at recall@10>=0.95 ({N}x{D}, best path)",
            "value": round(qps, 1),
            "unit": "qps",
            "vs_baseline": round(qps / BASELINE_QPS, 2),
            "best_path": name,
            "recall@10": round(rec, 4),
            **extras,
        }
    else:
        out = {
            "metric": f"QPS/chip at recall@10>=0.95 ({N}x{D}, best path)",
            "value": 0.0,
            "unit": "qps",
            "vs_baseline": 0.0,
            "best_path": "none",
            **extras,
        }
    # Persist the FULL payload to bench_out/BENCH_FULL.json (gitignored),
    # then print a compact line that fits a 2000-byte output tail: headline
    # fields + a priority-ordered subset of extras, trimmed below 1800 bytes.
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_out")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "BENCH_FULL.json"), "w") as f:
            json.dump(out, f, indent=1)
        log("full bench payload -> bench_out/BENCH_FULL.json")
    except OSError as e:
        log(f"could not write bench_out/BENCH_FULL.json: {e!r}")
    head = ["metric", "value", "unit", "vs_baseline", "best_path", "recall@10"]
    prio = [
        "best_qps_at_95", "best_qps_at_97", "best_qps_at_99",
        "best_qps_at_95_path", "best_qps_at_99_path",
        "flat_rr_qps", "flat_rr_recall", "flat_bf16_qps", "flat_bf16_recall",
        "vamana_qps", "vamana_recall",
        "engine_flat_qps", "engine_flat_recall", "engine_stream_qps",
        "commit_s",
        "engine_graph_qps", "engine_graph_recall", "engine_graph_stream_qps",
        "filtered_vs_ref@1pct", "filtered_vs_ref@10pct",
        "filtered_vs_ref@50pct",
        "filtered_uniform@1pct_qps", "filtered_uniform@1pct_stream_qps",
        "filtered_uniform@1pct_recall", "filtered_uniform@50pct_qps",
        "filtered_uniform@50pct_recall",
        "hybrid_device_qps", "hybrid_device_vs_ref", "hybrid_exact_qps",
        "lexical_device_qps",
        "ingest_vps", "ingest_vs_go_deferred", "build_s", "build_vps",
        "build_vs_go_hnsw",
        "stream_qps", "stream_pq_qps", "cached_qps", "cached_recall",
        "n", "d", "batch", "platform", "device_kind", "device_count",
        "card",
    ] + sorted(k for k in extras if k.endswith("_error"))
    compact = {k: out[k] for k in head if k in out}
    compact["full"] = "bench_out/BENCH_FULL.json"
    for k in prio:
        if k in out and k not in compact:
            compact[k] = out[k]
            if len(json.dumps(compact)) > 1800:
                del compact[k]
    print(json.dumps(compact), flush=True)


if __name__ == "__main__":
    # A driver-side kill (timeout SIGTERM) must still emit whatever phases
    # completed: convert the signal into SystemExit so the finally runs.
    import signal as _signal

    def _terminated(signum, frame):  # noqa: ARG001
        raise SystemExit(128 + signum)

    _signal.signal(_signal.SIGTERM, _terminated)

    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        # Child mode: run ONE phase, print its payload as the last stdout line.
        _name = sys.argv[2]
        _r, _c, _e = {}, [], {}
        try:
            PHASES[_name][0](_r, _c, _e)
        except Exception as _ex:  # noqa: BLE001
            log(traceback.format_exc())
            _e[f"{_name}_error"] = repr(_ex)
            print(json.dumps({"results": {}, "curve": _c, "extras": _e}),
                  flush=True)
            sys.exit(1)
        print(json.dumps({
            "results": {k: [v[0], v[1]] for k, v in _r.items()},
            "curve": _c,
            "extras": _e,
        }), flush=True)
        sys.exit(0)
    # No GPU, no result: a child process checks (this one stays off the card).
    _check = subprocess.run(
        [sys.executable, "-c",
         "from vecgo.utils.device import device_info; device_info()"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if _check.returncode != 0:
        log(_check.stderr.strip().splitlines()[-1] if _check.stderr.strip()
            else "bench.py: device check failed")
        sys.exit(1)
    _results, _curve, _extras = {}, [], {}
    try:
        main(_results, _curve, _extras)
    except BaseException as e:  # noqa: BLE001 — the JSON line must survive
        log(f"bench crashed: {e!r}")
        log(traceback.format_exc())
        _extras["fatal_error"] = repr(e)
    finally:
        _emit(_results, _curve, _extras)

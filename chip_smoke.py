#!/usr/bin/env python3
"""Smoke test of the engine's main path on one GPU, through the public API.

    python chip_smoke.py                # one GPU, 1M x 128 (the default)
    python chip_smoke.py --four-cards   # sharded search on four GPUs, 4M x 128
    python chip_smoke.py --rehearse     # every phase at tiny size on the CPU

One process drives the card. Phases, in order; each compiles first (reported
as compile_s, set-up) and then runs warm (warm_s), and each is compared with
a plain reference: an exact float64 NumPy brute force over the rows visible
to the query, chunked, with the same filter.

  0 device    JAX must report a GPU; prints the card's name and power limit
  1 ingest    Open -> insert_batch (1M rows + metadata) -> commit
  2 flat      search_arrays, bf16-scan profile and f32 profile
  3 filtered  md.eq filters at about 10% and 1% selectivity
  4 graph     compact into a Vamana segment in this process, graph profiles
  5 hybrid    hybrid_search_batch over 100k rows with texts vs the exact
              host BM25+RRF path
  6 coded     ops/ivf coded-table scan: the XLA scan against the Triton
              kernel that serves it on the GPU

Data is a seeded clustered corpus (utils/testutil.clustered_vectors) in the
shape of ANN-benchmarks sift-128-euclidean: 128-d float32, L2.

Any failed phase makes the script exit non-zero. On success the last line of
standard output is {"ok": true, "device": {...}}. --rehearse never prints it
and always exits non-zero, so a CPU run cannot pass for a chip run.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

K = 10
# spread: per-dimension noise around each cluster center; wide enough that
# the bf16 scan's pool of k+8 holds the true top-k (about 1,000 rows per
# cluster at full size).
FULL = dict(n=1_000_000, d=128, clusters=1024, spread=0.2, nq=4096,
            graph_threshold=32_768,
            n_hybrid=100_000, nq_hybrid=1024, n_four=4_000_000, nq_four=1024,
            knn_slice=65_536)
TINY = dict(n=6_000, d=64, clusters=16, spread=0.25, nq=64,
            graph_threshold=2_048,
            n_hybrid=3_000, nq_hybrid=32, n_four=8_192, nq_four=32,
            knn_slice=2_048)
SEED = 1234
DIST_RTOL = 1e-4  # returned vs reference distance, f32 norm expansion
RECALL_EXACT = 0.999  # exact profiles (flat, filtered, sharded)
RECALL_RESCORE = 0.99  # graph rescore profile
HYBRID_AGREEMENT = 0.95

# The graph serving profiles bench.py serves (phase engine_graph).
GRAPH_PROFILES = (
    ("engine_graph", dict(ef=48, nprobes=4, graph_refine=0,
                          graph_rescore=False)),
    ("engine_graph_qcap", dict(ef=48, nprobes=4, graph_refine=0,
                               graph_rescore=False, graph_qcap_factor=1.25)),
    ("engine_graph_rescore", dict(ef=48, nprobes=8, graph_refine=0,
                                  graph_rescore=True)),
    ("engine_graph_refine", dict(ef=48, nprobes=4)),
)


class PhaseFailed(AssertionError):
    """A phase's result disagreed with its reference."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def timed(fn):
    """(result, seconds) with the result on the host or blocked on."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def compile_and_warm(fn):
    """First call compiles (set-up), the second runs warm."""
    _, compile_s = timed(fn)
    out, warm_s = timed(fn)
    return out, compile_s, warm_s


# ---------------------------------------------------------------------------
# Data and references
# ---------------------------------------------------------------------------


def make_data(n: int, nq: int, d: int, clusters: int, spread: float,
              seed: int = SEED):
    """Seeded corpus + held-out in-distribution queries, and metadata
    columns: `cat` uniform over 10 values, `tag` uniform over 100 (one tag
    value selects about 1% of rows)."""
    from vecgo.utils.testutil import clustered_vectors

    xq, _ = clustered_vectors(n + nq, d, n_clusters=clusters, spread=spread,
                              seed=seed)
    rng = np.random.default_rng(seed + 1)
    cat = rng.integers(0, 10, n)
    tag = rng.integers(0, 100, n)
    return xq[:n], xq[n:], cat, tag


def exact_topk(q: np.ndarray, x: np.ndarray, k: int, rows=None,
               chunk: int = 32_768):
    """Exact float64 top-k of q against x[rows] (all rows if None): chunked
    brute force, chunks scored on threads. Returns corpus row indices
    [B, k] (-1 padded) in ascending distance order."""
    rows = np.arange(len(x)) if rows is None else np.asarray(rows)
    qf = q.astype(np.float64)
    qn = np.einsum("bd,bd->b", qf, qf)

    def part(s):
        r = rows[s:s + chunk]
        xc = x[r].astype(np.float64)
        dd = qn[:, None] + np.einsum("nd,nd->n", xc, xc)[None, :] - 2.0 * (
            qf @ xc.T
        )
        kk = min(k, len(r))
        sel = np.argpartition(dd, kk - 1, axis=1)[:, :kk]
        return np.take_along_axis(dd, sel, axis=1), r[sel]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(part, range(0, len(rows), chunk)))
    dd = np.concatenate([p[0] for p in parts], axis=1)
    rr = np.concatenate([p[1] for p in parts], axis=1)
    order = np.argsort(dd, axis=1, kind="stable")[:, :k]
    out = np.take_along_axis(rr, order, axis=1)
    if out.shape[1] < k:
        out = np.pad(out, ((0, 0), (0, k - out.shape[1])), constant_values=-1)
    return out


def recall(got_ids: np.ndarray, want_ids: np.ndarray) -> float:
    hits = total = 0
    for g, w in zip(got_ids, want_ids):
        w = set(int(i) for i in w if i >= 0)
        hits += len(w & set(int(i) for i in g))
        total += len(w)
    return hits / max(total, 1)


def distance_error(q, x, id_to_row, got_ids, got_d):
    """Worst relative error of returned distances against the float64
    distance of the same id."""
    ok = got_ids >= 0
    b_idx = np.nonzero(ok)[0]
    rows = id_to_row[got_ids[ok]]
    diff = q[b_idx].astype(np.float64) - x[rows].astype(np.float64)
    ref = np.einsum("nd,nd->n", diff, diff)
    return float(np.max(np.abs(got_d[ok] - ref) / np.maximum(ref, 1e-12)))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# Single-card phases
# ---------------------------------------------------------------------------


class Run:
    """Shared state of one smoke run."""

    def __init__(self, sizes: dict, card: str, workdir: str):
        self.s = sizes
        self.card = card
        self.workdir = workdir
        self.results = {}
        self.failed = []

    def report(self, name: str, **metrics):
        metrics["peak_bytes_in_use"] = peak_bytes()
        metrics["card"] = self.card
        self.results[name] = metrics
        print(f"phase {name}: {json.dumps(metrics)}", flush=True)

    def phase(self, name: str, fn):
        log(f"=== phase {name} ===")
        t0 = time.perf_counter()
        try:
            fn(self)
        except Exception as e:  # noqa: BLE001 - recorded; the run exits non-zero
            log(traceback.format_exc())
            self.failed.append(name)
            print(f"phase {name}: FAILED {e.__class__.__name__}: {e}",
                  flush=True)
        log(f"phase {name} took {time.perf_counter() - t0:.1f}s")


def phase_ingest(run: Run):
    import vecgo

    s = run.s
    run.x, run.q, run.cat, run.tag = make_data(s["n"], s["nq"], s["d"],
                                               s["clusters"], s["spread"])
    metas = [{"cat": int(c), "tag": int(t)} for c, t in zip(run.cat, run.tag)]
    run.db = vecgo.Open(
        vecgo.Local(os.path.join(run.workdir, "db")),
        vecgo.Create(dim=s["d"], flush_threshold=2**62,
                     graph_threshold=s["graph_threshold"]),
    )
    t0 = time.perf_counter()
    ids = np.asarray(run.db.insert_batch(run.x, metadatas=metas), np.int64)
    ingest_s = time.perf_counter() - t0
    del metas
    t0 = time.perf_counter()
    run.db.commit()
    commit_s = time.perf_counter() - t0
    run.ids = ids
    run.id_to_row = np.full(int(ids.max()) + 1, -1, np.int64)
    run.id_to_row[ids] = np.arange(len(ids))
    st = run.db.stats()
    probe = len(ids) // 2
    got = run.db.get(int(ids[probe]))
    run.report("1_ingest", rows=int(st["live_rows"]), ingest_s=ingest_s,
               rows_per_s=len(ids) / ingest_s, commit_s=commit_s,
               segments=[g["kind"] for g in st["segments"]])
    check(st["live_rows"] == s["n"] and st["memtable_rows"] == 0,
          f"row count {st['live_rows']} after commit, want {s['n']}")
    check(np.array_equal(got.vector, run.x[probe])
          and got.metadata.get("cat") == int(run.cat[probe]),
          "acknowledged row did not read back")


def phase_flat(run: Run):
    from vecgo.ops import distance

    db, q = run.db, run.q
    t0 = time.perf_counter()
    run.ref = exact_topk(q, run.x, K)
    ref_s = time.perf_counter() - t0
    want = run.ids[run.ref]
    for profile in ("bf16", "f32"):
        db.engine.options.flat_scan_dtype = profile
        (ids, dists), c_s, w_s = compile_and_warm(
            lambda: db.search_arrays(q, k=K)
        )
        rec = recall(ids, want)
        err = distance_error(q, run.x, run.id_to_row, ids, dists)
        extra = {"dot_algorithm": str(distance.F32_DOT)} if profile == "f32" else {}
        run.report(f"2_flat_{profile}", compile_s=c_s, warm_s=w_s,
                   qps=len(q) / w_s, recall=rec, max_rel_dist_err=err,
                   reference_s=ref_s, **extra)
        check(rec >= RECALL_EXACT, f"{profile} recall {rec:.4f}")
        check(err <= DIST_RTOL, f"{profile} distance error {err:.2e}")
    db.engine.options.flat_scan_dtype = "bf16"


def phase_filtered(run: Run):
    from vecgo import metadata as md

    db, q = run.db, run.q
    for name, col, value in (("cat10pct", "cat", 3), ("tag1pct", "tag", 7)):
        f = md.eq(col, value)
        rows = np.flatnonzero(getattr(run, col) == value)
        want = run.ids[exact_topk(q, run.x, K, rows=rows)]
        (ids, dists), c_s, w_s = compile_and_warm(
            lambda: db.search_arrays(q, k=K, filter=f)
        )
        one = [c.id for c in db.search(q[0], k=K, filter=f)]
        rec = recall(ids, want)
        err = distance_error(q, run.x, run.id_to_row, ids, dists)
        run.report(f"3_filtered_{name}", selectivity=len(rows) / len(run.x),
                   compile_s=c_s, warm_s=w_s, qps=len(q) / w_s, recall=rec,
                   max_rel_dist_err=err)
        check(rec >= RECALL_EXACT, f"{name} recall {rec:.4f}")
        check(set(one) == set(int(i) for i in ids[0] if i >= 0),
              f"{name}: search() and search_arrays() disagree on query 0")


class _RetryCounter(logging.Handler):
    """Counts the warnings utils/devbug.py logs when it retries a call."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        msg = record.getMessage()
        if "dispatch failed" in msg or "compiled call failed" in msg:
            self.count += 1


def phase_graph(run: Run):
    db, q = run.db, run.q
    retries = _RetryCounter()
    logging.getLogger("vecgo").addHandler(retries)
    try:
        t0 = time.perf_counter()
        db.compact([g["seg_id"] for g in db.stats()["segments"]])
        compact_s = time.perf_counter() - t0
        kinds = [g["kind"] for g in db.stats()["segments"]]
        run.report("4_graph_compact", compact_s=compact_s,
                   rows_per_s=len(run.x) / compact_s, segments=kinds)
        check(kinds == ["vamana"], f"compaction produced {kinds}")
        want = run.ids[run.ref]
        recs = {}
        for name, kw in GRAPH_PROFILES:
            (ids, _), c_s, w_s = compile_and_warm(
                lambda: db.search_arrays(q, k=K, **kw)
            )
            recs[name] = recall(ids, want)
            run.report(f"4_{name}", compile_s=c_s, warm_s=w_s,
                       qps=len(q) / w_s, recall=recs[name], **kw)
        run.results["4_graph_compact"]["devbug_retries"] = retries.count
        print(f"phase 4_graph: devbug retries {retries.count}", flush=True)
        check(recs["engine_graph_rescore"] >= RECALL_RESCORE,
              f"rescore profile recall {recs['engine_graph_rescore']:.4f}")
        _graph_xla_end_to_end(run)
    finally:
        logging.getLogger("vecgo").removeHandler(retries)


def _graph_xla_end_to_end(run: Run):
    """The fast graph profile again with the coded scan forced onto the XLA
    scan instead of the Triton kernel: same snapshot, same queries."""
    import jax

    from vecgo.ops import ivf

    name, kw = GRAPH_PROFILES[0]
    applies = ivf._triton_scan_applies
    ivf._triton_scan_applies = lambda table, d: False
    jax.clear_caches()
    try:
        (ids, _), c_s, w_s = compile_and_warm(
            lambda: run.db.search_arrays(run.q, k=K, **kw)
        )
    finally:
        ivf._triton_scan_applies = applies
        jax.clear_caches()
    run.report(f"4_{name}_xla_scan", compile_s=c_s, warm_s=w_s,
               qps=len(run.q) / w_s, recall=recall(ids, run.ids[run.ref]),
               triton_scan_warm_s=len(run.q) / run.results[f"4_{name}"]["qps"])


def _bm25_texts(n: int, words: int, rng) -> list:
    vocab = np.asarray([f"w{i}" for i in range(20_000)])
    ids = np.minimum(rng.zipf(1.3, (n, words)) - 1, 19_999)
    return [" ".join(row) for row in vocab[ids]]


def phase_hybrid(run: Run):
    import vecgo

    s = run.s
    n, nq = s["n_hybrid"], s["nq_hybrid"]
    rng = np.random.default_rng(SEED + 2)
    texts = _bm25_texts(n, 12, rng)
    qtexts = _bm25_texts(nq, 3, rng)
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(
        dim=s["d"], flush_threshold=2**62, lexical=True,
    ))
    try:
        t0 = time.perf_counter()
        db.insert_batch(run.x[:n], texts=texts)
        db.commit()
        ingest_s = time.perf_counter() - t0
        q = run.q[:nq]
        # Exact host BM25 + RRF first: the device snapshot does not exist yet.
        db.engine.options.lexical_device = "off"
        (ids_exact, _), _, exact_s = compile_and_warm(
            lambda: db.hybrid_search_batch(q, qtexts, k=K)
        )
        db.engine.options.lexical_device = "auto"
        db.engine.enable_device_lexical(max_hot_terms=2048, min_df=8)
        (ids_dev, _), c_s, w_s = compile_and_warm(
            lambda: db.hybrid_search_batch(q, qtexts, k=K)
        )
        agree = float(np.mean([
            len(set(ids_dev[b]) & set(ids_exact[b]))
            / max(1, int((ids_exact[b] >= 0).sum()))
            for b in range(nq)
        ]))
        run.report("5_hybrid", rows=n, ingest_s=ingest_s, compile_s=c_s,
                   warm_s=w_s, qps=nq / w_s, exact_host_s=exact_s,
                   exact_host_qps=nq / exact_s, agreement=agree)
        check(agree >= HYBRID_AGREEMENT, f"hybrid agreement {agree:.4f}")
    finally:
        db.close()


def phase_coded(run: Run):
    """ivf_scan on the graph segment's coded table: the XLA scan against the
    Triton kernel, at the graph phase's shapes (B = all queries, 4 probes)."""
    import functools

    import jax
    import jax.numpy as jnp

    from vecgo.ops import coded_scan_triton as tk
    from vecgo.ops import ivf

    seg = run.db.engine._segments[-1].segment
    table = seg.device_state()["ivfq"]
    n_probe, kk = 4, 16
    k_pad, s_slots = table.bnorm2.shape
    b = len(run.q)
    qcap = min(b, max(32, ((3 * b * n_probe // k_pad) + 31) // 32 * 32))
    # The kernel runs compiled on the GPU; only a CPU rehearsal interprets it.
    rehearsal = jax.devices()[0].platform != "gpu"
    q = jnp.asarray(run.q)

    @jax.jit
    def probes_of(q, table):
        return ivf._probe_clusters(q, table, n_probe)

    xla = jax.jit(functools.partial(ivf._scan_groups_xla, kk=kk, qcap=qcap,
                                    group=8))
    tri = jax.jit(functools.partial(tk.scan_groups, kk=kk, qcap=qcap,
                                    interpret=rehearsal))
    probes = probes_of(q, table)
    (xd, xr), xc_s, xw_s = compile_and_warm(lambda: xla(q, table, probes, None))
    (td, tr), tc_s, tw_s = compile_and_warm(lambda: tri(q, table, probes, None))
    xd, xr, td, tr = map(np.asarray, (xd, xr, td, tr))
    fin = np.isfinite(xd)
    max_diff = float(np.max(np.abs(xd[fin] - td[fin]))) if fin.any() else 0.0
    same_rows = float((xr == tr).mean())
    run.report("6_coded_scan", clusters=int(k_pad), slots=int(s_slots),
               batch=b, nprobes=n_probe, kk=kk, qcap=qcap,
               xla_compile_s=xc_s, xla_warm_s=xw_s, triton_compile_s=tc_s,
               triton_warm_s=tw_s, max_abs_dist_diff=max_diff,
               same_rows=same_rows, triton_interpret=rehearsal)
    check(bool((np.isfinite(td) == fin).all()), "finite-slot sets differ")
    check(max_diff <= 1e-3 * max(1.0, float(np.max(np.abs(xd[fin])))),
          f"candidate distances differ by {max_diff}")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_four_cards(run: Run):
    """Engine.sharded_searcher over a 4-way shard mesh on the committed
    snapshot, against the exact single-process reference; then
    sharded_cluster_knn against build_fast._cluster_knn on one slice."""
    import jax
    import ml_dtypes
    from jax.sharding import NamedSharding, PartitionSpec

    import vecgo
    from vecgo.index.build_fast import _cluster_knn
    from vecgo.parallel import mesh as pm
    from vecgo.parallel.engine_shard import sharded_cluster_knn

    s = run.s
    n, d, nq = s["n_four"], s["d"], s["nq_four"]
    x, q, _, _ = make_data(n, nq, d, s["clusters"], s["spread"])
    db = vecgo.Open(vecgo.Local(os.path.join(run.workdir, "db4")),
                    vecgo.Create(dim=d, flush_threshold=2**62))
    try:
        t0 = time.perf_counter()
        ids = np.asarray(db.insert_batch(x), np.int64)
        db.commit()
        ingest_s = time.perf_counter() - t0
        id_to_row = np.full(int(ids.max()) + 1, -1, np.int64)
        id_to_row[ids] = np.arange(n)
        mesh = pm.make_mesh(shard=4)
        t0 = time.perf_counter()
        searcher = db.sharded_searcher(mesh)
        place_s = time.perf_counter() - t0
        (got, dists), c_s, w_s = compile_and_warm(
            lambda: searcher.search(q, K)
        )
        want = ids[exact_topk(q, x, K)]
        rec = recall(got, want)
        err = distance_error(q, x, id_to_row, got, dists)
        run.report("4cards_sharded_search", rows=n, mesh=dict(mesh.shape),
                   ingest_s=ingest_s, place_s=place_s, compile_s=c_s,
                   warm_s=w_s, qps=nq / w_s, recall=rec, max_rel_dist_err=err)
        check(rec >= RECALL_EXACT, f"sharded recall {rec:.4f}")
        check(err <= DIST_RTOL, f"sharded distance error {err:.2e}")
    finally:
        db.close()

    m = s["knn_slice"]
    xs = x[:m]
    x16_host = xs.astype(ml_dtypes.bfloat16)
    rn_host = np.einsum("nd,nd->n", xs, xs, dtype=np.float64).astype(np.float32)
    x16 = jax.device_put(x16_host, jax.devices()[0])
    rn = jax.device_put(rn_host, jax.devices()[0])
    rep = NamedSharding(mesh, PartitionSpec())
    x16_rep = jax.device_put(x16_host, rep)
    rn_rep = jax.device_put(rn_host, rep)
    csize = min(1024, m // 16)
    members = np.arange(m, dtype=np.int32).reshape(m // csize, csize)
    slots = np.zeros_like(members)
    args = (members, slots, 16, 1, m, 4)
    single, c1_s, w1_s = compile_and_warm(
        lambda: _cluster_knn(x16, rn, *args)
    )
    sharded, c4_s, w4_s = compile_and_warm(
        lambda: sharded_cluster_knn(x16_rep, rn_rep, *args, mesh)
    )
    single, sharded = np.asarray(single), np.asarray(sharded)
    same = float((single == sharded).mean())
    run.report("4cards_cluster_knn", rows=m, clusters=int(members.shape[0]),
               single_compile_s=c1_s, single_warm_s=w1_s,
               sharded_compile_s=c4_s, sharded_warm_s=w4_s, identical=same)
    check(same == 1.0, f"sharded cluster KNN differs ({same:.6f} identical)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at tiny size on the CPU; never "
                    "prints the ok line and exits non-zero")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharded path and its "
                    "references")
    args = ap.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            ).strip()
    import jax

    from vecgo.utils.device import NoAccelerator, card_info, device_info

    try:
        dev = device_info(expect_gpu=not args.rehearse)
    except NoAccelerator as e:
        log(f"chip_smoke: {e}")
        return 1
    want_count = 4 if args.four_cards else 1
    if dev["count"] < want_count:
        log(f"chip_smoke: needs {want_count} devices, JAX sees {dev['count']}")
        return 1
    card = card_info()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    print(f"card: {card}", flush=True)

    from vecgo.utils.jaxcache import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    run = Run(TINY if args.rehearse else FULL, card, workdir)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            run.phase("4cards", phase_four_cards)
        else:
            run.phase("1_ingest", phase_ingest)
            if run.failed:
                return 1
            for name, fn in (("2_flat", phase_flat),
                             ("3_filtered", phase_filtered),
                             ("4_graph", phase_graph),
                             ("5_hybrid", phase_hybrid),
                             ("6_coded", phase_coded)):
                run.phase(name, fn)
            run.db.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"total_s: {time.perf_counter() - t0:.1f}", flush=True)
    if run.failed:
        log(f"chip_smoke: failed phases: {run.failed}")
        return 1
    if args.rehearse:
        log("chip_smoke: rehearsal passed (CPU; no result printed)")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Engine lifecycle tests (reference: internal/engine/*_test.go +
integration_test/ — CRUD, flush/compaction, isolation, time travel, recovery)."""

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore, FaultyStore
from vecgo.engine import Engine, EngineOptions
from vecgo.errors import ErrConflict, ErrNotFound, ErrReadOnly, ErrInvalidVector
from vecgo.metadata import eq, gt, isin, Schema, FieldSpec, FieldType
from vecgo.model import Metric
from vecgo.utils import testutil as tu

D = 16


def new_engine(store=None, **kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)  # manual commits in tests
    kw.setdefault("graph_threshold", 1_000_000_000)
    return Engine.open(store or MemoryStore(), EngineOptions(**kw), create=True)


def test_insert_search_roundtrip():
    eng = new_engine()
    x = tu.gaussian_vectors(500, D, seed=41)
    ids = eng.insert_batch(x, [{"i": i} for i in range(500)])
    assert len(set(ids)) == 500
    res = eng.search(x[7], k=5)
    assert res[0].id == ids[7]
    assert res[0].distance < 1e-5
    assert res[0].metadata == {"i": 7}
    _, true_ids = tu.brute_force_knn(x[7:8], x, 5, "l2")
    got = [c.id for c in res]
    assert got == [ids[j] for j in true_ids[0]]


def test_crud_lifecycle():
    """reference: integration_test/crud_lifecycle_test.go"""
    eng = new_engine()
    x = tu.gaussian_vectors(100, D, seed=42)
    ids = eng.insert_batch(x)
    # get
    c = eng.get(ids[3])
    np.testing.assert_allclose(c.vector, x[3], rtol=1e-6)
    # update (same id): new unique vector wins
    upd = x[50] * 0.5 + 7.0
    eng.insert_batch(upd[None, :], ids=[ids[3]])
    res = eng.search(upd, k=1)
    assert res[0].id == ids[3]
    # the old version must not match anymore
    res = eng.search(x[3], k=100)
    assert sum(1 for cc in res if cc.id == ids[3]) <= 1
    # delete
    assert eng.delete(ids[3])
    assert not eng.delete(ids[3])
    with pytest.raises(ErrNotFound):
        eng.get(ids[3])
    res = eng.search(x[50], k=10)
    assert all(cc.id != ids[3] for cc in res)


def test_commit_and_search_segments():
    eng = new_engine()
    x = tu.gaussian_vectors(300, D, seed=43)
    ids = eng.insert_batch(x[:200])
    v1 = eng.commit()
    assert v1 == 1
    assert eng.stats()["memtable_rows"] == 0
    assert eng.stats()["segment_rows"] == 200
    ids2 = eng.insert_batch(x[200:])
    # mixed memtable+segment search
    q = x[250]
    res = eng.search(q, k=3)
    assert res[0].id == ids2[50]
    q2 = x[10]
    res2 = eng.search(q2, k=3)
    assert res2[0].id == ids[10]
    # exact full equivalence
    _, ti = tu.brute_force_knn(x[:8], x, 10, "l2")
    all_ids = ids + ids2
    for bi, r in enumerate(eng.search_batch(x[:8], k=10)):
        assert [c.id for c in r] == [all_ids[j] for j in ti[bi]]


def test_delete_across_commit_and_compaction():
    eng = new_engine(compaction_threshold=2)
    x = tu.gaussian_vectors(200, D, seed=44)
    ids = eng.insert_batch(x[:100])
    eng.commit()
    eng.delete(ids[0])
    eng.insert_batch(x[100:])
    eng.commit()
    res = eng.search(x[0], k=5)
    assert all(c.id != ids[0] for c in res)
    # force compaction of everything
    ver = eng.compact([h.seg_id for h in eng._segments])
    assert ver is not None
    assert len(eng._segments) == 1
    res = eng.search(x[0], k=5)
    assert all(c.id != ids[0] for c in res)
    # tombstoned row physically dropped
    assert eng._segments[0].segment.n == 199


def test_filtered_recall_exact_on_wide_masked_corpus():
    """Regression (r5): approx_min_k's binned selection loses entries on
    inf-sparse rows — a 90%-masked scan at rt=0.99 dropped a true rank-5
    neighbor from the pool (suite 'correlated' @10pct recall 0.9859). The
    masked path now runs a tighter recall target + a >=64-wide pool; filtered
    results must equal exact brute force. Corpus must be wider than the
    approx_min_k engagement width (16384) or the test exercises lax.top_k."""
    n = 30_000
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[:, 0] += np.arange(n) / n * 10  # position-correlated geometry
    cats = (np.arange(n) * 100 // n).astype(np.int64)  # contiguous categories
    eng = new_engine(flush_threshold=10**9)
    ids = eng.insert_batch(x, [{"cat": int(c)} for c in cats])
    eng.commit()
    q = x[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal(
        (16, D)
    ).astype(np.float32)
    for want_cats in (1, 10, 50):
        f = isin("cat", list(range(want_cats)))
        res = eng.search_batch(q, k=10, filter=f)
        elig = np.flatnonzero(cats < want_cats)
        _, ti = tu.brute_force_knn(q, x[elig], 10, "l2")
        got = [[c.id for c in r] for r in res]
        want = [[ids[elig[j]] for j in row] for row in ti]
        assert got == want, f"filtered mismatch at {want_cats}% selectivity"


def test_filtering_equivalence():
    """pre-filter vs post-filter produce identical results
    (reference: filtering_equivalence_test.go)"""
    eng = new_engine()
    x = tu.gaussian_vectors(400, D, seed=45)
    mds = [{"cat": f"c{i % 4}", "num": i} for i in range(400)]
    ids = eng.insert_batch(x, mds)
    eng.commit()
    q = tu.gaussian_vectors(3, D, seed=46)
    f = eq("cat", "c1") & gt("num", 100)
    r_pre = [
        [c.id for c in r]
        for r in eng.search_batch(q, k=10, filter=f, prefilter=True)
    ]
    r_post = [
        [c.id for c in r]
        for r in eng.search_batch(q, k=10, filter=f, prefilter=False)
    ]
    # host ground truth
    elig = [i for i in range(400) if i % 4 == 1 and i > 100]
    _, ti = tu.brute_force_knn(q, x[elig], 10, "l2")
    want = [[ids[elig[j]] for j in row] for row in ti]
    assert r_pre == want
    assert r_post == want


def test_plan_cache_reuse_and_invalidation():
    """The (snapshot, filter) plan cache must serve the SAME plan object
    across repeated batches on an unchanged snapshot, and must never serve a
    stale plan after a write (keys embed lsn/version) or after vacuum/compact
    (explicit clear)."""
    eng = new_engine()
    x = tu.gaussian_vectors(600, D, seed=140)
    mds = [{"cat": f"c{i % 3}"} for i in range(600)]
    ids = eng.insert_batch(x, mds)
    eng.commit()
    q = tu.gaussian_vectors(2, D, seed=141)
    f = eq("cat", "c1")
    eng.search_batch(q, k=5, filter=f)
    cached = list(eng._plan_cache._d.items())
    assert len(cached) >= 1
    key0, plan0 = cached[-1]
    eng.search_batch(q, k=5, filter=f)
    assert eng._plan_cache._d[key0] is plan0  # hit, not a rebuild
    # a write bumps the lsn -> different key; results reflect the new row
    xin = x[7:8] + 1e-4
    new_id = eng.insert(xin[0], {"cat": "c1"})
    got = [c.id for c in eng.search_batch(xin, k=1, filter=f)[0]]
    assert got == [new_id]
    assert any(k != key0 for k in eng._plan_cache._d)
    # unfiltered searches cache under a no-filter key too
    eng.search_batch(q, k=5)
    eng.commit()
    eng.compact()
    assert len(eng._plan_cache._d) == 0  # compaction clears the cache


def test_filtered_compact_gather_low_selectivity():
    """Below compact_gather_cutoff the planner gathers eligible rows into a
    dense device sub-corpus (kind flat_compact) — results must equal brute
    force over eligible rows exactly, including across repeated batches (the
    gathered state lives in the cached plan) and after a delete."""
    eng = new_engine(compact_gather_cutoff=0.10)
    x = tu.gaussian_vectors(1000, D, seed=48)
    mds = [{"g": i % 50} for i in range(1000)]  # eq -> 2% selectivity
    ids = eng.insert_batch(x, mds)
    eng.commit()
    f = eq("g", 7)
    # confirm the plan actually chose the compact path
    from vecgo.engine import search as sm
    from vecgo.model import SearchOptions

    snap = eng.snapshot()
    try:
        opts = SearchOptions(k=5, filter=f)
        opts.selectivity_cutoff = eng.options.selectivity_cutoff
        plan = sm._plan_snapshot(snap, opts, eng.options, None)
        assert [s.kind for s in plan.sources] == ["flat_compact"]
    finally:
        snap.release()
    q = tu.gaussian_vectors(4, D, seed=49)
    elig = [i for i in range(1000) if i % 50 == 7]
    _, ti = tu.brute_force_knn(q, x[elig], 5, "l2")
    want = [[ids[elig[j]] for j in row] for row in ti]
    for _ in range(2):  # second call reuses the cached plan + gathered state
        got = [
            [c.id for c in r] for r in eng.search_batch(q, k=5, filter=f)
        ]
        assert got == want
    # a delete invalidates the cached plan (new lsn) and the gathered rows
    eng.delete(want[0][0])
    got = [[c.id for c in r] for r in eng.search_batch(q, k=5, filter=f)]
    elig2 = [i for i in elig if ids[i] != want[0][0]]
    _, ti2 = tu.brute_force_knn(q, x[elig2], 5, "l2")
    assert got == [[ids[elig2[j]] for j in row] for row in ti2]


def test_snapshot_isolation_under_churn():
    """reference: isolation_test.go TestConsistency_Churn (simplified)"""
    eng = new_engine()
    x = tu.gaussian_vectors(50, D, seed=47)
    ids = eng.insert_batch(x)
    snap = eng.snapshot()
    try:
        # mutate after snapshot: delete + overwrite
        eng.delete(ids[0])
        eng.insert_batch(x[1:2] * 0.5, ids=[ids[1]])
        # snapshot still sees the old world
        from vecgo.engine import search as sm
        from vecgo.model import SearchOptions

        got, dist, _, _ = sm.search_snapshot(
            snap, eng.pk, x[0:1], SearchOptions(k=1), eng.options
        )
        assert got[0, 0] == ids[0]
        got, dist, _, _ = sm.search_snapshot(
            snap, eng.pk, x[1:2], SearchOptions(k=1), eng.options
        )
        assert got[0, 0] == ids[1] and dist[0, 0] < 1e-5
    finally:
        snap.release()
    # new searches see the new world
    res = eng.search(x[0], k=1)
    assert res[0].id != ids[0]


def test_time_travel():
    """reference: timetravel_test.go"""
    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(60, D, seed=48)
    ids = eng.insert_batch(x[:30])
    v1 = eng.commit()
    eng.delete(ids[5])
    eng.insert_batch(x[30:])
    v2 = eng.commit()
    assert eng.versions() == [0, v1, v2]
    old = Engine.open(store, EngineOptions(), version=v1)
    assert old.options.read_only
    res = old.search(x[5], k=1)
    assert res[0].id == ids[5]  # deletion not yet visible at v1
    assert old.stats()["segment_rows"] == 30
    with pytest.raises(ErrReadOnly):
        old.insert(x[0])
    cur = Engine.open(store, EngineOptions())
    res = cur.search(x[5], k=1)
    assert res[0].id != ids[5]


def test_restart_recovery():
    """reference: e2e_test.go TestE2E_Restart"""
    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(120, D, seed=49)
    ids = eng.insert_batch(x, [{"i": i} for i in range(120)])
    eng.commit()
    eng.delete(ids[7])
    eng.commit()  # persists tombstones
    eng.close()
    eng2 = Engine.open(store, EngineOptions())
    assert eng2.stats()["segment_rows"] == 120
    res = eng2.search(x[8], k=2)
    assert res[0].id == ids[8]
    assert res[0].metadata == {"i": 8}
    res = eng2.search(x[7], k=5)
    assert all(c.id != ids[7] for c in res)
    with pytest.raises(ErrNotFound):
        eng2.get(ids[7])
    # uncommitted data is lost by design (crash model): insert without commit
    eng2.insert(x[0] * 2)
    eng3 = Engine.open(store, EngineOptions())
    assert eng3.stats()["live_rows"] == 119


def test_vacuum_retention():
    store = MemoryStore()
    eng = new_engine(store, retention_versions=1, compaction_threshold=2)
    x = tu.gaussian_vectors(40, D, seed=50)
    ids = eng.insert_batch(x[:20])
    eng.commit()
    eng.insert_batch(x[20:])
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])
    n_before = len(store.list("segment_"))
    out = eng.vacuum()
    assert len(eng.versions()) <= 2  # current + retained
    n_after = len(store.list("segment_"))
    assert n_after < n_before
    # engine still searchable
    res = eng.search(x[0], k=1)
    assert res[0].id == ids[0]


def test_schema_validation():
    schema = Schema({"num": FieldSpec(FieldType.INT, required=True)})
    eng = new_engine(schema=schema)
    x = tu.gaussian_vectors(2, D, seed=51)
    eng.insert(x[0], {"num": 5})
    from vecgo.errors import ErrSchemaViolation

    with pytest.raises(ErrSchemaViolation):
        eng.insert(x[1], {"other": 1})
    with pytest.raises(ErrSchemaViolation):
        eng.insert(x[1], {"num": "nope"})


def test_invalid_vectors_rejected():
    eng = new_engine()
    bad = np.full(D, np.nan, np.float32)
    with pytest.raises(ErrInvalidVector):
        eng.insert(bad)
    from vecgo.errors import ErrDimensionMismatch

    with pytest.raises(ErrDimensionMismatch):
        eng.insert(np.ones(D + 1, np.float32))


def test_hybrid_search_rrf():
    store = MemoryStore()
    eng = new_engine(store=store, lexical=True)
    x = tu.gaussian_vectors(50, D, seed=52)
    texts = [f"document about topic {i % 5} and stuff" for i in range(50)]
    texts[3] = "the quick brown fox jumps over the lazy dog"
    ids = eng.insert_batch(x, texts=texts)
    res = eng.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    # lexical survives commit + reopen rebuild
    eng.commit()
    res = eng.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    eng.close()
    # True reopen: the BM25 index rebuilds from the segment's "_text"
    # column (no byte scanning — _rebuild_lexical reads ColumnarMeta).
    eng2 = Engine.open(store, EngineOptions(dim=D, lexical=True))
    res = eng2.hybrid_search(x[3], "quick brown fox", k=5)
    assert res[0].id == ids[3]
    eng2.close()


def test_hybrid_search_batch_matches_single():
    """Batched hybrid = per-query hybrid: same ids, same RRF mass (the
    batched path is one vector batch + one BM25 batch + vectorized fusion)."""
    eng = new_engine(lexical=True)
    x = tu.gaussian_vectors(80, D, seed=54)
    texts = [f"document about topic {i % 7} and filler words {i}" for i in range(80)]
    texts[3] = "the quick brown fox jumps over the lazy dog"
    texts[11] = "a quick dog naps"
    ids = eng.insert_batch(x, texts=texts)
    eng.delete(ids[5])
    queries = np.stack([x[3], x[11], x[40]])
    qtexts = ["quick brown fox", "quick dog", "topic 5 filler"]
    bids, bsc = eng.hybrid_search_batch(queries, qtexts, k=5)
    assert bids.shape == (3, 5) and bsc.shape == (3, 5)
    for bi in range(3):
        single = eng.hybrid_search(queries[bi], qtexts[bi], k=5)
        want = [c.id for c in single]
        got = [int(i) for i in bids[bi] if i >= 0]
        assert got == want, (bi, got, want)
        # scores match the single path's RRF mass (it returns -score)
        for j, c in enumerate(single):
            assert abs(-c.distance - float(bsc[bi, j])) < 1e-6
    assert int(bids[0, 0]) == ids[3]


def test_auto_flush_and_compaction():
    eng = new_engine(flush_threshold=50, compaction_threshold=2, auto_compact=True)
    x = tu.gaussian_vectors(250, D, seed=53)
    for s in range(0, 250, 50):
        eng.insert_batch(x[s : s + 50])
    st = eng.stats()
    assert st["memtable_rows"] == 0  # everything flushed
    assert st["live_rows"] == 250
    assert len(st["segments"]) < 5  # compaction merged some
    _, ti = tu.brute_force_knn(x[:4], x, 5, "l2")
    for bi, r in enumerate(eng.search_batch(x[:4], k=5)):
        assert [c.id for c in r] == [int(j) + 1 for j in ti[bi]]


def test_faulty_store_commit_fails_cleanly():
    """reference: fault_test.go — a failed flush must not corrupt the DB."""
    inner = MemoryStore()
    store = FaultyStore(inner, fail_pattern="segment_", fail_after=0)
    eng = Engine.open(
        store,
        EngineOptions(dim=D, flush_threshold=10_000_000, graph_threshold=1 << 40),
        create=True,
    )
    x = tu.gaussian_vectors(30, D, seed=54)
    eng.insert_batch(x)
    with pytest.raises(IOError):
        eng.commit()
    # memtable data still searchable; db recoverable at old version
    res = eng.search(x[0], k=1)
    assert res[0].distance < 1e-5
    store.fail_pattern = ""  # heal
    eng.commit()
    assert eng.stats()["segment_rows"] == 30


def test_stats_and_explain():
    eng = new_engine()
    x = tu.gaussian_vectors(100, D, seed=55)
    eng.insert_batch(x, [{"cat": f"c{i%2}"} for i in range(100)])
    eng.commit()
    res = eng.search(x[0], k=3, filter=eq("cat", "c0"), with_stats=True)
    st = res.stats
    assert st is not None
    assert st.rows_considered == 50
    assert 0.4 < st.selectivity < 0.6
    assert "filtered" in st.strategy
    assert st.total_time_s > 0
    assert len(st.explain()) > 20
    assert st.estimated_cost() > 0


def test_time_travel_as_of_timestamp():
    """reference: WithTimestamp (engine.go:289-313) — open latest version at or
    before a wall-clock instant."""
    import time as _time

    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(20, D, seed=56)
    ids = eng.insert_batch(x[:10])
    eng.commit()
    _time.sleep(0.05)
    t_mid = _time.time()
    _time.sleep(0.05)
    eng.insert_batch(x[10:])
    eng.commit()
    old = Engine.open(store, EngineOptions(), as_of=t_mid)
    assert old.stats()["live_rows"] == 10
    assert old.options.read_only
    cur = Engine.open(store, EngineOptions())
    assert cur.stats()["live_rows"] == 20


def test_commit_ivf_reorder_pk_mapping():
    """Regression (round-1 advisor, high): commit() assumed FlatWriter
    preserves add order, but IVF partitioning permutes rows — PK then pointed
    at the wrong rows (silent data corruption on get/delete)."""
    eng = new_engine(
        ivf_rows_per_partition=64,
        flush_ivf_partitions=True,  # partition-at-flush is opt-in since r4
        flush_threshold=10_000_000,
    )
    n = 256  # >= 2*64 triggers IVF reorder with 4 partitions
    x, _ = tu.clustered_vectors(n, D, n_clusters=4, seed=51)
    mds = [{"i": i} for i in range(n)]
    ids = eng.insert_batch(x, mds)
    eng.commit()
    assert eng._segments[0].segment.ivf_part is not None  # reorder happened
    for i in range(n):
        c = eng.get(ids[i])
        np.testing.assert_allclose(c.vector, x[i], rtol=1e-6)
        assert c.metadata == {"i": i}
    # Deletes kill the right rows.
    for i in (0, 100, 255):
        eng.delete(ids[i])
        res = eng.search(x[i], k=3)
        assert all(c.id != ids[i] for c in res)
    # Upsert replaces the right row.
    upd = x[42] * 0.25 + 3.0
    eng.insert_batch(upd[None, :], [{"u": 1}], ids=[ids[42]])
    c = eng.get(ids[42])
    np.testing.assert_allclose(c.vector, upd, rtol=1e-6)


def test_flush_skips_ivf_kmeans_by_default():
    """Flush-time k-means dominated a 1M commit while the serving default
    ignores flat partitions (the exact matmul sweep scans every block
    anyway) — so flush skips it by default;
    compaction still partitions. nprobes on a partition-less segment must
    silently run exact."""
    eng = new_engine(ivf_rows_per_partition=64, flush_threshold=10_000_000)
    x, _ = tu.clustered_vectors(256, D, n_clusters=4, seed=53)
    ids = eng.insert_batch(x)
    eng.commit()
    seg = eng._segments[0].segment
    assert seg.ivf_part is None  # no flush-time k-means
    # nprobes through the engine falls back to the exact scan.
    res = eng.search(x[7], k=3, nprobes=4)
    assert res[0].id == ids[7]
    # Compaction output IS partitioned (the long-lived tier keeps the rule).
    eng.insert_batch(x * 0.5 + 4.0)
    eng.commit()
    out = eng.compact([h.seg_id for h in eng._segments])
    assert out is not None
    assert eng._segments[-1].segment.ivf_part is not None
    eng.close()


def test_recovery_update_without_close():
    """Regression (round-1 advisor, high): _rebuild_pk replayed persisted
    tombstones at the manifest LSN, outranking newer live versions — updated
    ids resolved as deleted after a checkpoint-less open."""
    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(30, D, seed=52)
    ids = eng.insert_batch(x[:20])
    eng.commit()
    upd = x[5] * 0.5 + 2.0
    eng.insert_batch(upd[None, :], ids=[ids[5]])  # update -> tombstones old row
    eng.insert_batch(x[20:])
    eng.commit()
    # Reopen WITHOUT close(): no PK checkpoint -> rebuild path.
    eng2 = Engine.open(store, EngineOptions())
    c = eng2.get(ids[5])
    np.testing.assert_allclose(c.vector, upd, rtol=1e-6)
    res = eng2.search(upd, k=1)
    assert res[0].id == ids[5]
    # Plain deletes still stick after rebuild.
    eng2.delete(ids[6])
    eng2.commit()
    eng3 = Engine.open(store, EngineOptions())
    with pytest.raises(ErrNotFound):
        eng3.get(ids[6])


def test_orphan_gc_age_gate():
    """Regression (round-1 advisor, medium): open-time orphan GC deleted
    young unreferenced blobs — racing an in-flight commit of another writer."""
    store = MemoryStore()
    eng = new_engine(store)
    eng.insert_batch(tu.gaussian_vectors(10, D, seed=53))
    eng.commit()
    eng.close()
    # Simulate another writer mid-commit: segment blob PUT, manifest not yet.
    store.put("segment_999999.vgt", b"in-flight")
    Engine.open(store, EngineOptions())  # default grace: must NOT delete
    assert store.exists("segment_999999.vgt")
    # With grace disabled the orphan is reclaimed (old behavior, opt-in).
    Engine.open(store, EngineOptions(orphan_gc_grace_s=0.0))
    assert not store.exists("segment_999999.vgt")


def test_close_writes_pk_sidecar_not_manifest():
    """close() must not rewrite the immutable MANIFEST blob in place; the PK
    checkpoint pointer lives in the PKCURRENT sidecar."""
    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(25, D, seed=54)
    ids = eng.insert_batch(x)
    eng.insert_batch((x[3] * 2.0)[None, :], ids=[ids[3]])  # dirty chain
    eng.commit()
    ver = eng._version
    manifest_before = store.get(f"MANIFEST-{ver:06d}.json")
    eng.close()
    assert store.get(f"MANIFEST-{ver:06d}.json") == manifest_before
    assert store.exists("PKCURRENT")
    eng2 = Engine.open(store, EngineOptions())
    # Checkpoint actually used: multi-version chain survives verbatim.
    c = eng2.get(ids[3])
    np.testing.assert_allclose(c.vector, x[3] * 2.0, rtol=1e-6)
    # vacuum keeps the sidecar-referenced checkpoint blob.
    eng2.vacuum()
    assert store.exists(f"pk_{ver:06d}.ckpt")


def test_bulk_insert_fast_path_interop():
    """The vectorized bulk-insert path (PK blocks + memtable slabs) must
    interoperate with updates, deletes, flush remapping and recovery."""
    store = MemoryStore()
    eng = new_engine(store)
    x = tu.gaussian_vectors(500, D, seed=60)
    ids = eng.insert_batch(x, [{"i": i} for i in range(500)])  # bulk path
    assert ids == list(range(ids[0], ids[0] + 500))
    # point ops against block-backed ids
    c = eng.get(ids[123])
    np.testing.assert_allclose(c.vector, x[123], rtol=1e-6)
    assert eng.delete(ids[7])
    upd = x[9] * 0.5 + 1.0
    eng.insert_batch(upd[None, :], ids=[ids[9]])  # slow path update
    # flush: block remaps MEMTABLE -> flat segment
    eng.commit()
    np.testing.assert_allclose(eng.get(ids[9]).vector, upd, rtol=1e-6)
    with pytest.raises(ErrNotFound):
        eng.get(ids[7])
    res = eng.search(x[200], k=3)
    assert res[0].id == ids[200]
    # scan yields blocks + chains consistently
    seen = {c.id for c in eng.scan()}
    assert ids[7] not in seen and ids[9] in seen and len(seen) == 499
    # second bulk batch + compaction remap of blocks
    ids2 = eng.insert_batch(x * 2.0)
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])
    np.testing.assert_allclose(eng.get(ids2[3]).vector, x[3] * 2.0, rtol=1e-6)
    np.testing.assert_allclose(eng.get(ids[9]).vector, upd, rtol=1e-6)
    # recovery without checkpoint: blocks rebuilt from segments
    eng2 = Engine.open(store, EngineOptions())
    assert eng2.stats()["live_rows"] == 999
    np.testing.assert_allclose(eng2.get(ids[9]).vector, upd, rtol=1e-6)
    with pytest.raises(ErrNotFound):
        eng2.get(ids[7])


def test_hamming_metric_end_to_end():
    """Hamming as an engine-level metric (reference: distance.go:66-73
    MetricHamming): 0/1 vectors, exact bit-count distances, full lifecycle."""
    rng = np.random.default_rng(61)
    x = (rng.random((300, 64)) < 0.5).astype(np.float32)
    eng = new_engine(dim=64, metric=Metric.HAMMING)
    ids = eng.insert_batch(x)
    q = x[17].copy()
    q[:5] = 1.0 - q[:5]  # flip 5 bits
    res = eng.search(q, k=3)
    assert res[0].id == ids[17]
    assert abs(res[0].distance - 5.0) < 1e-3  # exact bit count
    eng.commit()  # through a flat segment too
    res = eng.search(q, k=3)
    assert res[0].id == ids[17] and abs(res[0].distance - 5.0) < 1e-3
    # non-binary input rejected
    with pytest.raises(ErrInvalidVector):
        eng.insert_batch(np.full((1, 64), 0.5, np.float32))
    # self-distance is zero
    assert eng.search(x[3], k=1)[0].distance == 0.0


def test_stats_depth_and_observer_surface():
    """nodes_visited / distance_computations populated; observer receives
    search duration + memtable status + queue depth (round-1 gaps)."""
    from vecgo.engine.metrics import CountingObserver

    obs = CountingObserver()
    eng = new_engine(graph_threshold=200, compaction_threshold=2, observer=obs)
    x = tu.gaussian_vectors(600, D, seed=62)
    eng.insert_batch(x[:300]); eng.commit()
    eng.insert_batch(x[300:]); eng.commit()  # compaction -> vamana
    assert any(s["kind"] == "vamana" for s in eng.stats()["segments"])
    res = eng.search(x[0], k=5, with_stats=True)
    st = res.stats
    assert st.nodes_visited > 0  # graph expansions counted
    assert st.distance_computations > st.rows_considered  # batch-aware
    assert obs.counters.get("searches", 0) >= 1
    assert obs.timings.get("search_s", 0) > 0  # duration now reported
    assert "memtable_rows" in obs.counters  # on_memtable_status called
    # The vamana compaction above is an index build (reference: OnBuild,
    # engine/metrics.go:29).
    assert obs.counters.get("builds", 0) >= 1
    assert obs.counters.get("compactions", 0) >= 1


def test_structured_logging(caplog):
    import logging

    eng = new_engine(logger=logging.getLogger("t_vg"))
    x = tu.gaussian_vectors(50, D, seed=63)
    with caplog.at_level(logging.INFO, logger="t_vg"):
        eng.insert_batch(x)
        eng.commit()
    msgs = " ".join(r.message for r in caplog.records)
    assert "commit: version=" in msgs


def test_explicit_id_bulk_ingest():
    """Fresh sorted explicit ids ride the vectorized bulk path; updates and
    unsorted ids fall back to the per-row MVCC path with identical semantics."""
    eng = new_engine()
    x = tu.gaussian_vectors(300, D, seed=71)
    ids = eng.insert_batch(x[:200], ids=np.arange(1000, 1200))
    assert ids == list(range(1000, 1200))
    assert np.allclose(eng.get(1199).vector, x[199])
    # overlapping ids = update semantics (fallback path)
    eng.insert_batch(x[200:203], ids=[1000, 1001, 1002])
    assert np.allclose(eng.get(1000).vector, x[200])
    # unsorted explicit ids also fall back, still correct
    eng.insert_batch(x[203:206], ids=[5000, 4000, 4500])
    assert np.allclose(eng.get(4000).vector, x[204])
    # auto-ids continue past the explicit range
    nid = eng.insert_batch(x[206:208])
    assert min(nid) > 5000
    eng.commit()
    res = eng.search(x[199], k=1)
    assert res.candidates[0].id == 1199


def test_search_arrays_matches_search_batch(monkeypatch):
    """search_arrays (pipelined bulk path) returns the same ids as
    search_batch, including across the chunked (>CHUNK_B) route. CHUNK_B is
    pinned small so the chunked route is exercised without a 2x4096-query
    batch (the production default sizes chunks for HBM amortization)."""
    from vecgo.engine import search as search_mod

    monkeypatch.setattr(search_mod, "CHUNK_B", 1024)
    eng = new_engine()
    x = tu.gaussian_vectors(3000, D, seed=81)
    eng.insert_batch(x)
    eng.commit()
    eng.insert_batch(tu.gaussian_vectors(50, D, seed=82))  # memtable source too
    q = tu.gaussian_vectors(2 * search_mod.CHUNK_B + 64, D, seed=83)
    ids_a, d_a = eng.search_arrays(q, k=5)
    res = eng.search_batch(q[:32], k=5)
    got = np.asarray([[c.id for c in r.candidates] for r in res])
    assert (ids_a[:32] == got).all()
    assert np.isfinite(d_a[:32]).all()


def test_search_arrays_stream_matches_sync():
    """search_arrays_stream (inter-batch pipelined serving) yields exactly the
    synchronous per-batch results, in order, across segment + memtable
    sources — including an empty and an odd-sized batch."""
    eng = new_engine()
    x = tu.gaussian_vectors(2500, D, seed=84)
    eng.insert_batch(x)
    eng.commit()
    eng.insert_batch(tu.gaussian_vectors(40, D, seed=85))  # memtable source
    rng = np.random.default_rng(86)
    batches = [
        tu.gaussian_vectors(int(b), D, seed=87 + i)
        for i, b in enumerate(rng.integers(1, 96, size=7))
    ]
    # a genuinely empty batch must ride the pipeline too
    batches.insert(3, np.zeros((0, D), np.float32))
    outs = list(eng.search_arrays_stream(iter(batches), k=5, depth=3))
    assert len(outs) == len(batches)
    for qb, (ids_s, d_s) in zip(batches, outs):
        ids_a, d_a = eng.search_arrays(qb, k=5)
        assert (ids_s == ids_a).all()
        assert np.allclose(d_s, d_a, equal_nan=True)
    # a stream also works on a fully empty engine (empty plan per batch)
    eng2 = new_engine()
    (ids_e, d_e), = list(eng2.search_arrays_stream([batches[0]], k=3))
    assert (ids_e == -1).all() and np.isinf(d_e).all()


def test_bulk_explicit_ids_toctou_recheck(monkeypatch):
    """ADVICE r2: the explicit-id bulk freshness gate re-runs under the engine
    lock; a race that lands the same ids between gate and lock must divert to
    the per-row MVCC path (no duplicate PK blocks)."""
    eng = new_engine()
    x = tu.gaussian_vectors(20, D, seed=11)
    eng.insert_batch(x, ids=list(range(100, 120)))

    # Simulate the race: the pre-lock gate sees the ids as fresh (False),
    # the under-lock recheck sees the truth.
    real = eng.pk.contains_any_sorted
    calls = {"n": 0}

    def flaky(ids):
        calls["n"] += 1
        if calls["n"] == 1:
            return False  # pre-lock gate lies, as if the ids landed after it
        return real(ids)

    monkeypatch.setattr(eng.pk, "contains_any_sorted", flaky)
    y = tu.gaussian_vectors(20, D, seed=12)
    eng.insert_batch(y, ids=list(range(100, 120)))
    assert calls["n"] >= 2  # recheck actually ran under the lock
    # Updates won: each id resolves to the NEW vector, exactly once.
    res = eng.search(y[0], k=1)
    assert res[0].id == 100 and res[0].distance < 1e-5
    got = eng.search(y[5], k=40)
    assert sum(1 for c in got if c.id == 105) == 1


def test_update_churn_visibility_margin():
    """ADVICE r2: with many dirty (updated) ids, stale duplicates must not
    displace valid neighbors out of a fixed merge window."""
    eng = new_engine()
    x = tu.gaussian_vectors(200, D, seed=21)
    ids = eng.insert_batch(x)
    eng.commit()  # freeze into a segment
    # Re-insert 50 ids with IDENTICAL vectors: every one becomes a dirty id
    # whose stale segment row ties the fresh memtable row at the same distance.
    upd = list(range(0, 50))
    eng.insert_batch(x[upd], ids=[ids[i] for i in upd])
    q = x[10]
    res = eng.search(q, k=20)
    got = [c.id for c in res]
    assert len(got) == 20
    assert len(set(got)) == 20  # no duplicates
    _, true_ids = tu.brute_force_knn(q[None], x, 20, "l2")
    expect = {ids[j] for j in true_ids[0]}
    # All true neighbors present (no displacement by stale copies).
    assert set(got) == expect


def test_close_checkpoint_excludes_uncommitted(tmp_path):
    """A PK checkpoint taken at Close must reflect only committed state: ids
    updated AFTER the last commit would otherwise resolve to memtable rows
    that no longer exist on reopen (crash model: lose since last Commit)."""
    from vecgo.blobstore import LocalStore

    store = LocalStore(str(tmp_path))
    eng = new_engine(store)
    x = tu.gaussian_vectors(100, D, seed=31)
    ids = eng.insert_batch(x)
    eng.commit()
    # Uncommitted churn: updates + a delete + fresh inserts after the commit.
    eng.insert_batch(x[:10] + 1.0, ids=ids[:10])
    eng.delete(ids[50])
    eng.insert_batch(tu.gaussian_vectors(5, D, seed=32))
    eng.close()

    eng2 = new_engine(store)  # reopens from checkpoint (same manifest version)
    # Pre-churn state is fully visible again.
    c = eng2.get(ids[0])
    np.testing.assert_allclose(c.vector, x[0], rtol=1e-6)
    assert eng2.get(ids[50]).id == ids[50]  # uncommitted delete rolled back
    res = eng2.search(x[0], k=5)
    assert res[0].id == ids[0] and res[0].distance < 1e-5


def test_compaction_slab_moves_docs_payloads():
    """VERDICT r2 #8: compaction moves docs/payload/metadata as vectorized
    slabs; content must survive byte-identical, filters intact."""
    eng = new_engine(compaction_threshold=1000)  # manual compact
    x1 = tu.gaussian_vectors(300, D, seed=61)
    x2 = tu.gaussian_vectors(300, D, seed=62)
    mk = lambda i, tag: {
        "i": i, "tag": f"t{i % 7}", "flag": bool(i % 2), "arr": [f"a{i % 3}", "z"],
    }
    p1 = [bytes([i % 251]) * (i % 97) for i in range(300)]
    ids1 = eng.insert_batch(x1, [mk(i, "a") for i in range(300)], payloads=p1)
    eng.commit()
    p2 = [b"payload-%d" % i if i % 3 else None for i in range(300)]
    ids2 = eng.insert_batch(x2, [mk(i + 300, "b") for i in range(300)], payloads=p2)
    eng.commit()
    # churn: delete every 10th id of the first segment
    for i in range(0, 300, 10):
        eng.delete(ids1[i])
    out = eng.compact([h.seg_id for h in eng._segments])
    assert out is not None

    for i in range(300):
        if i % 10 == 0:
            with pytest.raises(ErrNotFound):
                eng.get(ids1[i])
            continue
        c = eng.get(ids1[i])
        assert c.metadata == mk(i, "a")
        assert (c.payload or b"") == p1[i]
    for i in range(300):
        c = eng.get(ids2[i])
        assert c.metadata == mk(i + 300, "b")
        assert c.payload == p2[i] or (c.payload is None and not p2[i])
    # Filters over merged interned columns still work.
    from vecgo.metadata import contains
    res = eng.search(x2[30], k=10, filter=eq("tag", "t1"))
    assert res and all(c.metadata["tag"] == "t1" for c in res)
    res = eng.search(x1[8], k=10, filter=contains("arr", "a2"))
    assert res and all("a2" in c.metadata["arr"] for c in res)
    res = eng.search(x1[8], k=10, filter=gt("i", 500))
    assert res and all(c.metadata["i"] > 500 for c in res)


def test_memtable_slab_chain_mixed_inserts():
    """Slab-chain memtable: per-row tail + bulk slabs interleave; views,
    gathers, chunked search, and flush export stay consistent."""
    from vecgo.engine.memtable import MemTable
    from vecgo.model import Metric

    mt = MemTable(8, Metric.L2)
    rng = np.random.default_rng(1)
    a = rng.random((7, 8), dtype=np.float32)
    for i in range(7):
        mt.insert(a[i], id=i + 1, lsn=i + 1)
    b = rng.random((9000, 8), dtype=np.float32)
    mt.insert_block(b, id0=100, lsn0=100)
    c = rng.random((5, 8), dtype=np.float32)
    for i in range(5):
        mt.insert(c[i], id=20000 + i, lsn=20000 + i)
    d = rng.random((50, 8), dtype=np.float32)
    mt.insert_block(d, id0=30000, lsn0=30000)
    n = len(mt)
    assert n == 7 + 9000 + 5 + 50
    full = np.concatenate([a, b, c, d])
    # row views across slab boundaries
    np.testing.assert_allclose(mt.rows_view(5, 12), full[5:12], rtol=1e-6)
    np.testing.assert_allclose(
        mt.rows_view(9000, 9015), full[9000:9015], rtol=1e-6
    )
    # per-row access + gather
    for r in (0, 6, 7, 9006, 9007, 9011, 9012, n - 1):
        np.testing.assert_allclose(mt.vector(r), full[r], rtol=1e-6)
    rows = np.array([0, 7, 9000, 9007, 9012, n - 1])
    np.testing.assert_allclose(mt._gather(rows), full[rows], rtol=1e-6)
    # export_live with deletions
    mt.mark_deleted(3, lsn=99999)
    live, vecs, ids, lsns, docs, pays = mt.export_live()
    assert len(live) == n - 1 and 3 not in set(live.tolist())
    np.testing.assert_allclose(vecs, full[live], rtol=1e-6)
    # chunked device search sees every region
    import jax.numpy as jnp

    q = jnp.asarray(full[9012][None])
    dd, rr = mt.search(q, 1, n)
    assert int(np.asarray(rr)[0, 0]) == 9012


def test_engine_serve_compact_recall():
    """serve_compact: the engine serves graph segments from the repacked
    (one-slot-per-row) coded table with recall intact."""
    eng = new_engine(graph_threshold=4096, serve_compact=True)
    x, _ = tu.clustered_vectors(9000, D, n_clusters=32, seed=71)
    ids = eng.insert_batch(x)
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])
    seg = eng._segments[-1].segment
    assert seg.__class__.__name__ == "VamanaSegment" and seg.serve_compact
    t = seg.device_state()["ivfq"]
    live = np.asarray(t.rows)
    assert (live >= 0).sum() == 9000  # one slot per row
    q = x[123]
    res = eng.search(q, k=10)
    _, ti = tu.brute_force_knn(q[None], x, 10, "l2")
    want = {ids[j] for j in ti[0]}
    got = {c.id for c in res}
    assert len(got & want) >= 9, (got, want)


@pytest.mark.slow
def test_filtered_graph_recall_mid_selectivity():
    """Engine-level filtered GRAPH search at mid selectivity (VERDICT r3 #6;
    reference: dynamic EF expansion hnsw.go:1858-1895, filtered recall 1.000
    baseline.txt:34-37): one graph segment of 200k rows, a ~45%-selectivity
    metadata filter (above the 30% brute cutoff, so the mask rides the graph
    path), recall@10 >= 0.95 vs masked ground truth. Exercises the
    selectivity-adaptive ef widening in engine/search.py."""
    from vecgo.metadata import lt

    n, d = 200_000, 24
    rng_l = np.random.default_rng(29)
    x, _ = tu.clustered_vectors(n, d, n_clusters=128, seed=29)
    cats = rng_l.integers(0, 100, n)
    eng = new_engine(dim=d, graph_threshold=50_000)
    ids = eng.insert_batch(x, metadatas=[{"cat": int(c)} for c in cats])
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])
    seg = eng._segments[-1].segment
    assert seg.__class__.__name__ == "VamanaSegment" and seg.n == n

    elig = cats < 45  # ~45% selectivity: graph path, not brute
    assert 0.35 <= elig.mean() <= 0.60
    nq = 64
    q = x[rng_l.choice(n, nq, replace=False)] + 0.05 * rng_l.standard_normal(
        (nq, d)
    ).astype(np.float32)
    ids_arr = np.asarray(ids, np.int64)
    # masked ground truth (exact over eligible rows only)
    _, ti = tu.brute_force_knn(q, x[elig], 10, "l2")
    gt_ids = ids_arr[np.flatnonzero(elig)][ti]

    out_ids, _ = eng.search_arrays(q, k=10, filter=lt("cat", 45))
    out_ids = np.asarray(out_ids)
    # every hit satisfies the filter
    pos = {int(i): j for j, i in enumerate(ids_arr)}
    for b in range(nq):
        for i in out_ids[b]:
            if int(i) >= 0:
                assert cats[pos[int(i)]] < 45
    rec = np.mean([
        len(set(map(int, out_ids[b])) & set(map(int, gt_ids[b]))) / 10
        for b in range(nq)
    ])
    assert rec >= 0.95, f"filtered graph recall {rec:.4f} < 0.95"

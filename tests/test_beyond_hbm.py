"""Beyond-HBM tier: streaming scans under a device residency budget
(reference: lazy block reads diskann/segment.go:1151, two-tier cache
engine.go:425-477, memory backpressure engine.go:446-450)."""

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore
from vecgo.engine import Engine, EngineOptions
from vecgo.errors import ErrBackpressure
from vecgo.utils import testutil as tu

D = 24


def _mk(store=None, **kw):
    kw.setdefault("dim", D)
    kw.setdefault("flush_threshold", 10_000_000)
    kw.setdefault("graph_threshold", 10**9)
    return Engine.open(store or MemoryStore(), EngineOptions(**kw), create=True)


def test_streaming_equals_resident_flat():
    x = tu.gaussian_vectors(3000, D, seed=70)
    q = tu.gaussian_vectors(8, D, seed=71)
    e1 = _mk()
    ids = e1.insert_batch(x)
    e1.commit()
    want = [[c.id for c in r] for r in e1.search_batch(q, k=10)]
    # Budget smaller than any segment: every search must stream.
    e2 = _mk(hbm_budget_bytes=1024)
    e2.insert_batch(x)
    e2.commit()
    got = [[c.id for c in r] for r in e2.search_batch(q, k=10)]
    assert got == want
    st = e2.stats()["hbm"]
    assert st["resident"] == 0 and st["used_bytes"] == 0


def test_streaming_pq_transport_flat():
    """PQ stream transport (d/2 B/row H2D) must match the resident engine's
    results: the coarser coded ordering is repaired by the 4x pool + exact
    host rerank (engine/search.py flat_stream branch)."""
    x, _ = tu.clustered_vectors(3000, D, n_clusters=12, seed=170)
    q = tu.gaussian_vectors(8, D, seed=171)
    e1 = _mk()
    e1.insert_batch(x)
    e1.commit()
    want = [[c.id for c in r] for r in e1.search_batch(q, k=10)]
    e2 = _mk(hbm_budget_bytes=1024, stream_transport="pq")
    e2.insert_batch(x)
    e2.commit()
    got = [[c.id for c in r] for r in e2.search_batch(q, k=10)]
    # exact-tie rows may swap order under different pool widths; compare sets
    # per query with identical leading (untied) prefixes via distances
    assert all(set(g) == set(w) for g, w in zip(got, want))
    st = e2.stats()["hbm"]
    assert st["resident"] == 0 and st["used_bytes"] == 0


def test_streaming_pq_transport_vamana():
    """PQ transport on a beyond-HBM graph segment (graph_stream source)."""
    x, _ = tu.clustered_vectors(3000, D, n_clusters=16, seed=172)
    e = _mk(
        graph_threshold=2000, compaction_threshold=2, hbm_budget_bytes=1024,
        stream_transport="pq",
    )
    ids = e.insert_batch(x[:1500])
    e.commit()
    e.insert_batch(x[1500:])
    e.commit()  # compaction -> vamana segment over budget
    kinds = {s["kind"] for s in e.stats()["segments"]}
    assert "vamana" in kinds
    q = x[7:15]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = [[c.id for c in r] for r in e.search_batch(q, k=10)]
    want = [[ids[0] + j for j in row] for row in ti]
    assert all(set(g) == set(w) for g, w in zip(got, want))


def test_streaming_quantized_flat_with_filter():
    x = tu.gaussian_vectors(2000, D, seed=72)
    from vecgo.metadata import eq as md_eq

    mds = [{"cat": f"c{i % 3}"} for i in range(2000)]
    e1 = _mk(quantizer="sq8")
    ids = e1.insert_batch(x, mds)
    e1.commit()
    q = tu.gaussian_vectors(4, D, seed=73)
    want = [[c.id for c in r] for r in e1.search_batch(q, k=5, filter=md_eq("cat", "c1"))]
    e2 = _mk(quantizer="sq8", hbm_budget_bytes=1024)
    e2.insert_batch(x, mds)
    e2.commit()
    got = [[c.id for c in r] for r in e2.search_batch(q, k=5, filter=md_eq("cat", "c1"))]
    assert got == want


def test_streaming_vamana_brute_fallback():
    x, _ = tu.clustered_vectors(3000, D, n_clusters=16, seed=74)
    e = _mk(graph_threshold=2000, compaction_threshold=2, hbm_budget_bytes=1024)
    ids = e.insert_batch(x[:1500])
    e.commit()
    e.insert_batch(x[1500:])
    e.commit()  # compaction -> vamana segment over budget
    kinds = {s["kind"] for s in e.stats()["segments"]}
    assert "vamana" in kinds
    q = x[7:15]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    res = e.search_batch(q, k=10)
    got = [[c.id for c in r] for r in res]
    want = [[ids[0] + j for j in row] for row in ti]
    assert got == want  # streaming brute fallback is exact


def test_lru_eviction_between_segments():
    from vecgo.engine.resource import DeviceBudget

    x = tu.gaussian_vectors(4000, D, seed=75)
    e = _mk(compaction_threshold=10**9)
    e.insert_batch(x[:2000]); e.commit()
    e.insert_batch(x[2000:]); e.commit()
    seg_bytes = e._segments[0].segment.device_bytes()
    # Budget fits exactly one segment: searches alternate residency.
    e._device_budget = DeviceBudget(int(seg_bytes * 1.5))
    q = tu.gaussian_vectors(4, D, seed=76)
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = [[c.id for c in r] for r in e.search_batch(q, k=10)]
    base = e._segments[0].segment.ids[0]
    # ids assigned contiguously from first insert
    first_id = min(int(s.segment.ids.min()) for s in e._segments)
    want = [[first_id + j for j in row] for row in ti]
    assert got == want
    st = e._device_budget.stats()
    assert st["resident"] <= 1 and st["evictions"] >= 1


def test_memory_backpressure():
    e = _mk(memory_limit_bytes=10_000)
    x = tu.gaussian_vectors(200, D, seed=77)
    with pytest.raises(ErrBackpressure):
        e.insert_batch(x)  # 200 * (24*4+64) = 32k > 10k
    e2 = _mk(memory_limit_bytes=10_000_000)
    e2.insert_batch(x)
    e2.commit()
    assert e2.stats()["memtable_bytes"] == 0  # drained on flush

"""Cross-package E2E (reference: integration_test/ — mixed segments, edge
cases, quantization recall through the engine)."""

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore
from vecgo.engine import Engine, EngineOptions
from vecgo.index.vamana import VamanaSegment
from vecgo.index.flat import FlatSegment
from vecgo.metadata import eq
from vecgo.utils import testutil as tu

D = 24


def test_mixed_flat_and_vamana_segments():
    """reference: integration_test/mixed_test.go:20 — search across memtable +
    flat + graph segments must merge correctly."""
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D,
            flush_threshold=10**9,
            graph_threshold=800,  # compactions of >=800 rows become vamana
            compaction_threshold=100,  # no auto compaction
            graph_r=16,
            graph_l_build=32,
        ),
        create=True,
    )
    x = tu.gaussian_vectors(2000, D, seed=111)
    ids1 = eng.insert_batch(x[:1000], [{"part": "a"} for _ in range(1000)])
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])  # -> vamana segment
    assert isinstance(eng._segments[0].segment, VamanaSegment)
    ids2 = eng.insert_batch(x[1000:1500], [{"part": "b"} for _ in range(500)])
    eng.commit()  # -> flat segment
    kinds = {type(h.segment) for h in eng._segments}
    assert kinds == {VamanaSegment, FlatSegment}
    ids3 = eng.insert_batch(x[1500:], [{"part": "c"} for _ in range(500)])  # memtable

    all_ids = np.asarray(ids1 + ids2 + ids3)
    q = tu.gaussian_vectors(8, D, seed=112)
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = [[c.id for c in r] for r in eng.search_batch(q, k=10, ef=96)]
    want = [[int(all_ids[j]) for j in row] for row in ti]
    rec = tu.recall_at_k(np.asarray(got), np.asarray(want))
    assert rec >= 0.9, rec
    # filtered across all three sources
    res = eng.search(q[0], k=5, filter=eq("part", "c"))
    assert all(c.metadata["part"] == "c" for c in res)


@pytest.mark.parametrize("quantizer,qparams", [("sq8", {}), ("pq", {"m": 6})])
def test_quantized_engine_recall(quantizer, qparams):
    """reference: integration_test/quantization_recall_test.go:17 — recall
    floors through the full engine with rerank."""
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D, flush_threshold=10**9, graph_threshold=1 << 40,
            quantizer=quantizer, qparams=qparams,
        ),
        create=True,
    )
    x, _ = tu.clustered_vectors(3000, D, n_clusters=16, spread=0.1, seed=113)
    ids = eng.insert_batch(x)
    eng.commit()
    q = x[:16] + 0.02 * np.random.default_rng(114).standard_normal((16, D)).astype(np.float32)
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = [[c.id for c in r] for r in eng.search_batch(q, k=10, refine_factor=5)]
    want = [[ids[j] for j in row] for row in ti]
    rec = tu.recall_at_k(np.asarray(got), np.asarray(want))
    assert rec >= 0.9, f"{quantizer}: {rec}"


def test_edge_cases():
    """reference: integration_test/edge_case_test.go — zero vectors, duplicate
    vectors, k > corpus, empty search."""
    eng = Engine.open(
        MemoryStore(), EngineOptions(dim=D, flush_threshold=10**9), create=True
    )
    # empty db search
    res = eng.search(np.ones(D, np.float32), k=5)
    assert len(res) == 0
    # zero vector is valid
    zid = eng.insert(np.zeros(D, np.float32))
    # duplicates are all returned
    v = np.ones(D, np.float32)
    dup_ids = eng.insert_batch(np.stack([v, v, v]))
    res = eng.search(v, k=10)
    assert len(res) == 4  # 3 dups + zero vector
    assert {c.id for c in res[:3]} == set(dup_ids)
    # k > live rows clamps
    res = eng.search(np.zeros(D, np.float32), k=100)
    assert len(res) == 4 and res[0].id == zid
    # max-ish dimension roundtrip
    eng2 = Engine.open(
        MemoryStore(), EngineOptions(dim=4096, flush_threshold=10**9), create=True
    )
    big = np.random.default_rng(1).standard_normal((3, 4096)).astype(np.float32)
    ids = eng2.insert_batch(big)
    eng2.commit()
    assert eng2.search(big[1], k=1)[0].id == ids[1]


def test_compaction_to_vamana_preserves_payloads_metadata():
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D, flush_threshold=10**9, graph_threshold=500,
            compaction_threshold=100, graph_r=12, graph_l_build=24,
        ),
        create=True,
    )
    x = tu.gaussian_vectors(600, D, seed=115)
    ids = eng.insert_batch(
        x,
        [{"i": i} for i in range(600)],
        [f"pl-{i}".encode() for i in range(600)],
    )
    eng.commit()
    eng.compact([h.seg_id for h in eng._segments])
    assert isinstance(eng._segments[0].segment, VamanaSegment)
    c = eng.get(ids[123])
    assert c.metadata == {"i": 123}
    assert c.payload == b"pl-123"
    res = eng.search(x[77], k=1, ef=64)
    assert res[0].id == ids[77] and res[0].payload == b"pl-77"


def test_subprocess_compact_worker(tmp_path):
    """Writer/reader separation: `python -m vecgo.tools.compact` merges
    segments in a SEPARATE process over a shared Local store; the serving
    process reopens the new version (reference: vecgo.go:151-179 writer +
    stateless read replicas)."""
    import json as _json
    import os
    import subprocess
    import sys

    from vecgo.blobstore import LocalStore

    d = str(tmp_path / "db")
    eng = Engine.open(
        LocalStore(d),
        EngineOptions(
            dim=D, flush_threshold=10**9, graph_threshold=500,
            graph_r=12, graph_l_build=24,
        ),
        create=True,
    )
    x = tu.gaussian_vectors(700, D, seed=211)
    ids = eng.insert_batch(x[:400], [{"i": i} for i in range(400)])
    eng.commit()
    ids += eng.insert_batch(x[400:], [{"i": 400 + i} for i in range(300)])
    eng.commit()
    assert len(eng._segments) == 2
    eng.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "vecgo.tools.compact", d, "--all",
         "--graph-threshold", "500", "--graph-r", "12",
         "--graph-l-build", "24"],
        capture_output=True, text=True, timeout=600, cwd=repo,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = _json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rows"] == 700 and out["segment"] == "VamanaSegment"

    eng2 = Engine.open(LocalStore(d), EngineOptions())
    assert len(eng2._segments) == 1
    assert isinstance(eng2._segments[0].segment, VamanaSegment)
    res = eng2.search(x[55], k=1, ef=64)
    assert res[0].id == ids[55] and res[0].metadata == {"i": 55}
    eng2.close()

"""Flat segment + container + metadata filter tests
(reference: internal/segment/flat/*_test.go, engine/fuzz_test.go)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vecgo.errors import ErrCorrupt
from vecgo.index.flat import FlatWriter, FlatSegment, bloom_may_contain
from vecgo.metadata import eq, gt, gte, isin, contains, lt, Op, Filter, FilterSet
from vecgo.metadata.columnar import ColumnarMeta
from vecgo.model import Metric
from vecgo.storage import container
from vecgo.utils import testutil as tu

N, D, K = 2000, 32, 10


def build_segment(quantizer="none", ivf=0, metric=Metric.L2, n=N):
    x = tu.gaussian_vectors(n, D, seed=21)
    w = FlatWriter(D, metric, quantizer=quantizer, ivf_partitions=ivf)
    for i in range(n):
        md = {"num": float(i), "cat": f"cat_{i % 5}", "tags": [f"t{i % 3}", "all"]}
        w.add(x[i], 1000 + i, md, payload=f"payload-{i}".encode() if i % 2 == 0 else None)
    data = w.finish()
    return x, FlatSegment.open(data)


def test_container_roundtrip():
    meta = {"hello": [1, 2, 3], "nested": {"a": "b"}}
    secs = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "u8": np.frombuffer(b"bytes", np.uint8),
        "empty": np.zeros((0, 5), np.int32),
    }
    blob = container.pack_container(meta, secs)
    meta2, secs2 = container.unpack_container(blob)
    assert meta2 == meta
    for k in secs:
        np.testing.assert_array_equal(secs[k], secs2[k])


def test_container_rejects_corruption():
    blob = bytearray(container.pack_container({"m": 1}, {"a": np.ones(100, np.float32)}))
    blob[-10] ^= 0xFF  # flip a data byte
    with pytest.raises(ErrCorrupt):
        container.unpack_container(bytes(blob))
    with pytest.raises(ErrCorrupt):
        container.unpack_container(b"NOPE" + bytes(blob[4:]))


def test_container_fuzz_never_panics():
    """Adversarial bytes must raise ErrCorrupt, never crash
    (reference: FuzzFlatSegmentOpen, engine/fuzz_test.go:45)."""
    r = np.random.default_rng(99)
    base = container.pack_container({"kind": "flat"}, {"a": np.ones(64, np.float32)})
    for trial in range(200):
        data = bytearray(base)
        for _ in range(r.integers(1, 8)):
            data[r.integers(0, len(data))] = r.integers(0, 256)
        try:
            container.unpack_container(bytes(data))
        except ErrCorrupt:
            pass  # expected
        # random bytes entirely
        try:
            container.unpack_container(bytes(r.integers(0, 256, size=200, dtype=np.uint8)))
        except ErrCorrupt:
            pass


def test_flat_exact_search_recall():
    x, seg = build_segment()
    q = tu.gaussian_vectors(8, D, seed=22)
    d, rows = seg.search(jnp.asarray(q), K)
    _, true_ids = tu.brute_force_knn(q, x, K, "l2")
    assert tu.recall_at_k(np.asarray(rows), true_ids) > 0.999
    # ids map back
    assert int(seg.ids[int(np.asarray(rows)[0, 0])]) == 1000 + int(true_ids[0, 0])


@pytest.mark.parametrize("quantizer", ["sq8", "pq"])
def test_flat_quantized_with_rerank(quantizer):
    x, seg = build_segment(quantizer=quantizer)
    q = tu.gaussian_vectors(8, D, seed=23)
    d, rows = seg.search(jnp.asarray(q), 5 * K)
    rd = seg.rerank(jnp.asarray(q), rows)
    order = np.argsort(np.asarray(rd), axis=1)[:, :K]
    final = np.take_along_axis(np.asarray(rows), order, axis=1)
    _, true_ids = tu.brute_force_knn(q, x, K, "l2")
    assert tu.recall_at_k(final, true_ids) > 0.9


def test_flat_ivf_probes():
    x, seg = build_segment(ivf=16)
    q = tu.gaussian_vectors(8, D, seed=24)
    _, true_ids = tu.brute_force_knn(q, x, K, "l2")
    # Full probe = exact. NOTE: rows are IVF-reordered; compare via ids.
    d, rows = seg.search(jnp.asarray(q), K, nprobes=16)
    got_ids = seg.ids[np.maximum(np.asarray(rows), 0)].astype(np.int64) - 1000
    assert tu.recall_at_k(got_ids, true_ids) > 0.999
    # nprobes=4 should still find most
    d4, rows4 = seg.search(jnp.asarray(q), K, nprobes=4)
    got4 = seg.ids[np.maximum(np.asarray(rows4), 0)].astype(np.int64) - 1000
    assert tu.recall_at_k(got4, true_ids) > 0.5


def test_flat_cosine_metric():
    x, seg = build_segment(metric=Metric.COSINE)
    q = tu.gaussian_vectors(8, D, seed=25)
    d, rows = seg.search(jnp.asarray(q), K)
    _, true_ids = tu.brute_force_knn(q, x, K, "cosine")
    assert tu.recall_at_k(np.asarray(rows), true_ids) > 0.999


def test_flat_filtered_search_equivalence():
    """Pre-filter mask must equal brute-force-over-eligible
    (reference: engine filtering_equivalence_test.go)."""
    x, seg = build_segment()
    q = tu.gaussian_vectors(4, D, seed=26)
    mask = seg.filter_mask(eq("cat", "cat_2"))
    assert mask.sum() == N // 5
    d, rows = seg.search(jnp.asarray(q), K, mask=mask)
    rows = np.asarray(rows)
    assert mask[rows].all()
    eligible = np.flatnonzero(mask)
    _, ti = tu.brute_force_knn(q, x[eligible], K, "l2")
    assert tu.recall_at_k(rows, eligible[ti]) > 0.999


def test_metadata_filters():
    docs = [
        {"n": 1, "s": "a", "b": True, "tags": ["x", "y"]},
        {"n": 2.5, "s": "b", "b": False, "tags": ["y"]},
        {"n": -3, "s": "a", "tags": []},
        None,
        {"s": "c"},
    ]
    cm = ColumnarMeta.from_docs(docs)
    np.testing.assert_array_equal(cm.filter_mask(eq("s", "a")), [1, 0, 1, 0, 0])
    np.testing.assert_array_equal(cm.filter_mask(gt("n", 0)), [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(cm.filter_mask(gte("n", -3)), [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(cm.filter_mask(lt("n", 2)), [1, 0, 1, 0, 0])
    np.testing.assert_array_equal(cm.filter_mask(isin("s", ["a", "c"])), [1, 0, 1, 0, 1])
    np.testing.assert_array_equal(cm.filter_mask(contains("tags", "y")), [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(cm.filter_mask(eq("b", True)), [1, 0, 0, 0, 0])
    np.testing.assert_array_equal(
        cm.filter_mask(eq("s", "a") & gt("n", 0)), [1, 0, 0, 0, 0]
    )
    np.testing.assert_array_equal(cm.filter_mask(Filter("missing", Op.EQ, 1)), [0] * 5)
    # selectivity is exact
    assert cm.selectivity(eq("s", "a")) == pytest.approx(2 / 5)


def test_metadata_columnar_roundtrip():
    docs = [{"n": i, "s": f"v{i%3}", "tags": [f"t{i%2}"]} for i in range(50)]
    cm = ColumnarMeta.from_docs(docs)
    meta, secs = cm.to_sections()
    cm2 = ColumnarMeta.from_sections(meta, secs)
    f = isin("s", ["v0", "v2"]) & gt("n", 10)
    np.testing.assert_array_equal(cm.filter_mask(f), cm2.filter_mask(f))
    assert cm2._doc_from_columns(7) == {"n": 7, "s": "v1", "tags": ["t1"]}


def test_fetch_and_payload():
    x, seg = build_segment()
    assert seg.payload(0) == b"payload-0"
    assert seg.payload(1) is None
    assert seg.doc(5)["cat"] == "cat_0"
    np.testing.assert_allclose(seg.vector(3), x[3], rtol=1e-6)
    rows = list(seg.iterate())
    assert len(rows) == N and rows[10][0] == 1010


def test_segment_stats_and_bloom():
    _, seg = build_segment(n=500)
    stats = seg.meta["stats"]
    assert stats["row_count"] == 500
    assert stats["fields"]["num"]["min"] == 0.0
    assert stats["fields"]["num"]["max"] == 499.0
    bloom = stats["fields"]["cat"]["bloom"]
    assert bloom_may_contain(bloom, "cat_3")
    assert not bloom_may_contain(bloom, "definitely_absent_value")


def test_compressed_segment_roundtrip():
    """Optional section compression (reference: diskann/compression.go LZ4/ZSTD)."""
    x = tu.gaussian_vectors(500, D, seed=27)
    w = FlatWriter(D, Metric.L2, compress="deflate")
    for i in range(500):
        w.add(x[i], i, {"c": i % 3})
    data = w.finish()
    seg = FlatSegment.open(data)
    q = tu.gaussian_vectors(4, D, seed=28)
    d, rows = seg.search(jnp.asarray(q), 5)
    _, ti = tu.brute_force_knn(q, x, 5, "l2")
    assert tu.recall_at_k(np.asarray(rows), ti) > 0.999
    # corruption of compressed payload is detected
    blob = bytearray(data)
    blob[-20] ^= 0xFF
    with pytest.raises(ErrCorrupt):
        FlatSegment.open(bytes(blob))

"""Cluster-granular device cache (ops/ivf_cache): beyond-HBM coded serving.

Reference analogue: lazy block reads + block cache
(diskann/segment.go:1151, internal/cache/types.go:22-43).
"""

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore
from vecgo.engine import Engine, EngineOptions
from vecgo.ops import ivf as ivf_ops
from vecgo.ops.ivf_cache import ClusterCachedTable
from vecgo.utils import testutil as tu

D = 32


def _recall(got_rows, want_rows):
    hits = sum(
        len(set(map(int, g[g >= 0])) & set(map(int, w)))
        for g, w in zip(got_rows, want_rows)
    )
    return hits / (len(want_rows) * len(want_rows[0]))


def test_cached_scan_matches_full_table():
    """With the cache sized to hold every probed cluster, probe_and_scan
    returns the same segment rows as the fully-resident coded scan."""
    import jax.numpy as jnp

    x, _ = tu.clustered_vectors(4000, D, n_clusters=16, seed=80)
    rng = np.random.default_rng(81)
    q = (x[rng.choice(len(x), 16, replace=False)]
         + 0.02 * rng.standard_normal((16, D))).astype(np.float32)
    _, members = ivf_ops.build_ivf_table(x, capacity=256, seed=82)
    k = members.shape[0]

    table = ivf_ops.device_table_coded(members, jnp.asarray(x))
    d_ref, r_ref = ivf_ops.ivf_scan(
        jnp.asarray(q), table, n_probe=4, kk=8, qcap=16
    )
    cc = ClusterCachedTable(members, x, cache_clusters=k + 8)
    d_c, r_c = cc.probe_and_scan(q, n_probe=4, kk=8, qcap=16)
    r_ref, r_c = np.asarray(r_ref), np.asarray(r_c)
    # Same per-query candidate sets (host encode vs device encode can round
    # int8 codes differently on exact-half ties; compare sets, allow ulp-level
    # distance differences).
    for b in range(len(q)):
        ref = set(map(int, r_ref[b][r_ref[b] >= 0]))
        got = set(map(int, r_c[b][r_c[b] >= 0]))
        inter = len(ref & got) / max(1, len(ref))
        assert inter >= 0.95, (b, ref ^ got)
    np.testing.assert_allclose(
        np.sort(np.asarray(d_c), axis=1)[:, :8],
        np.sort(np.asarray(d_ref), axis=1)[:, :8],
        rtol=2e-3, atol=2e-3,
    )

    # Second identical batch: pure cache hits, no new H2D.
    h2d_before = cc.stats["h2d_bytes"]
    cc.probe_and_scan(q, n_probe=4, kk=8, qcap=16)
    assert cc.stats["h2d_bytes"] == h2d_before
    assert cc.stats["misses"] > 0 and cc.stats["hits"] > 0
    assert cc.stats["dropped_probes"] == 0


def test_cached_scan_small_cache_lru():
    """A cache much smaller than the table still serves (LRU churn), keeps
    device_bytes fixed, and reports misses; recall degrades gracefully."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=24, seed=83)
    rng = np.random.default_rng(84)
    q = (x[rng.choice(len(x), 12, replace=False)]
         + 0.02 * rng.standard_normal((12, D))).astype(np.float32)
    _, members = ivf_ops.build_ivf_table(x, capacity=256, seed=85)
    k = members.shape[0]
    assert k > 16
    cc = ClusterCachedTable(members, x, cache_clusters=16, group=8)
    d1, r1 = cc.probe_and_scan(q, n_probe=4, kk=8)
    assert cc.stats["misses"] > 0
    # Device arrays never grow past the configured cache.
    assert cc.codes_c.shape[0] == cc.c <= 16 + 8
    # Exact host rerank of the pooled candidates still finds true neighbors.
    _, ti = tu.brute_force_knn(q, x, 5, "l2")
    r1 = np.asarray(r1)
    rec = _recall(r1, ti)
    assert rec >= 0.5, rec  # probes beyond the tiny cache are dropped


def test_cached_scan_row_mask():
    x, _ = tu.clustered_vectors(3000, D, n_clusters=12, seed=86)
    rng = np.random.default_rng(87)
    q = x[rng.choice(len(x), 8, replace=False)].astype(np.float32)
    _, members = ivf_ops.build_ivf_table(x, capacity=256, seed=88)
    cc = ClusterCachedTable(members, x, cache_clusters=members.shape[0] + 8)
    mask = np.zeros(len(x), bool)
    mask[::2] = True
    _, rows = cc.probe_and_scan(q, n_probe=6, kk=8, row_mask=mask)
    rows = np.asarray(rows)
    assert (rows[rows >= 0] % 2 == 0).all()


def test_engine_beyond_hbm_uses_cluster_cache():
    """Budget between cache_bytes and full residency: the planner serves the
    vamana segment through the cluster cache (graph_cached), not the
    full-corpus streaming scan; results stay near-exact after host rerank."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=89)
    # (VamanaWriter only writes the IVF serving table at n >= 4096)
    e1 = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D, flush_threshold=10_000_000, graph_threshold=2000,
            compaction_threshold=2,
        ),
        create=True,
    )
    ids = e1.insert_batch(x[:3000])
    e1.commit()
    e1.insert_batch(x[3000:])
    e1.commit()  # compaction merges into one vamana segment
    seg = e1._segments[0].segment
    assert seg.__class__.__name__ == "VamanaSegment"
    assert seg.ivf_members is not None
    full = seg.device_bytes()
    cache = seg.cache_bytes()
    assert cache < full, (cache, full)

    budget = (cache + full) // 2
    e2 = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D, flush_threshold=10_000_000, graph_threshold=2000,
            compaction_threshold=2, hbm_budget_bytes=budget,
        ),
        create=True,
    )
    ids2 = list(e2.insert_batch(x[:3000]))
    e2.commit()
    ids2 += list(e2.insert_batch(x[3000:]))
    e2.commit()
    q = x[5:21]
    res = e2.search_batch(q, k=10)
    seg2 = e2._segments[0].segment
    assert seg2._ccache is not None and seg2._ccache.stats["batches"] > 0
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = np.asarray(
        [[c.id for c in r] + [-1] * (10 - len(r)) for r in res]
    )
    want = np.asarray([[ids2[j] for j in row] for row in ti])
    assert tu.recall_at_k(got, want) >= 0.9
    e1.close()
    e2.close()


class _CountingStore(MemoryStore):
    """MemoryStore that meters ranged-read traffic (the cloud-tier bytes)."""

    def __init__(self):
        super().__init__()
        self.range_bytes = 0
        self.full_gets = 0

    def get_range(self, name, offset, length):
        self.range_bytes += length
        self._in_range = True
        try:
            return super().get_range(name, offset, length)
        finally:
            self._in_range = False

    def get(self, name):
        # MemoryStore.get_range delegates to get() internally; count only
        # EXTERNAL whole-object reads (the anti-pattern the cloud tier avoids).
        if not getattr(self, "_in_range", False):
            self.full_gets += 1
        return super().get(name)


def _coded_blob(x, seed=90, kind=True):
    from vecgo.index.vamana import VamanaWriter

    w = VamanaWriter(x.shape[1], store_codes=kind, ivf_capacity=256, seed=seed)
    w.add_batch(x, np.arange(len(x)))
    return w.finish()


def test_store_codes_cloud_serving_is_block_granular():
    """A codes-stored segment opened from a remote store serves WITHOUT ever
    reading its vectors or full code table: the open skips both sections, and
    a query batch reads only the probed cluster blocks + the reranked rows
    (reference: diskann lazy block reads, segment.go:1151)."""
    from vecgo.index.vamana import VamanaSegment
    from vecgo.ops.ivf_cache import LazyHostTable

    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=91)
    blob = _coded_blob(x)
    st = _CountingStore()
    st.put("seg.vgt", blob)

    seg = VamanaSegment.open_lazy(st, "seg.vgt")
    open_bytes = st.range_bytes
    assert seg._vectors_arr is None  # vectors deferred
    vec_bytes = x.nbytes
    assert open_bytes < len(blob) - vec_bytes  # skipped vectors AND codes

    q = x[5:21]
    _, rows = seg.search_cached(q, 10)
    d_exact = np.asarray(seg.rerank_host(q, np.asarray(rows)))
    serve_bytes = st.range_bytes - open_bytes
    assert serve_bytes < vec_bytes  # O(blocks), not O(corpus)
    assert st.full_gets == 0
    assert isinstance(seg._ccache.host, LazyHostTable)
    assert seg._vectors_arr is None  # rerank gathered rows, not the section

    order = np.argsort(d_exact, axis=1)
    got = np.take_along_axis(np.asarray(rows), order, 1)[:, :10]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    assert tu.recall_at_k(got, ti) >= 0.9

    # Warm cache: the same batch re-reads nothing from the store.
    before = st.range_bytes
    seg.search_cached(q, 10)
    assert st.range_bytes == before


def test_store_codes_lazy_rerank_matches_memory():
    """Deferred-row rerank (ranged gathers) == in-memory rerank, bit-for-bit
    on the same candidate rows."""
    from vecgo.index.vamana import VamanaSegment

    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=92)
    blob = _coded_blob(x, seed=93)
    st = MemoryStore()
    st.put("seg.vgt", blob)
    lazy_seg = VamanaSegment.open_lazy(st, "seg.vgt")
    full_seg = VamanaSegment.open(blob)

    rng = np.random.default_rng(94)
    q = x[rng.choice(len(x), 8, replace=False)]
    rows = rng.integers(0, len(x), (8, 12)).astype(np.int32)
    rows[0, :3] = -1  # invalid markers must stay +inf
    d_lazy = np.asarray(lazy_seg.rerank_host(q, rows))
    d_full = np.asarray(full_seg.rerank_host(q, rows))
    assert lazy_seg._vectors_arr is None
    np.testing.assert_array_equal(np.isinf(d_lazy), np.isinf(d_full))
    np.testing.assert_allclose(d_lazy, d_full, rtol=1e-6, atol=1e-6)


def test_store_codes_local_open_skips_reencode():
    """A local (bytes) open of a codes-stored segment builds its cluster
    cache from the persisted sections (MemHostTable over ivfq.*), not a
    fresh host encode — and serves the same candidates."""
    from vecgo.index.vamana import VamanaSegment
    from vecgo.ops.ivf_cache import MemHostTable

    x, _ = tu.clustered_vectors(5000, D, n_clusters=12, seed=95)
    blob = _coded_blob(x, seed=96)
    seg = VamanaSegment.open(blob)
    assert seg._ivfq is not None
    cc = seg.cluster_cache()
    assert isinstance(cc.host, MemHostTable)
    assert cc.host._codes is seg._ivfq["codes"]  # zero-copy, no re-encode

    q = x[:8]
    _, rows = seg.search_cached(q, 10)
    d_exact = np.asarray(seg.rerank_host(q, np.asarray(rows)))
    got = np.take_along_axis(
        np.asarray(rows), np.argsort(d_exact, axis=1), 1
    )[:, :10]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    assert tu.recall_at_k(got, ti) >= 0.9


def test_store_codes_pq_transport_economics():
    """PQ/OPQ transport: same serving recall as SQ8 transport (the exact
    rerank over a widened pool repairs the coarser coded ordering) at ~3x
    fewer store-read and H2D bytes — the reference's PQ compression axis
    (quantization/pq.go; codes-resident serving segment.go:503-708), recast
    as transport compression for the cloud/cache tier."""
    from vecgo.index.vamana import VamanaSegment

    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=91)
    q = x[5:21]
    _, ti = tu.brute_force_knn(q, x, 10, "l2")

    def serve(kind, kk):
        st = MemoryStore()
        st.put("s", _coded_blob(x, seed=7, kind=kind))
        seg = VamanaSegment.open_lazy(st, "s")
        _, rows = seg.search_cached(q, kk)
        rows = np.asarray(rows)
        de = np.asarray(seg.rerank_host(q, rows))
        got = np.take_along_axis(rows, np.argsort(de, 1), 1)[:, :10]
        cc = seg._ccache
        assert seg._vectors_arr is None
        return (
            tu.recall_at_k(got, ti),
            cc.stats["h2d_bytes"],
            cc.host.store_bytes,
        )

    rec8, h2d8, sb8 = serve("sq8", 40)
    for kind in ("pq", "opq"):
        rec, h2d, sb = serve(kind, 160)  # engine widens fetch 4x for pq
        assert rec >= rec8 - 0.05, (kind, rec, rec8)
        assert h2d * 2.5 < h2d8, (kind, h2d, h2d8)
        assert sb * 2.5 < sb8, (kind, sb, sb8)


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_engine_store_codes_cloud_reopen(kind):
    """Engine-level cloud story: compaction persists codes; a REOPEN from the
    (remote) store defers vectors and serves the over-budget graph segment
    through store-fed cluster blocks at near-exact recall."""
    x, _ = tu.clustered_vectors(6000, D, n_clusters=16, seed=97)
    st = _CountingStore()
    opts = EngineOptions(
        dim=D, flush_threshold=10_000_000, graph_threshold=2000,
        compaction_threshold=2, store_codes=kind,
    )
    e1 = Engine.open(st, opts, create=True)
    ids = list(e1.insert_batch(x[:3000]))
    e1.commit()
    ids += list(e1.insert_batch(x[3000:]))
    e1.commit()
    seg = e1._segments[0].segment
    assert (seg.meta.get("ivf") or {}).get("codes_stored")
    budget = (seg.cache_bytes() + seg.device_bytes()) // 2
    e1.close()

    st.range_bytes = 0
    st.full_gets = 0
    opts2 = EngineOptions(dim=D, hbm_budget_bytes=budget)
    e2 = Engine.open(st, opts2)
    seg2 = e2._segments[0].segment
    assert seg2._vectors_arr is None
    q = x[5:21]
    res = e2.search_batch(q, k=10)
    assert seg2._ccache is not None and seg2._ccache.stats["batches"] > 0
    assert seg2._vectors_arr is None  # never materialized
    # Total store traffic (open: graph/ids/norms + serve: cluster blocks +
    # rerank rows) stays well under the blob — the vectors and full code
    # table never moved.
    blob_len = len(st.get(e2._segments[0].info.name))
    assert st.range_bytes < blob_len - x.nbytes
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    got = np.asarray([[c.id for c in r] + [-1] * (10 - len(r)) for r in res])
    want = np.asarray([[ids[j] for j in row] for row in ti])
    # Both transports sit at this corpus's probe-coverage ceiling (~0.89-0.9
    # at auto probes); pq trades a point of it for 4x fewer bytes.
    assert tu.recall_at_k(got, want) >= (0.9 if kind == "sq8" else 0.85)
    e2.close()


def test_container_load_rows_adversarial():
    """Malformed header entries must raise ErrCorrupt (or KeyError for an
    unknown section), never crash or return out-of-range data — the
    container's fuzz contract extended to ranged row reads."""
    import json
    import struct

    from vecgo.errors import ErrCorrupt
    from vecgo.storage import container

    a = np.arange(40, dtype=np.float32).reshape(10, 4)
    blob = container.pack_container({"m": 1}, {"a": a})

    def mutate(fn):
        # Rebuild the blob around a doctored header (both adversarial cases
        # below must fail on the short/absent payload read, so payload bytes
        # are intentionally not laid back down).
        meta, entries = container.parse_header(blob)
        for e in entries:
            fn(e)
        header = json.dumps({"meta": meta, "sections": entries}).encode()
        out = b"VGT1" + struct.pack("<IQ", 0, len(header)) + header
        st = MemoryStore()
        st.put("c", out)
        return container.LazyContainer(st, "c")

    lc = mutate(lambda e: e.update(offset=len(blob) + 64))
    try:
        lc.load_rows("a", 0, 10)
        raise AssertionError("expected ErrCorrupt for out-of-range offset")
    except ErrCorrupt:
        pass
    lc = mutate(lambda e: e.update(shape=[10, 1 << 40]))
    try:
        lc.load_rows("a", 0, 1)
        raise AssertionError("expected ErrCorrupt for absurd row size")
    except (ErrCorrupt, MemoryError):
        pass
    lc = container.LazyContainer(
        (lambda s: (s.put("c", blob), s)[1])(MemoryStore()), "c"
    )
    try:
        lc.load_rows("missing", 0, 1)
        raise AssertionError("expected KeyError")
    except KeyError:
        pass


def test_container_load_rows():
    """Ranged row reads of a section == full-load slices; compressed sections
    fall back to a correct full-load path."""
    from vecgo.storage import container

    rng = np.random.default_rng(98)
    a = rng.standard_normal((100, 7)).astype(np.float32)
    b = np.zeros((50, 3, 4), np.int8)  # compressible: deflate pass keeps it
    b[::7] = 3
    for compress in (None, "deflate"):
        blob = container.pack_container({"x": 1}, {"a": a, "b": b}, compress)
        st = MemoryStore()
        st.put("c", blob)
        lc = container.LazyContainer(st, "c")
        np.testing.assert_array_equal(lc.load_rows("a", 10, 20), a[10:20])
        np.testing.assert_array_equal(lc.load_rows("b", 0, 50), b)
        np.testing.assert_array_equal(lc.load_rows("b", 49, 99), b[49:])
        assert lc.load_rows("a", 5, 5).shape == (0, 7)

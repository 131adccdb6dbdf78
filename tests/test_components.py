"""Tests for caches, cloud stores, policies, metrics, resource controller,
WriteBatch, background loops (reference: internal/cache, blobstore/s3,
engine/policy.go, engine/metrics.go, internal/resource, engine/batch.go)."""

import threading
import time

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore
from vecgo.blobstore.s3 import DDBCommitStore, S3ExpressStore, S3Store
from vecgo.engine import Engine, EngineOptions
from vecgo.engine.metrics import CountingObserver
from vecgo.engine.policy import (
    BoundedSizeTieredPolicy,
    LeveledPolicy,
    SegmentView,
    SizeTieredPolicy,
)
from vecgo.engine.resource import Controller, RateLimiter
from vecgo.errors import ErrBackpressure, ErrConflict, ErrNotFound
from vecgo.storage.cache import (
    CachingStore,
    DiskCache,
    LRUCache,
    ShardedLRUCache,
    TieredCache,
)
from vecgo.utils import testutil as tu

D = 8


# ---------------- caches ----------------


def test_lru_eviction_and_stats():
    c = LRUCache(100)
    c.put("a", b"x" * 40)
    c.put("b", b"y" * 40)
    assert c.get("a") == b"x" * 40
    c.put("c", b"z" * 40)  # evicts b (a was touched)
    assert c.get("b") is None
    assert c.get("a") is not None
    st = c.stats()
    assert st["used_bytes"] <= 100 and st["hits"] == 2 and st["misses"] == 1


def test_sharded_lru_concurrent():
    c = ShardedLRUCache(1 << 20, shards=8)
    errs = []

    def worker(t):
        try:
            for i in range(200):
                c.put((t, i), bytes([t]) * 10)
                assert c.get((t, i)) == bytes([t]) * 10
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs


def test_disk_cache_recovery(tmp_path):
    dc = DiskCache(str(tmp_path), 1 << 20)
    dc.put(("f", 0), b"hello")
    assert dc.get(("f", 0)) == b"hello"
    dc2 = DiskCache(str(tmp_path), 1 << 20)  # directory-scan recovery
    assert dc2.get(("f", 0)) == b"hello"


def test_tiered_and_caching_store(tmp_path):
    inner = MemoryStore()
    tier = TieredCache(LRUCache(1 << 20), DiskCache(str(tmp_path), 1 << 20))
    cs = CachingStore(inner, cache=tier, block_size=8)
    cs.put("blob", b"0123456789abcdef")
    assert cs.get("blob") == b"0123456789abcdef"
    # serve from cache even after inner deletion (read-through semantics):
    # the generation-stamped block is still resident
    inner.delete("blob")
    assert cs.cache.get(("blob", cs._generation("blob"), 0)) == b"01234567"


def test_caching_store_invalidation():
    """Regression (round-1 advisor, low): mutable blobs (CURRENT, rewritten
    MANIFESTs) were cached forever — read replicas never saw new versions."""
    inner = MemoryStore()
    cs = CachingStore(inner, cache=LRUCache(1 << 20), block_size=8)
    # CURRENT bypasses the cache entirely.
    cs.put("CURRENT", b"1")
    assert cs.get("CURRENT") == b"1"
    inner.put("CURRENT", b"2")  # another writer swings the pointer
    assert cs.get("CURRENT") == b"2"
    # Regular names: put() through this store invalidates older generations.
    cs.put("seg", b"a" * 16)
    assert cs.get("seg") == b"a" * 16
    cs.put("seg", b"bb")  # fewer blocks than before
    assert cs.get("seg") == b"bb"
    # delete() drops cached blocks too.
    cs.delete("seg")
    cs.put("seg", b"cc")
    assert cs.get("seg") == b"cc"


def test_caching_store_with_engine():
    inner = MemoryStore()
    cs = CachingStore(inner, cache=ShardedLRUCache(1 << 24), block_size=1 << 16)
    eng = Engine.open(cs, EngineOptions(dim=D, flush_threshold=10**9), create=True)
    x = tu.gaussian_vectors(50, D, seed=91)
    ids = eng.insert_batch(x)
    eng.commit()
    eng2 = Engine.open(cs, EngineOptions())
    assert eng2.search(x[1], k=1)[0].id == ids[1]


# ---------------- cloud stores (fake client) ----------------


class FakeS3Client:
    def __init__(self):
        self.objects = {}

    def put_object(self, Bucket, Key, Body, IfNoneMatch=None):
        if IfNoneMatch == "*" and Key in self.objects:
            e = Exception("precondition")
            e.response = {"Error": {"Code": "PreconditionFailed"}}
            raise e
        self.objects[Key] = bytes(Body)

    def get_object(self, Bucket, Key, Range=None):
        if Key not in self.objects:
            e = Exception("missing")
            e.response = {"Error": {"Code": "NoSuchKey"}}
            raise e
        body = self.objects[Key]
        if Range:  # "bytes=a-b" inclusive
            a, b = Range.split("=")[1].split("-")
            body = body[int(a) : int(b) + 1]
        return {"Body": body}

    def head_object(self, Bucket, Key):
        if Key not in self.objects:
            e = Exception("missing")
            e.response = {"Error": {"Code": "NotFound"}}
            raise e
        return {"ContentLength": len(self.objects[Key])}

    def delete_object(self, Bucket, Key):
        self.objects.pop(Key, None)

    def list_objects_v2(self, Bucket, Prefix="", **kw):
        return {
            "Contents": [{"Key": k} for k in sorted(self.objects) if k.startswith(Prefix)],
            "IsTruncated": False,
        }


def test_s3_store_crud():
    s3 = S3Store(FakeS3Client(), "bucket", prefix="db1")
    s3.put("a.bin", b"data")
    assert s3.get("a.bin") == b"data"
    assert s3.size("a.bin") == 4
    assert s3.list() == ["a.bin"]
    with pytest.raises(ErrNotFound):
        s3.get("missing")
    s3.delete("a.bin")
    assert s3.list() == []


def test_s3_express_cas():
    s3 = S3ExpressStore(FakeS3Client(), "bucket")
    s3.put_if_not_exists("CURRENT", b"1")
    with pytest.raises(ErrConflict):
        s3.put_if_not_exists("CURRENT", b"2")


class FakeDDB:
    def __init__(self):
        self.items = {}

    def put_item(self, TableName, Item, ConditionExpression=None,
                 ExpressionAttributeValues=None):
        key = Item["db"]["S"]
        cur = self.items.get(key)
        if ConditionExpression == "attribute_not_exists(db)" and cur is not None:
            e = Exception("conditional")
            e.response = {"Error": {"Code": "ConditionalCheckFailedException"}}
            raise e
        if ConditionExpression == "version = :prev":
            prev = int(ExpressionAttributeValues[":prev"]["N"])
            if cur is None or int(cur["version"]["N"]) != prev:
                e = Exception("conditional")
                e.response = {"Error": {"Code": "ConditionalCheckFailedException"}}
                raise e
        self.items[key] = Item

    def get_item(self, TableName, Key):
        item = self.items.get(Key["db"]["S"])
        return {"Item": item} if item else {}


def test_ddb_commit_store_cas():
    ddb = DDBCommitStore(FakeDDB(), "commits", "mydb")
    assert ddb.current_version() is None
    ddb.commit_version(1, expect_previous=None)
    ddb.commit_version(2, expect_previous=1)
    with pytest.raises(ErrConflict):
        ddb.commit_version(3, expect_previous=1)  # lost race
    assert ddb.current_version() == 2


# ---------------- policies ----------------


def test_size_tiered_policy():
    p = SizeTieredPolicy(threshold=3)
    segs = [SegmentView(i, 0, 100, 100) for i in range(3)]
    assert sorted(p.pick(segs)) == [0, 1, 2]
    segs = [SegmentView(0, 0, 100, 100), SegmentView(1, 0, 100_000, 100_000)]
    assert p.pick(segs) is None
    # tombstone-driven rewrite
    segs = [SegmentView(0, 0, 100, 50)]
    assert p.pick(segs) == [0]


def test_bounded_policy_caps_merge():
    p = BoundedSizeTieredPolicy(threshold=3, max_merge_rows=250)
    segs = [SegmentView(i, 0, 100, 100) for i in range(4)]
    picked = p.pick(segs)
    assert picked is not None and len(picked) == 2


def test_leveled_policy():
    p = LeveledPolicy(base_rows=100, fanout=10, max_level_segments=2)
    segs = [SegmentView(i, 0, 100, 100) for i in range(3)]  # too many at L0
    picked = p.pick(segs)
    assert sorted(picked) == [0, 1, 2]
    segs = [SegmentView(0, 0, 100, 100), SegmentView(1, 1, 500, 500)]
    assert p.pick(segs) is None


def test_engine_with_leveled_policy():
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D,
            flush_threshold=10**9,
            graph_threshold=1 << 40,
            compaction_policy=LeveledPolicy(base_rows=50, max_level_segments=2),
        ),
        create=True,
    )
    x = tu.gaussian_vectors(150, D, seed=92)
    for s in range(0, 150, 50):
        eng.insert_batch(x[s : s + 50])
        eng.commit()
    assert len(eng._segments) <= 2
    assert eng.search(x[0], k=1)[0].distance < 1e-5


# ---------------- metrics / resource ----------------


def test_counting_observer_wired():
    obs = CountingObserver()
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(dim=D, flush_threshold=10**9, observer=obs),
        create=True,
    )
    x = tu.gaussian_vectors(20, D, seed=93)
    ids = eng.insert_batch(x)
    eng.delete(ids[0])
    eng.search(x[1], k=2)
    eng.get(ids[2])
    eng.commit()
    eng.get(ids[3])  # post-commit: segment-resident point lookup
    assert obs.counters["inserts"] == 20
    assert obs.counters["deletes"] == 1
    assert obs.counters["searches"] == 1
    assert obs.counters["flushes"] == 1
    assert obs.counters["gets"] == 2  # reference: OnGet (engine/metrics.go)


def test_resource_controller_backpressure():
    c = Controller(memory_limit_bytes=100)
    c.acquire(60)
    with pytest.raises(ErrBackpressure):
        c.acquire(50)
    c.release(60)
    c.acquire(50)


def test_rate_limiter():
    rl = RateLimiter(bytes_per_s=10_000, burst=1000)
    t0 = time.monotonic()
    rl.throttle(1000)  # burst covers it
    assert time.monotonic() - t0 < 0.05
    rl.throttle(2000)  # must refill to the burst gate (~0.1s) and go into debt
    assert time.monotonic() - t0 > 0.09
    t1 = time.monotonic()
    rl.throttle(500)  # pays down the debt first
    assert time.monotonic() - t1 > 0.09


# ---------------- write batch / background ----------------


def test_write_batch_atomic():
    eng = Engine.open(
        MemoryStore(), EngineOptions(dim=D, flush_threshold=10**9), create=True
    )
    x = tu.gaussian_vectors(10, D, seed=94)
    ids = eng.insert_batch(x[:5])
    wb = eng.write_batch()
    for i in range(5, 10):
        wb.insert(x[i], {"i": i})
    wb.delete(ids[0])
    new_ids = wb.apply()
    assert len(new_ids) == 5
    assert eng.stats()["live_rows"] == 9
    assert eng.search(x[7], k=1)[0].id == new_ids[2]


def test_background_flush_compact():
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D,
            flush_threshold=40,
            auto_flush=False,  # only the background thread flushes
            flush_interval_s=0.05,
            graph_threshold=1 << 40,
        ),
        create=True,
    )
    eng.start_background()
    x = tu.gaussian_vectors(100, D, seed=95)
    eng.insert_batch(x)
    deadline = time.time() + 10
    while time.time() < deadline and eng.stats()["memtable_rows"] > 0:
        time.sleep(0.1)
    st = eng.stats()
    assert st["memtable_rows"] == 0 and st["segment_rows"] == 100
    eng.close()  # stops background threads
    assert eng.search is not None


def test_manifest_store_ddb_commit_plane():
    """VERDICT r2 #10: DDBCommitStore wired into ManifestStore.save — two
    concurrent writers racing the same next version: one commits, one gets
    ErrConflict (reference: ddb_commit_store.go:105-172)."""
    from vecgo.blobstore import MemoryStore
    from vecgo.engine.manifest import Manifest, ManifestStore

    ddb = FakeDDB()
    blob = MemoryStore()
    w1 = ManifestStore(blob, commit_store=DDBCommitStore(ddb, "commits", "db1"))
    w2 = ManifestStore(blob, commit_store=DDBCommitStore(ddb, "commits", "db1"))
    assert not w1.exists()
    m = Manifest(version=0, lsn=0, next_id=1, next_seg_id=1)
    w1.save(m)
    assert w1.exists() and w2.current_version() == 0

    # Both writers observe version 0 and race to commit version 1.
    m1 = Manifest(version=1, lsn=5, next_id=9, next_seg_id=2)
    w1.save(m1, expect_version=0)
    import pytest as _pytest

    from vecgo.errors import ErrConflict as _EC

    m2 = Manifest(version=2, lsn=6, next_id=9, next_seg_id=2)
    with _pytest.raises(_EC):
        w2.save(m2, expect_version=0)  # stale view: DDB is at 1
    assert w2.current_version() == 1
    # The loser's manifest blob is an orphan; the winner's history is intact.
    assert w2.load(1).lsn == 5


class CountingStore:
    """Wraps a BlobStore; counts bytes actually fetched from it."""

    def __init__(self, inner):
        self.inner = inner
        self.bytes_read = 0
        self.range_calls = 0
        self.full_gets = 0

    def get(self, name):
        data = self.inner.get(name)
        self.full_gets += 1
        self.bytes_read += len(data)
        return data

    def get_range(self, name, offset, length):
        out = self.inner.get_range(name, offset, length)
        self.range_calls += 1
        self.bytes_read += len(out)
        return out

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def test_caching_store_ranged_reads_are_block_granular():
    """VERDICT r2 #6: a partial read through CachingStore must fetch O(block)
    bytes from the inner store, never the whole object
    (reference: blobstore/caching_store.go:13-69)."""
    from vecgo.blobstore import MemoryStore
    from vecgo.storage.cache import CachingStore, LRUCache

    inner = MemoryStore()
    blob = bytes(range(256)) * 4096  # 1 MiB
    inner.put("seg", blob)
    counted = CountingStore(inner)
    cs = CachingStore(counted, cache=LRUCache(64 * 1024 * 1024), block_size=4096)

    out = cs.get_range("seg", 10_000, 100)
    assert out == blob[10_000:10_100]
    assert counted.full_gets == 0
    assert counted.bytes_read <= 2 * 4096  # the covering block(s) only

    # Cache hit: second read costs the inner store nothing.
    before = counted.bytes_read
    assert cs.get_range("seg", 10_016, 64) == blob[10_016:10_080]
    assert counted.bytes_read == before

    # Block-boundary straddle.
    assert cs.get_range("seg", 4090, 16) == blob[4090:4106]
    # Tail clamp.
    assert cs.get_range("seg", len(blob) - 8, 100) == blob[-8:]


def test_lazy_segment_open_defers_docs_payload():
    """Remote opens pull the header + hot sections only; docs/payload load on
    first access, via ranged reads (reference: diskann segment.go:1151)."""
    import json as _json

    from vecgo.blobstore import MemoryStore
    from vecgo.index.flat import FlatSegment, FlatWriter
    from vecgo.model import Metric

    w = FlatWriter(dim=8, metric=Metric.L2)
    rng = np.random.default_rng(3)
    big_payload = b"x" * 100_000
    for i in range(50):
        w.add(rng.random(8).astype(np.float32), id=i + 1,
              metadata={"i": i}, payload=big_payload if i == 7 else None)
    data = w.finish()

    inner = MemoryStore()
    inner.put("seg", data)
    counted = CountingStore(inner)
    seg = FlatSegment.open_lazy(counted, "seg", seg_id=1)
    opened_bytes = counted.bytes_read
    assert opened_bytes < len(data) - 90_000  # payload blob not fetched
    assert seg.n == 50 and seg.doc(3) == {"i": 3}

    # First payload touch fetches the payload sections, once.
    assert seg.payload(7) == big_payload
    assert seg.payload(8) is None
    assert counted.bytes_read >= opened_bytes + 100_000


def test_cloud_open_fetches_blocks_not_objects():
    """Remote engine open through a CachingStore: opening a segment reads the
    header + hot sections as ranged block fetches; docs/payload bytes stay on
    the store until first touched (reference: lazy reads via the
    (file,offset)-keyed block cache, cache/types.go:22-43)."""
    import numpy as np

    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.storage.cache import CachingStore, LRUCache

    inner = MemoryStore()
    eng = Engine.open(
        inner, EngineOptions(dim=8, flush_threshold=10**9), create=True
    )
    rng = np.random.default_rng(5)
    x = rng.random((2000, 8), dtype=np.float32)
    big = b"z" * 200_000
    eng.insert_batch(
        x, [{"i": i} for i in range(2000)],
        payloads=[big if i < 4 else None for i in range(2000)],
    )
    eng.commit()
    eng.close()

    counted = CountingStore(inner)
    cs = CachingStore(counted, cache=LRUCache(64 * 1024 * 1024),
                      block_size=16 * 1024)
    eng2 = Engine.open(cs, EngineOptions(dim=8))
    seg_size = inner.size("segment_000001.vgt")
    assert seg_size > 800_000  # payloads dominate the blob
    # Open fetched the hot sections but NOT the payload megabytes.
    assert counted.bytes_read < seg_size - 600_000, (
        counted.bytes_read, seg_size,
    )
    opened = counted.bytes_read
    c = eng2.get(1)
    assert c.payload == big  # first touch pulls payload blocks
    assert counted.bytes_read >= opened + 200_000
    res = eng2.search(x[11], k=3)
    assert res[0].id == 12
    eng2.close()


def test_minio_store_fallback_cas():
    """MinioStore: conditional PUT when supported, exists+put fallback else."""
    from vecgo.blobstore.s3 import MinioStore

    class NoCondClient(FakeS3Client):
        def put_object(self, Bucket, Key, Body, IfNoneMatch=None):
            if IfNoneMatch is not None:
                raise Exception("NotImplemented")  # server ignores conditionals
            return super().put_object(Bucket=Bucket, Key=Key, Body=Body)

    st = MinioStore(NoCondClient(), "bucket")
    st.put_if_not_exists("CURRENT", b"1")
    assert st.get("CURRENT") == b"1"
    with pytest.raises(ErrConflict):
        st.put_if_not_exists("CURRENT", b"2")
    # ranged read rides the S3 Range header path
    st.put("blob", bytes(range(100)))
    assert st.get_range("blob", 10, 5) == bytes(range(10, 15))


def test_hostmem_primitives():
    """Hugepage-advised allocator + allocation-free bulk validation
    (utils/hostmem — the ingest path's page-fault containment)."""
    import numpy as np

    from vecgo.utils.hostmem import all_finite, huge_arange, huge_empty

    a = huge_empty((1000, 7), np.float32)  # small -> np.empty fallback
    assert a.shape == (1000, 7) and a.dtype == np.float32
    b = huge_empty((3 << 20,), np.int8)  # large -> mmap-backed on linux
    b[:] = 3
    assert int(b[-1]) == 3 and b.nbytes == 3 << 20

    r = huge_arange(17, 2_000_003)
    assert r.dtype == np.int64 and len(r) == 2_000_003
    assert int(r[0]) == 17 and int(r[-1]) == 17 + 2_000_002
    assert (np.diff(r[:: 500_000]) == 500_000).all()

    x = np.ones((4096, 16), np.float32)
    assert all_finite(x)
    for bad in (np.nan, np.inf, -np.inf):
        x[4095, 15] = bad
        assert not all_finite(x)
        x[4095, 15] = 0.0
    assert all_finite(np.zeros((0, 4), np.float32))


def test_hostmem_backends_all_modes():
    """Every calibration outcome must produce a correct, writable buffer."""
    import numpy as np

    import vecgo.utils.hostmem as hm

    saved = hm._mode
    try:
        for mode in ("plain", "shared", "private"):
            if mode != "plain" and hm._libc is None:
                continue  # non-linux: only the fallback exists
            hm._mode = mode
            a = hm.huge_empty((4 << 20,), np.uint8)
            a[:] = 9
            assert int(a[0]) == 9 and int(a[-1]) == 9
            f = hm.huge_empty((1 << 20, 4), np.float32)
            f[:] = 2.5
            assert float(f[-1, -1]) == 2.5
    finally:
        hm._mode = saved

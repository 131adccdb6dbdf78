"""ZSTD codec tests (reference: diskann/compression.go ships LZ4 *and* ZSTD;
compression_test.go round-trips; fuzz bar from engine/fuzz_test.go —
adversarial bytes must never crash a decoder)."""

import numpy as np
import pytest

from vecgo.storage import zstd


def _cases():
    rng = np.random.default_rng(5)
    return [
        b"",
        b"a",
        b"abcabcabcabcabcabcabcabcabc" * 40,
        bytes(1000),
        rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes(),  # incompressible
        (np.arange(50_000, dtype=np.int32) % 1000).tobytes(),  # structured
        rng.integers(0, 4, 200_000, dtype=np.uint8).tobytes(),  # multi-block
        b"the quick brown fox jumps over the lazy dog. " * 500,
    ]


@pytest.mark.skipif(not zstd.available(), reason="libzstd not found")
def test_native_roundtrip():
    for raw in _cases():
        for level in (1, 3, 9):
            comp = zstd.compress(raw, level)
            assert zstd.decompress(comp, len(raw)) == raw


@pytest.mark.skipif(not zstd.available(), reason="libzstd not found")
def test_python_decoder_matches_native():
    """The pure-Python RFC 8878 decoder reads libzstd frames — zstd segments
    stay readable on hosts with no libzstd at all (FSE + Huffman + sequences
    all exercised: structured int32 data produces all three)."""
    for raw in _cases():
        for level in (1, 3, 19):
            comp = zstd.compress(raw, level)
            assert zstd._decompress_py(comp, len(raw)) == raw


@pytest.mark.skipif(not zstd.available(), reason="libzstd not found")
def test_adversarial_decompress_never_crashes():
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(0, 200))
        junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for fn in (zstd.decompress, zstd._decompress_py):
            try:
                fn(junk, int(rng.integers(0, 500)))
            except ValueError:
                pass
    raw = _cases()[7]
    comp = bytearray(zstd.compress(raw, 3))
    for cut in (0, 1, 4, len(comp) // 2, len(comp) - 1):
        try:
            zstd._decompress_py(bytes(comp[:cut]), len(raw))
        except ValueError:
            pass
    for i in range(0, len(comp), 7):
        bad = bytearray(comp)
        bad[i] ^= 0xFF
        try:
            out = zstd._decompress_py(bytes(bad), len(raw))
            assert len(out) == len(raw)  # may be wrong bytes; CRC catches it
        except ValueError:
            pass


@pytest.mark.skipif(not zstd.available(), reason="libzstd not found")
def test_compression_ratio_beats_lz4_on_graph_sections():
    """ZSTD entropy-codes where LZ4 only match-codes: padded neighbor lists
    shrink strictly more (the reference offers ZSTD for exactly this
    ratio-over-speed tradeoff, compression.go:15-65)."""
    from vecgo.storage import lz4

    rng = np.random.default_rng(7)
    g = np.full((4000, 32), -1, np.int32)
    for i in range(4000):
        deg = int(rng.integers(4, 24))
        g[i, :deg] = rng.integers(0, 4000, deg)
    raw = g.tobytes()
    comp = zstd.compress(raw, 3)
    assert len(comp) < 0.6 * len(raw)
    if lz4.available():
        assert len(comp) < len(lz4.compress(raw))


def test_container_zstd_roundtrip():
    """pack_container(compress='zstd') round-trips through unpack + lazy rows;
    without libzstd it degrades to deflate transparently."""
    from vecgo.blobstore import MemoryStore
    from vecgo.errors import ErrCorrupt
    from vecgo.storage import container

    rng = np.random.default_rng(13)
    a = (rng.standard_normal((200, 9)) * 8).astype(np.int8)
    b = rng.standard_normal((64, 5)).astype(np.float32)
    blob = container.pack_container({"m": 2}, {"a": a, "b": b}, compress="zstd")
    meta, secs = container.unpack_container(blob)
    assert meta == {"m": 2}
    np.testing.assert_array_equal(secs["a"], a)
    np.testing.assert_array_equal(secs["b"], b)
    st = MemoryStore()
    st.put("c", blob)
    lc = container.LazyContainer(st, "c")
    np.testing.assert_array_equal(lc.load_rows("a", 10, 30), a[10:30])
    bad = bytearray(blob)
    bad[-10] ^= 0x55
    with pytest.raises(ErrCorrupt):
        container.unpack_container(bytes(bad))


@pytest.mark.skipif(not zstd.available(), reason="libzstd not found")
def test_engine_zstd_segments():
    """compress_segments='zstd' end-to-end through commit + reopen."""
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.utils import testutil as tu

    store = MemoryStore()
    eng = Engine.open(
        store,
        EngineOptions(dim=16, flush_threshold=10**9, compress_segments="zstd"),
        create=True,
    )
    x = tu.gaussian_vectors(400, 16, seed=21)
    ids = eng.insert_batch(x)
    eng.commit()
    eng.close()
    eng = Engine.open(store, EngineOptions(dim=16, flush_threshold=10**9))
    hits = eng.search(x[7], k=1)
    assert hits[0].id == ids[7] and hits[0].distance < 1e-5
    eng.close()

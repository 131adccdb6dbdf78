"""Native LZ4 block codec tests (reference: diskann/compression.go LZ4/ZSTD
block compression + compression_test.go round-trips; fuzz bar from
engine/fuzz_test.go — adversarial bytes must never crash a decoder)."""

import numpy as np
import pytest

from vecgo.storage import lz4


def _cases():
    rng = np.random.default_rng(5)
    return [
        b"",
        b"a",
        b"abcabcabcabcabcabcabcabcabc" * 40,
        bytes(1000),  # all zeros: max compressibility
        rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes(),  # incompressible
        (np.arange(50_000, dtype=np.int32) % 1000).tobytes(),  # structured
        rng.integers(0, 4, 100_000, dtype=np.uint8).tobytes(),  # low entropy
        b"x" * 13,  # MFLIMIT boundary
        b"x" * 12,
        b"0123456789ab" + b"0123456789ab" * 100 + bytes(range(256)),
    ]


@pytest.mark.skipif(not lz4.available(), reason="native lz4 codec not built")
def test_native_roundtrip():
    for raw in _cases():
        comp = lz4.compress(raw)
        assert lz4.decompress(comp, len(raw)) == raw


@pytest.mark.skipif(not lz4.available(), reason="native lz4 codec not built")
def test_python_decoder_matches_native():
    """The pure-Python fallback decoder reads native-compressed blocks —
    data stays readable on hosts without a C++ toolchain."""
    for raw in _cases():
        comp = lz4.compress(raw)
        assert lz4._decompress_py(comp, len(raw)) == raw


@pytest.mark.skipif(not lz4.available(), reason="native lz4 codec not built")
def test_compression_ratio_on_graph_sections():
    """Graph-table-like payloads (padded [N, R] int32 neighbor lists with -1
    sentinel runs — the big compressible segment section) actually shrink.
    LZ4 is a match coder, not an entropy coder: near-random SQ8 codes do NOT
    shrink and pack_container stores those raw (len(stored) < len(raw) gate)."""
    rng = np.random.default_rng(7)
    g = np.full((4000, 32), -1, np.int32)
    for i in range(4000):
        deg = int(rng.integers(4, 24))
        g[i, :deg] = rng.integers(0, 4000, deg)
    raw = g.tobytes()
    comp = lz4.compress(raw)
    assert len(comp) < 0.8 * len(raw)


@pytest.mark.skipif(not lz4.available(), reason="native lz4 codec not built")
def test_adversarial_decompress_never_crashes():
    rng = np.random.default_rng(11)
    for _ in range(300):
        n = int(rng.integers(0, 200))
        junk = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        try:
            lz4.decompress(junk, int(rng.integers(0, 500)))
        except ValueError:
            pass
    # truncations / bitflips of a valid block
    raw = _cases()[2]
    comp = bytearray(lz4.compress(raw))
    for cut in (0, 1, len(comp) // 2, len(comp) - 1):
        try:
            lz4.decompress(bytes(comp[:cut]), len(raw))
        except ValueError:
            pass
    for i in range(0, len(comp), 7):
        bad = bytearray(comp)
        bad[i] ^= 0xFF
        try:
            out = lz4.decompress(bytes(bad), len(raw))
            assert len(out) == len(raw)  # may decode to wrong bytes; CRC catches it upstream
        except ValueError:
            pass


def test_container_lz4_roundtrip():
    """pack_container(compress='lz4') round-trips through unpack + lazy rows;
    if the native codec is unavailable it degrades to deflate transparently."""
    from vecgo.blobstore import MemoryStore
    from vecgo.storage import container

    rng = np.random.default_rng(13)
    a = (rng.standard_normal((200, 9)) * 8).astype(np.int8)
    b = rng.standard_normal((64, 5)).astype(np.float32)
    blob = container.pack_container({"m": 2}, {"a": a, "b": b}, compress="lz4")
    meta, secs = container.unpack_container(blob)
    assert meta == {"m": 2}
    np.testing.assert_array_equal(secs["a"], a)
    np.testing.assert_array_equal(secs["b"], b)
    st = MemoryStore()
    st.put("c", blob)
    lc = container.LazyContainer(st, "c")
    np.testing.assert_array_equal(lc.load_rows("a", 10, 30), a[10:30])
    # corruption detected (CRC covers stored bytes)
    bad = bytearray(blob)
    bad[-10] ^= 0x55
    from vecgo.errors import ErrCorrupt

    with pytest.raises(ErrCorrupt):
        container.unpack_container(bytes(bad))


@pytest.mark.skipif(not lz4.available(), reason="native lz4 codec not built")
def test_engine_lz4_segments():
    """compress_segments='lz4' end-to-end through commit + reopen."""
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.utils import testutil as tu

    store = MemoryStore()
    eng = Engine.open(
        store,
        EngineOptions(dim=16, flush_threshold=10**9, compress_segments="lz4"),
        create=True,
    )
    x = tu.gaussian_vectors(400, 16, seed=21)
    ids = eng.insert_batch(x)
    eng.commit()
    eng.close()
    eng2 = Engine.open(store, EngineOptions())
    res = eng2.search(x[5], k=3)
    assert res[0].id == ids[5]

"""DeviceBM25: device-resident lexical serving vs the exact host index
(lexical/device_bm25.py). The device path is a bf16 matmul sweep + exact-f32
pool rescore; rankings must agree with the exact path up to bf16 near-ties,
and rare-term queries must fall back to the exact path verbatim."""

import numpy as np
import pytest

from vecgo.lexical.bm25 import BM25Index
from vecgo.lexical.device_bm25 import DeviceBM25

WORDS = [f"word{i}" for i in range(300)]


def _build(n_docs=1500, seed=3):
    rng = np.random.default_rng(seed)
    idx = BM25Index()
    for i in range(n_docs):
        # zipf-ish word choice: low word-ids are hot
        wl = rng.zipf(1.3, 12)
        doc = " ".join(WORDS[min(int(w) - 1, 299)] for w in wl)
        if i % 97 == 0:
            doc += f" rareterm{i}"  # df=1 terms -> below min_df
        idx.add(i + 1, doc)
    return idx


def test_device_matches_exact_on_hot_queries():
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4)
    queries = [
        "word1 word7 word30",
        "word2",
        "word5 word5 word11",
        "word40 word90",
    ]
    got = dev.search_batch(queries, k=10)
    want = idx.search_batch(queries, k=10)
    for g, w in zip(got, want):
        gi = [id_ for id_, _ in g]
        wi = [id_ for id_, _ in w]
        assert gi[0] == wi[0]  # top hit exact
        # bf16 near-ties may reorder the tail; demand heavy overlap
        assert len(set(gi) & set(wi)) >= max(1, int(0.7 * len(wi))), (gi, wi)
        # exact-f32 rescore: scores of shared ids agree to bf16 tolerance
        wmap = dict(w)
        for id_, s in g:
            if id_ in wmap:
                assert abs(s - wmap[id_]) < 2e-2 * max(1.0, abs(wmap[id_]))


def test_rare_term_host_merge():
    """Rare (below-min_df) terms merge host-side into the device pool:
    candidates = pool ∪ rare-posting docs, exact up to bf16 weight
    quantization — no dense fallback (it would cost more than the whole
    device sweep). Ids must match the exact path; scores within bf16."""
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4)
    q = ["rareterm97 word1", "word3"]
    got = dev.search_batch(q, k=5)
    want = idx.search_batch(q, k=5)
    assert [i for i, _ in got[0]] == [i for i, _ in want[0]]
    for (gi, gs), (wi, ws) in zip(got[0], want[0]):
        assert abs(gs - ws) < 2e-2 * max(1.0, abs(ws))
    assert 98 in [id_ for id_, _ in got[0]]  # the rare-term doc surfaces
    # a doc that scores ONLY via the rare term still beats hot-only docs
    got2 = dev.search_batch(["rareterm194"], k=3)[0]
    want2 = idx.search_batch(["rareterm194"], k=3)[0]
    assert [i for i, _ in got2] == [i for i, _ in want2]


def test_unknown_terms_and_empty_query():
    idx = _build()
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4)
    got = dev.search_batch(["zzz qqq", "", "word1 zzz"], k=5)
    assert got[0] == [] and got[1] == []
    want = idx.search_batch(["word1 zzz"], k=5)
    assert [id_ for id_, _ in got[2]][0] == [id_ for id_, _ in want[0]][0]


def test_deletes_respected():
    idx = _build()
    exact_before = idx.search_batch(["word1"], k=3)[0]
    victim = exact_before[0][0]
    idx.delete(victim)
    dev = DeviceBM25(idx, max_hot_terms=256, min_df=4)
    got = dev.search_batch(["word1"], k=10)[0]
    assert victim not in [id_ for id_, _ in got]


def test_engine_hybrid_uses_device_snapshot():
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.utils import testutil as tu

    eng = Engine.open(
        MemoryStore(),
        EngineOptions(dim=16, flush_threshold=10**9, lexical=True),
        create=True,
    )
    x = tu.gaussian_vectors(200, 16, seed=9)
    texts = [f"body word{i % 23} word{i % 7} filler" for i in range(200)]
    texts[5] = "unique golden phrase word1"
    ids = eng.insert_batch(x, texts=texts)
    eng.commit()
    snap = eng.enable_device_lexical(max_hot_terms=64, min_df=2)
    assert snap.device_bytes() > 0
    bids, _ = eng.hybrid_search_batch(
        np.stack([x[5]]), ["unique golden phrase"], k=5
    )
    assert int(bids[0, 0]) == ids[5]
    # a write invalidates the snapshot (falls back to exact host path)
    eng.insert(x[0], text="fresh doc word1")
    bids2, _ = eng.hybrid_search_batch(np.stack([x[5]]), ["golden phrase"], k=5)
    assert int(bids2[0, 0]) == ids[5]

"""Blocked IVF scan: correctness vs brute force on the virtual CPU mesh."""

import numpy as np
import pytest

from vecgo.model import Metric
from vecgo.utils import testutil as tu


def _brute(q, x, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1)[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


@pytest.fixture(scope="module")
def corpus():
    x, _ = tu.clustered_vectors(20_000, 32, n_clusters=64, seed=7)
    # In-distribution queries: perturbed corpus points (the serving case; the
    # reference's benchmark queries are drawn the same way).
    rng = np.random.default_rng(9)
    q = x[rng.choice(len(x), 64, replace=False)] + 0.02 * rng.standard_normal(
        (64, 32)
    ).astype(np.float32)
    return x, q.astype(np.float32)


def test_build_table_covers_every_row(corpus):
    from vecgo.ops import ivf

    x, _ = corpus
    cents, members = ivf.build_ivf_table(x, capacity=256, seed=3)
    live = members[members >= 0]
    assert len(np.unique(live)) == len(x)  # every row has at least one slot
    assert members.max() < len(x)
    k = cents.shape[0]
    assert members.shape == (k, 256)


def test_ivf_scan_recall_and_exactness(corpus):
    import jax.numpy as jnp

    from vecgo.ops import ivf

    x, q = corpus
    k = 10
    gt_d, gt_i = _brute(q, x, k)

    cents, members = ivf.build_ivf_table(x, capacity=256, seed=3)
    xd = jnp.asarray(x)
    rn = jnp.sum(xd * xd, axis=1)
    table = ivf.device_table(members, cents, xd, rn)

    dd, rows = ivf.ivf_scan(jnp.asarray(q), table, n_probe=8, kk=16)
    dd, rows = np.asarray(dd), np.asarray(rows)

    # Containment: the shortlist must hold nearly all true NN (scan distances
    # are bf16 — ranking inside the shortlist is the exact rerank's job).
    contain = sum(
        len(set(rows[b][rows[b] >= 0].tolist()) & set(map(int, gt_i[b])))
        for b in range(len(q))
    ) / (len(q) * k)
    assert contain >= 0.95, contain

    # After exact rerank (the production pipeline), top-k recall holds.
    hits = 0
    for b in range(len(q)):
        cand = np.unique(rows[b][rows[b] >= 0])
        exact = ((q[b][None] - x[cand]) ** 2).sum(-1)
        top = cand[np.argsort(exact)[:k]]
        hits += len(set(top.tolist()) & set(map(int, gt_i[b])))
    recall = hits / (len(q) * k)
    assert recall >= 0.95, recall

    # distances must match exact L2^2 for returned rows (bf16 tolerance)
    for b in range(0, len(q), 16):
        ok = rows[b] >= 0
        exact = ((q[b][None] - x[rows[b][ok]]) ** 2).sum(-1)
        np.testing.assert_allclose(dd[b][ok], exact, rtol=0.05, atol=0.5)


def test_ivf_scan_mask(corpus):
    import jax.numpy as jnp

    from vecgo.ops import ivf

    x, q = corpus
    cents, members = ivf.build_ivf_table(x, capacity=256, seed=3)
    xd = jnp.asarray(x)
    rn = jnp.sum(xd * xd, axis=1)
    table = ivf.device_table(members, cents, xd, rn)

    row_mask = np.zeros(len(x), bool)
    row_mask[::3] = True  # keep every 3rd row
    mflat = ivf.slot_mask_from_rows(table, jnp.asarray(row_mask))
    _, rows = ivf.ivf_scan(
        jnp.asarray(q), table, n_probe=8, kk=16, mask_flat=mflat
    )
    rows = np.asarray(rows)
    live = rows[rows >= 0]
    assert len(live) > 0
    assert (live % 3 == 0).all()


def test_ivf_table_overflow_spill():
    """All points in one tight blob: capacity caps force spill; coverage holds."""
    from vecgo.ops import ivf

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2000, 16)).astype(np.float32) * 0.01
    cents, members = ivf.build_ivf_table(x, capacity=128, slack=1.5, seed=1)
    live = members[members >= 0]
    assert len(np.unique(live)) == len(x)


def test_build_table_tiny_cluster_count():
    """ADVICE r2: capacity >= ~n*slack/2 trains k < 4 clusters; overlap must
    clamp to k or the top-k assignment fails."""
    from vecgo.ops import ivf

    rng = np.random.default_rng(5)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    cents, members = ivf.build_ivf_table(x, capacity=4096, seed=2)
    assert cents.shape[0] == 2
    live = members[members >= 0]
    assert len(np.unique(live)) == len(x)


def test_coded_table_scan_and_beam(corpus):
    """SQ8-residual serving tier (VERDICT r2 #2): coded scan containment,
    coded beam refinement, and decoded-distance accuracy."""
    import jax.numpy as jnp

    from vecgo.index.build_fast import build_graph_clustered
    from vecgo.ops import beam as beam_ops
    from vecgo.ops import ivf

    x, q = corpus
    k = 10
    gt_d, gt_i = _brute(q, x, k)

    graph, medoid, _, _, members = build_graph_clustered(
        x, r=16, cluster_size=256, return_membership=True
    )
    # every row reachable through the serving table
    live = members[members >= 0]
    assert len(np.unique(live)) == len(x)

    xd = jnp.asarray(x)
    table = ivf.device_table_coded(members, xd)
    # slot_of_row inverts rows
    sor = np.asarray(table.slot_of_row)
    assert (np.asarray(table.rows).reshape(-1)[sor] == np.arange(len(x))).all()

    qd = jnp.asarray(q)
    sd, srows = ivf.ivf_scan(qd, table, n_probe=8, kk=16)
    cd, crows = beam_ops._dedup_topk(sd, srows, 48)
    qc = jnp.einsum("bd,kd->bk", qd, table.centroids)
    _, pool = beam_ops.beam_search_coded(
        qd, table, jnp.asarray(graph),
        jnp.where(jnp.isfinite(cd), crows, -1), qc,
        ef=48, k=48, beam_width=4, max_steps=1,
    )
    pool = np.asarray(pool)
    hits = 0
    for b in range(len(q)):
        cand = np.unique(pool[b][pool[b] >= 0])
        exact = ((q[b][None] - x[cand]) ** 2).sum(-1)
        top = cand[np.argsort(exact)[:k]]
        hits += len(set(top.tolist()) & set(map(int, gt_i[b])))
    assert hits / (len(q) * k) >= 0.95

    # decoded distances track exact distances closely (SQ8 residual step)
    ok = np.asarray(srows[0]) >= 0
    exact = ((q[0][None] - x[np.asarray(srows[0])[ok]]) ** 2).sum(-1)
    got = np.asarray(sd[0])[ok]
    rel = np.abs(got - exact) / np.maximum(exact, 1e-2)
    assert np.median(rel) < 0.02, np.median(rel)


def test_coded_masked_scan_matches_filtered_brute(corpus):
    """VamanaSegment.masked_scan (low-selectivity strategy) over codes."""
    import jax.numpy as jnp

    from vecgo.index.vamana import VamanaSegment, VamanaWriter
    from vecgo.model import Metric

    x, q = corpus
    w = VamanaWriter(dim=x.shape[1], metric=Metric.L2, r=16,
                     build_params={"cluster_size": 256})
    w.add_batch(x, np.arange(1, len(x) + 1))
    seg = VamanaSegment.open(w.finish())
    assert seg.ivf_members is not None
    mask = np.zeros(len(x), bool)
    mask[::7] = True
    dd, rows = seg.masked_scan(jnp.asarray(q), 10, mask)
    rows = np.asarray(rows)
    assert (rows[rows >= 0] % 7 == 0).all()
    # top-1 matches the masked brute answer for most queries
    xm = x[mask]
    idx = np.flatnonzero(mask)
    d = ((q[:, None, :] - xm[None]) ** 2).sum(-1)
    want = idx[np.argmin(d, axis=1)]
    agree = (rows[:, 0] == want).mean()
    assert agree >= 0.9, agree


def test_compact_members_primary(corpus):
    """serve_compact: one slot per row, coverage preserved, memory halved."""
    import jax.numpy as jnp

    from vecgo.index.build_fast import build_graph_clustered
    from vecgo.ops import ivf

    x, q = corpus
    _, _, _, _, members = build_graph_clustered(
        x, r=16, cluster_size=256, overlap=2, return_membership=True
    )
    xd = jnp.asarray(x)
    compacted = ivf.compact_members_primary(members, xd)
    live = compacted[compacted >= 0]
    assert len(live) == len(x)  # exactly one slot per row
    assert len(np.unique(live)) == len(x)
    # overlap entries gone (memory win shows at scale; S' rounds to lanes)
    assert len(live) < (members >= 0).sum()
    assert compacted.shape[1] <= members.shape[1]

    table = ivf.device_table_coded(compacted, xd)
    k = 10
    gt_d, gt_i = _brute(q, x, k)
    # More probes than the overlap table needs, per the memory/compute trade.
    dd, rows = ivf.ivf_scan(jnp.asarray(q), table, n_probe=16, kk=16)
    rows = np.asarray(rows)
    contain = sum(
        len(set(rows[b][rows[b] >= 0].tolist()) & set(map(int, gt_i[b])))
        for b in range(len(q))
    ) / (len(q) * k)
    assert contain >= 0.95, contain


def _decoded_scan_reference(q, table, probes, mask, kk):
    """NumPy reference of the coded scan for fixed probes: per (query, probe)
    the kk best slots by |q-c|² + |x̂-c|² - 2·s·(bf16(q-c)·code), float64
    accumulation (the scan's own rounding of the query residual to bf16)."""
    import ml_dtypes

    codes = np.asarray(table.codes).astype(np.float64)
    scale = np.asarray(table.scale, np.float64)
    bn = np.asarray(table.bnorm2, np.float64)
    rows = np.asarray(table.rows)
    cents = np.asarray(table.centroids)
    if mask is not None:
        bn = np.where(mask.reshape(bn.shape), bn, np.inf)
    b, p = probes.shape
    out_d = np.full((b, p, kk), np.inf)
    out_r = np.full((b, p, kk), -1, np.int64)
    for i in range(b):
        for j in range(p):
            c = probes[i, j]
            qr = (q[i] - cents[c]).astype(np.float32)
            qr16 = qr.astype(ml_dtypes.bfloat16).astype(np.float64)
            dd = (
                np.dot(qr.astype(np.float64), qr) + bn[c]
                - 2.0 * scale[c] * (codes[c] @ qr16)
            )
            top = np.argsort(dd, kind="stable")[:kk]
            ok = np.isfinite(dd[top])
            out_d[i, j, ok] = dd[top][ok]
            out_r[i, j, ok] = rows[c, top][ok]
    return out_d, out_r


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_coded_scan_matches_decoded_reference(corpus, masked):
    """ivf_scan over the SQ8 coded table == the NumPy decoded-L2 reference
    for the same probes, candidate sets and distances (qcap covers every
    probe, so nothing drops)."""
    import jax.numpy as jnp

    from vecgo.ops import ivf

    x, q = corpus
    q = q[:16]
    _, members = ivf.build_ivf_table(x, capacity=256, seed=3)
    table = ivf.device_table_coded(members, jnp.asarray(x))
    n_probe, kk = 4, 8
    mask = None
    if masked:
        row_mask = np.zeros(len(x), bool)
        row_mask[::3] = True
        mask = np.asarray(ivf.slot_mask_from_rows(table, jnp.asarray(row_mask)))
    qd = jnp.asarray(q)
    sd, srows = ivf.ivf_scan(
        qd, table, n_probe=n_probe, kk=kk, qcap=len(q),
        mask_flat=None if mask is None else jnp.asarray(mask.reshape(-1)),
    )
    probes = np.asarray(ivf._probe_clusters(qd, table, n_probe))
    want_d, want_r = _decoded_scan_reference(q, table, probes, mask, kk)
    got_d = np.asarray(sd).reshape(len(q), n_probe, kk)
    got_r = np.asarray(srows).reshape(len(q), n_probe, kk)
    if masked:
        assert (got_r[got_r >= 0] % 3 == 0).all()
    for i in range(len(q)):
        for j in range(n_probe):
            assert set(got_r[i, j].tolist()) == set(want_r[i, j].tolist())
    fin = np.isfinite(want_d)
    assert (np.isfinite(got_d) == fin).all()
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-4, atol=1e-4)

"""Clustered (search-free) Vamana build: recall + structure tests
(reference: diskann writer tests; SURVEY.md §4 golden-recall pattern)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vecgo.index.build_fast import build_graph_clustered
from vecgo.index.vamana import VamanaWriter, VamanaSegment
from vecgo.model import Metric
from vecgo.utils import testutil as tu


def _search_recall(x, graph, medoid, ecent, enodes, q, true_ids, k=10, ef=96):
    from vecgo.ops import beam as beam_ops
    from vecgo.ops import distance as D
    from vecgo.ops import topk as T

    qd = jnp.asarray(q)
    x16 = jnp.asarray(x, jnp.bfloat16)
    rn = jnp.asarray(np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32))
    cd = D.squared_l2(qd, jnp.asarray(ecent), compute_dtype=jnp.bfloat16)
    _, probes = T.topk_smallest(cd, min(4, len(ecent)))
    per_q = jnp.take(jnp.asarray(enodes), probes)
    entry = jnp.concatenate(
        [per_q, jnp.full((len(q), 1), medoid, jnp.int32)], axis=1
    )
    _, _, _, ci_ = beam_ops.beam_search(
        qd, x16, rn, jnp.asarray(graph), entry, ef=ef, k=k,
        beam_width=4, with_visited=True,
    )
    ci = np.asarray(ci_)
    # exact f32 rerank of the ef-list (the engine always reranks)
    v = np.asarray(x)[np.maximum(ci, 0)]
    dx = ((v - q[:, None, :]) ** 2).sum(-1)
    dx[ci < 0] = np.inf
    top = np.take_along_axis(ci, np.argsort(dx, 1)[:, :k], 1)
    return np.mean([len(set(top[i]) & set(true_ids[i])) / k for i in range(len(q))])


def test_clustered_build_recall_small():
    """Single-cluster exact path (n <= 2*cluster_size)."""
    n, d = 1500, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=16, seed=7)
    graph, medoid, ecent, enodes = build_graph_clustered(x, r=24, seed=42)
    assert graph.shape == (n, 24)
    assert not (graph == np.arange(n)[:, None]).any()  # no self loops
    q = x[:64] + np.random.default_rng(8).standard_normal((64, d)).astype(np.float32) * 0.01
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec = _search_recall(x, graph, medoid, ecent, enodes, q, ti)
    assert rec >= 0.95, f"small-corpus recall {rec}"


def test_clustered_build_recall_multicluster():
    """Forced multi-cluster path via small cluster_size."""
    n, d = 6000, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=32, seed=9)
    graph, medoid, ecent, enodes = build_graph_clustered(
        x, r=24, cluster_size=512, seed=42
    )
    deg = (graph >= 0).sum(1)
    assert deg.mean() > 4 and deg.max() <= 24
    q = x[:64] + np.random.default_rng(10).standard_normal((64, d)).astype(np.float32) * 0.01
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    rec = _search_recall(x, graph, medoid, ecent, enodes, q, ti)
    assert rec >= 0.90, f"multi-cluster recall {rec}"


def test_clustered_build_tiny_and_empty():
    g, medoid, c, e = build_graph_clustered(np.zeros((0, 8), np.float32), r=8)
    assert g.shape == (0, 8)
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    g, medoid, c, e = build_graph_clustered(x, r=8)
    assert g.shape == (5, 8)
    assert (np.sort(g[0][g[0] >= 0]) == [1, 2, 3, 4]).all()


def test_writer_clustered_mode_roundtrip():
    n, d = 600, 16
    x = tu.gaussian_vectors(n, d, seed=11)
    w = VamanaWriter(d, Metric.L2, r=16, build_mode="clustered")
    for i in range(n):
        w.add(x[i], i)
    seg = VamanaSegment.open(w.finish())
    assert seg.n == n
    q = jnp.asarray(x[:16])
    _, rows = seg.search(q, 5, ef=64)
    rows = np.asarray(rows)
    assert (rows[:, 0] == np.arange(16)).all()  # self is nearest


def test_device_membership_matches_host():
    """return_membership="device" must equal the host path bit-for-bit:
    same free-slot fill order (flat row-major free slots x ascending
    uncovered rows) and zero host transfers mid-build."""
    import jax

    n, d = 5000, 32
    x, _ = tu.clustered_vectors(n, d, n_clusters=16, seed=7)
    host = build_graph_clustered(
        x, r=16, cluster_size=256, overlap=2, return_membership=True, seed=3
    )
    dev = build_graph_clustered(
        x, r=16, cluster_size=256, overlap=2, return_membership="device", seed=3
    )
    m_host, m_dev = host[4], dev[4]
    assert isinstance(m_dev, jax.Array)
    np.testing.assert_array_equal(m_host, np.asarray(m_dev))
    np.testing.assert_array_equal(host[0], dev[0])  # graph identical
    # every row covered exactly like the host path
    flat = np.asarray(m_dev).reshape(-1)
    assert set(flat[flat >= 0]) == set(range(n))


def test_train_kmeans_dev_matches_host():
    """Device-resident k-means == host-API k-means (same seeds, same math),
    on both the kmeans++ (k<=256) and random-init (k>256) paths."""
    from vecgo.quantization import kmeans as km

    x, _ = tu.clustered_vectors(4000, 16, n_clusters=24, seed=5)
    for k in (24, 300):
        c_host, i_host = km.train_kmeans(x, k, iters=4, seed=9, sample=2048)
        c_dev, i_dev = km.train_kmeans_dev(
            jnp.asarray(x), k, iters=4, seed=9, sample=2048
        )
        np.testing.assert_allclose(c_host, np.asarray(c_dev), rtol=1e-5, atol=1e-5)
        assert abs(float(i_dev) - i_host) <= 1e-3 * max(1.0, abs(i_host))


def test_restarts_improve_uniform_candidates():
    """On unstructured data, a projection restart adds candidate coverage."""
    n, d = 6000, 48
    x = tu.gaussian_vectors(n, d, seed=13)
    q = x[:64] + np.random.default_rng(14).standard_normal((64, d)).astype(np.float32) * 0.01
    _, ti = tu.brute_force_knn(q, x, 10, "l2")
    r1 = _search_recall(x, *build_graph_clustered(x, r=24, cluster_size=512, seed=42), q, ti)
    r2 = _search_recall(
        x, *build_graph_clustered(x, r=24, cluster_size=512, seed=42, restarts=3), q, ti
    )
    assert r2 >= r1 - 0.02, f"restarts hurt: {r1} -> {r2}"

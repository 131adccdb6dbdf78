"""Quantizer round-trip + recall-floor tests
(reference: integration_test/quantization_recall_test.go:17, quantization/*_test.go)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vecgo.model import Metric
from vecgo import quantization as Q
from vecgo.quantization import kmeans as km
from vecgo.utils import testutil as tu

N, D, B, K = 4096, 64, 16, 10


@pytest.fixture(scope="module")
def corpus():
    x, _ = tu.clustered_vectors(N, D, n_clusters=32, spread=0.08, seed=11)
    q = x[:B] + np.random.default_rng(12).standard_normal((B, D)).astype(np.float32) * 0.02
    return x, q


def _make(kind):
    if kind == "pq":
        return Q.create("pq", dim=D, m=8)
    if kind == "opq":
        return Q.create("opq", dim=D, m=8, opq_iters=3)
    return Q.create(kind, dim=D)


QUANTIZERS = ["none", "sq8", "int4", "pq", "opq", "bq", "rabitq"]

# (raw recall@10 floor, reranked recall@10 floor) per kind, clustered 64d data.
FLOORS = {
    "none": (0.999, 0.999),
    "sq8": (0.90, 0.99),
    "int4": (0.45, 0.90),
    "pq": (0.25, 0.90),
    "opq": (0.25, 0.90),
    "bq": (0.15, 0.75),
    "rabitq": (0.15, 0.75),
}


@pytest.mark.parametrize("kind", QUANTIZERS)
def test_recall_floor(corpus, kind):
    x, q = corpus
    quant = _make(kind)
    quant.train(x)
    enc = quant.encode(x)
    enc_dev = {k: jnp.asarray(v) for k, v in enc.items()}
    scores = np.asarray(quant.score(jnp.asarray(q), enc_dev, Metric.L2))
    assert scores.shape == (B, N)
    _, true_ids = tu.brute_force_knn(q, x, K, "l2")

    got = np.argsort(scores, axis=1)[:, :K]
    raw_recall = tu.recall_at_k(got, true_ids)
    raw_floor, rerank_floor = FLOORS[kind]
    assert raw_recall >= raw_floor, f"{kind} raw recall {raw_recall}"

    # Rerank pool of 10*K exact distances (how the engine consumes quantized scores).
    pool = np.argsort(scores, axis=1)[:, : 10 * K]
    rr = []
    for b in range(B):
        cand = x[pool[b]]
        d = ((q[b][None] - cand) ** 2).sum(1)
        rr.append(pool[b][np.argsort(d)[:K]])
    rerank_recall = tu.recall_at_k(np.asarray(rr), true_ids)
    assert rerank_recall >= rerank_floor, f"{kind} reranked recall {rerank_recall}"


@pytest.mark.parametrize("kind", QUANTIZERS)
def test_decode_reduces_error_and_state_roundtrip(corpus, kind):
    x, _ = corpus
    quant = _make(kind)
    quant.train(x)
    enc = quant.encode(x[:256])
    recon = quant.decode(enc)
    assert recon.shape == (256, D)
    rel = np.linalg.norm(recon - x[:256]) / np.linalg.norm(x[:256])
    max_rel = {"none": 1e-6, "sq8": 0.02, "int4": 0.1, "pq": 0.6, "opq": 0.6,
               "bq": 0.9, "rabitq": 0.9}[kind]
    assert rel <= max_rel, f"{kind} recon rel error {rel}"

    state = quant.state()
    quant2 = Q.Quantizer.from_state(state)
    enc2 = quant2.encode(x[:256])
    for name in enc:
        np.testing.assert_array_equal(enc[name], enc2[name])


@pytest.mark.parametrize("kind", ["sq8", "pq", "bq", "rabitq"])
@pytest.mark.parametrize("metric", [Metric.DOT, Metric.COSINE])
def test_other_metrics(corpus, kind, metric):
    x, q = corpus
    quant = _make(kind)
    quant.train(x)
    enc = {k: jnp.asarray(v) for k, v in quant.encode(x).items()}
    scores = np.asarray(quant.score(jnp.asarray(q), enc, metric))
    _, true_ids = tu.brute_force_knn(q, x, K, metric.value)
    pool = np.argsort(scores, axis=1)[:, : 10 * K]
    # At least half the true top-10 should be inside a 100-candidate pool.
    hits = np.mean(
        [len(set(pool[b]) & set(true_ids[b])) / K for b in range(B)]
    )
    assert hits >= 0.5, f"{kind}/{metric}: pool hit rate {hits}"


def test_bq_hamming_metric(corpus):
    x, q = corpus
    quant = _make("bq")
    quant.train(x)
    enc = {k: jnp.asarray(v) for k, v in quant.encode(x).items()}
    qp = jnp.asarray(quant.encode_query(q))
    scores = np.asarray(quant.score(qp, enc, Metric.HAMMING))
    assert scores.shape == (B, N)
    assert (scores >= 0).all() and (scores <= D).all()


def test_kmeans_basics():
    x, assign = tu.clustered_vectors(2000, 16, n_clusters=8, spread=0.02, seed=3)
    centers, inertia = km.train_kmeans(x, 8, iters=20, seed=5)
    assert centers.shape == (8, 16)
    a, dist = km.assign_partitions(x, centers)
    # Points in the same true cluster should mostly land together.
    agreement = 0
    for c in range(8):
        members = a[assign == c]
        if len(members):
            agreement += (members == np.bincount(members, minlength=8).argmax()).mean()
    assert agreement / 8 > 0.9
    idx, _ = km.closest_centroids(x[:4], centers, 3)
    assert idx.shape == (4, 3)
    np.testing.assert_array_equal(idx[:, 0], a[:4])


def test_kmeanspp_device_seeding_quality():
    """Device k-means++ (one jitted matvec-scan program) must seed as well as
    the host D^2 loop it replaced: near-zero inertia on well-separated
    clusters, and bf16-transfer assignment must agree with f32."""
    import jax.numpy as jnp

    x, true_assign = tu.clustered_vectors(4000, 24, n_clusters=32, spread=0.02, seed=11)
    centers, inertia = km.train_kmeans(x, 32, iters=15, seed=7)
    # Perfect seeding finds all 32 separated clusters -> inertia ~= n*d*spread^2.
    floor = 4000 * 24 * 0.02**2
    assert inertia < 10 * floor, (inertia, floor)
    a32, _ = km.assign_partitions(x, centers)
    a16, _ = km.assign_partitions(x, centers, transfer_dtype=jnp.bfloat16)
    assert (a16 == a32).mean() > 0.98


def test_kmeans_grouped_matches_shapes():
    x = tu.gaussian_vectors(1000, 32, seed=9).reshape(1000, 4, 8).transpose(1, 0, 2)
    cbs = km.train_kmeans_grouped(x, 16, iters=5, seed=6)
    assert cbs.shape == (4, 16, 8)
    assert np.isfinite(cbs).all()

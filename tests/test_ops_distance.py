"""Kernel-substrate equivalence tests (the VECGO_SIMD-equivalence analogue,
reference: internal/simd/*_test.go, ci.yml SIMD Equivalence)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vecgo.model import Metric
from vecgo.ops import distance as D
from vecgo.ops import topk as T
from vecgo.ops import hamming as H
from vecgo.utils import testutil as tu


@pytest.fixture(scope="module")
def data():
    x = tu.gaussian_vectors(500, 64, seed=1)
    q = tu.gaussian_vectors(8, 64, seed=2)
    return q, x


def test_squared_l2_matches_numpy(data):
    q, x = data
    got = np.asarray(D.squared_l2(jnp.asarray(q), jnp.asarray(x)))
    want = (
        (q.astype(np.float64) ** 2).sum(1)[:, None]
        + (x.astype(np.float64) ** 2).sum(1)[None]
        - 2 * q.astype(np.float64) @ x.T.astype(np.float64)
    )
    np.testing.assert_allclose(got, np.maximum(want, 0), rtol=1e-4, atol=1e-3)


def test_squared_l2_with_precomputed_norms(data):
    q, x = data
    norms = D.row_norms_sq(jnp.asarray(x))
    a = np.asarray(D.squared_l2(jnp.asarray(q), jnp.asarray(x), norms))
    b = np.asarray(D.squared_l2(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_dot_and_cosine(data):
    q, x = data
    got = np.asarray(D.dot_scores(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, -(q @ x.T), rtol=1e-4, atol=1e-3)

    got_c = np.asarray(D.cosine_scores(jnp.asarray(q), jnp.asarray(x)))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    np.testing.assert_allclose(got_c, 1 - qn @ xn.T, rtol=1e-4, atol=1e-3)


def test_normalize(data):
    _, x = data
    n = np.asarray(D.normalize(jnp.asarray(x)))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_blockwise_search_matches_bruteforce(metric):
    x = tu.gaussian_vectors(1000, 32, seed=3)
    q = tu.gaussian_vectors(16, 32, seed=4)
    k = 10
    d_true, i_true = tu.brute_force_knn(q, x, k, metric)
    d_got, i_got = T.blockwise_topk_search(
        jnp.asarray(q), jnp.asarray(x), k, metric=Metric(metric), block_rows=256
    )
    assert tu.recall_at_k(np.asarray(i_got), i_true) > 0.999
    np.testing.assert_allclose(
        np.sort(np.asarray(d_got), 1), np.sort(d_true, 1), rtol=1e-3, atol=1e-3
    )


def test_blockwise_search_with_mask():
    x = tu.gaussian_vectors(700, 16, seed=5)  # non-multiple of block
    q = tu.gaussian_vectors(4, 16, seed=6)
    mask = np.zeros(700, dtype=bool)
    mask[::7] = True  # only every 7th row eligible
    d_got, i_got = T.blockwise_topk_search(
        jnp.asarray(q),
        jnp.asarray(x),
        5,
        metric=Metric.L2,
        mask=jnp.asarray(mask),
        block_rows=128,
    )
    i_got = np.asarray(i_got)
    assert (i_got % 7 == 0).all()
    d_true, i_true = tu.brute_force_knn(q, x[mask], 5, "l2")
    eligible = np.flatnonzero(mask)
    assert tu.recall_at_k(i_got, eligible[i_true]) > 0.999


def test_topk_merge():
    d1 = jnp.asarray([[1.0, 3.0, 5.0]])
    i1 = jnp.asarray([[10, 30, 50]])
    d2 = jnp.asarray([[2.0, 4.0, 6.0]])
    i2 = jnp.asarray([[20, 40, 60]])
    dm, im = T.merge_topk(d1, i1, d2, i2, 4)
    np.testing.assert_array_equal(np.asarray(dm), [[1, 2, 3, 4]])
    np.testing.assert_array_equal(np.asarray(im), [[10, 20, 30, 40]])


def test_hamming_pack_roundtrip():
    r = np.random.default_rng(7)
    bits = r.integers(0, 2, size=(20, 100)).astype(np.uint8)
    packed = H.pack_bits(jnp.asarray(bits))
    back = np.asarray(H.unpack_bits(packed, 100))
    np.testing.assert_array_equal(back, bits)


def test_hamming_mxu_equals_popcount():
    r = np.random.default_rng(8)
    d = 128
    qb = r.integers(0, 2, size=(6, d)).astype(np.uint8)
    xb = r.integers(0, 2, size=(50, d)).astype(np.uint8)
    qp = H.pack_bits(jnp.asarray(qb))
    xp = H.pack_bits(jnp.asarray(xb))
    via_pop = np.asarray(H.hamming_scores_popcount(qp, xp))
    via_matmul = np.asarray(H.hamming_scores(qp, xp, d))
    want = (qb[:, None, :] != xb[None, :, :]).sum(-1)
    np.testing.assert_array_equal(via_pop, want)
    np.testing.assert_allclose(via_matmul, want, atol=0.5)


def test_hamming_non_multiple_of_32():
    r = np.random.default_rng(9)
    d = 70
    qb = r.integers(0, 2, size=(3, d)).astype(np.uint8)
    xb = r.integers(0, 2, size=(17, d)).astype(np.uint8)
    qp = H.pack_bits(jnp.asarray(qb))
    xp = H.pack_bits(jnp.asarray(xb))
    want = (qb[:, None, :] != xb[None, :, :]).sum(-1)
    np.testing.assert_array_equal(np.asarray(H.hamming_scores_popcount(qp, xp)), want)
    np.testing.assert_allclose(np.asarray(H.hamming_scores(qp, xp, d)), want, atol=0.5)

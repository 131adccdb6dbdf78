"""FreshVamana streaming tests (reference: fresh_vamana_test / soak patterns)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vecgo.index.fresh import FreshVamana
from vecgo.model import Metric
from vecgo.utils import testutil as tu

D = 24


def test_streaming_insert_recall():
    fv = FreshVamana(D, r=16, l_build=32)
    x = tu.gaussian_vectors(3000, D, seed=81)
    for s in range(0, 3000, 500):
        rows = fv.insert_batch(x[s : s + 500])
        np.testing.assert_array_equal(rows, np.arange(s, s + 500))
    q = tu.gaussian_vectors(16, D, seed=82)
    _, true_ids = tu.brute_force_knn(q, x, 10, "l2")
    d, rows = fv.search(jnp.asarray(q), 10, ef=64)
    rec = tu.recall_at_k(np.asarray(rows), true_ids)
    assert rec >= 0.85, f"streaming recall {rec}"


def test_soft_delete_and_consolidate():
    fv = FreshVamana(D, r=16, l_build=32, consolidate_threshold=0.3)
    x = tu.gaussian_vectors(1000, D, seed=83)
    fv.insert_batch(x)
    # delete 40% of rows
    for row in range(0, 1000, 5):
        fv.delete(row)
    for row in range(1, 1000, 5):
        fv.delete(row)
    assert fv.deleted_ratio == pytest.approx(0.4)
    q = tu.gaussian_vectors(8, D, seed=84)
    d, rows = fv.search(jnp.asarray(q), 10, ef=64)
    rows_np = np.asarray(rows)
    assert (rows_np % 5 >= 2).all()  # deleted rows never returned
    assert fv.maybe_consolidate()
    assert fv.n == 600
    assert fv.deleted_ratio == 0.0
    live_x = np.concatenate(
        [x[np.arange(2, 1000, 5)], x[np.arange(3, 1000, 5)], x[np.arange(4, 1000, 5)]]
    )
    d2, rows2 = fv.search(jnp.asarray(q), 5, ef=64)
    # search still consistent: nearest of the live set
    live_set = x[sorted(set(range(1000)) - set(range(0, 1000, 5)) - set(range(1, 1000, 5)))]
    _, ti = tu.brute_force_knn(q, live_set, 5, "l2")
    rec = tu.recall_at_k(np.asarray(rows2), ti)
    assert rec >= 0.8


def test_capacity_growth():
    fv = FreshVamana(D, r=8, l_build=16)
    x = tu.gaussian_vectors(5000, D, seed=85)
    fv.insert_batch(x[:100])
    cap0 = fv.capacity
    fv.insert_batch(x[100:3000])
    assert fv.capacity > cap0
    assert fv.n == 3000
    # self-recall@1: a graph search for an inserted vector should find itself
    # for the vast majority of rows (graph recall, not an exactness guarantee).
    q = x[:100]
    d, rows = fv.search(jnp.asarray(q), 1, ef=32)
    self_hit = (np.asarray(rows)[:, 0] == np.arange(100)).mean()
    assert self_hit >= 0.9, f"self-recall {self_hit}"

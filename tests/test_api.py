"""Public facade tests (reference: examples/basic, examples/modern,
vecgo.go API surface)."""

import numpy as np
import pytest

import vecgo
from vecgo import metadata as md
from vecgo.model import Metric
from vecgo.utils import testutil as tu

D = 12


def test_local_backend_lifecycle(tmp_path):
    path = str(tmp_path / "db")
    with vecgo.Open(vecgo.Local(path), vecgo.Create(dim=D)) as db:
        x = tu.gaussian_vectors(50, D, seed=61)
        ids = db.insert_batch(x, [{"i": i} for i in range(50)])
        db.commit()
        hit = db.search(x[4], k=1)[0]
        assert hit.id == ids[4] and hit.metadata == {"i": 4}
    # reopen without create options
    with vecgo.Open(vecgo.Local(path)) as db:
        hit = db.search(tu.gaussian_vectors(50, D, seed=61)[4], k=1)[0]
        assert hit.id == ids[4]


def test_memory_backend_and_filters():
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(dim=D))
    x = tu.gaussian_vectors(100, D, seed=62)
    db.insert_batch(x, [{"cat": f"c{i % 3}", "n": i} for i in range(100)])
    res = db.search(x[0], k=5, filter=md.eq("cat", "c0") & md.gt("n", 10))
    assert all(c.metadata["cat"] == "c0" and c.metadata["n"] > 10 for c in res)


def test_reader_writer_separation():
    """Stateless read replica over a shared store (reference: vecgo.Remote)."""
    from vecgo.blobstore import MemoryStore

    shared = MemoryStore()
    writer = vecgo.Open(vecgo.Remote(shared), vecgo.Create(dim=D))
    x = tu.gaussian_vectors(30, D, seed=63)
    ids = writer.insert_batch(x)
    writer.commit()
    reader = vecgo.Open(vecgo.Remote(shared, read_only=True))
    assert reader.engine.options.read_only
    assert reader.search(x[2], k=1)[0].id == ids[2]
    from vecgo.errors import ErrReadOnly

    with pytest.raises(ErrReadOnly):
        reader.insert(x[0])
    # writer keeps writing; reader reopens to see new version (manifest-based)
    ids2 = writer.insert_batch(x * 2 + 5)
    writer.commit()
    reader2 = vecgo.Open(vecgo.Remote(shared, read_only=True))
    assert reader2.search(x[2] * 2 + 5, k=1)[0].id == ids2[2]


def test_time_travel_via_open():
    from vecgo.blobstore import MemoryStore

    shared = MemoryStore()
    db = vecgo.Open(vecgo.Remote(shared), vecgo.Create(dim=D))
    x = tu.gaussian_vectors(20, D, seed=64)
    ids = db.insert_batch(x[:10])
    v1 = db.commit()
    db.insert_batch(x[10:])
    db.commit()
    old = vecgo.Open(vecgo.Remote(shared), version=v1)
    assert old.stats()["live_rows"] == 10
    assert old.search(x[3], k=1)[0].id == ids[3]


def test_cosine_metric_api():
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(dim=D, metric=Metric.COSINE))
    x = tu.gaussian_vectors(60, D, seed=65)
    ids = db.insert_batch(x)
    db.commit()
    _, ti = tu.brute_force_knn(x[:3], x, 5, "cosine")
    for bi, r in enumerate(db.search_batch(x[:3], k=5)):
        assert [c.id for c in r] == [ids[j] for j in ti[bi]]

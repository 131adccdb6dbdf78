"""Concurrency soak test: concurrent insert+search+delete with flush/compaction
(reference: engine/soak_test.go:20, isolation_test.go churn; Go's -race regime
is approximated by hammering the engine from threads and checking invariants).
"""

import threading
import time

import numpy as np
import pytest

from vecgo.blobstore import MemoryStore
from vecgo.engine import Engine, EngineOptions
from vecgo.errors import ErrNotFound
from vecgo.utils import testutil as tu

D = 16


@pytest.mark.slow
def test_soak_concurrent_mixed_workload():
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=D,
            flush_threshold=400,
            compaction_threshold=3,
            graph_threshold=1 << 40,
        ),
        create=True,
    )
    rng = np.random.default_rng(77)
    stop = time.time() + 6.0
    errors = []
    inserted_lock = threading.Lock()
    inserted = []

    def writer():
        try:
            while time.time() < stop:
                x = rng.standard_normal((20, D)).astype(np.float32)
                ids = eng.insert_batch(x)
                with inserted_lock:
                    inserted.extend(ids)
        except Exception as e:  # pragma: no cover
            errors.append(("writer", e))

    def deleter():
        try:
            while time.time() < stop:
                with inserted_lock:
                    victim = inserted[len(inserted) // 2] if len(inserted) > 10 else None
                if victim is not None:
                    eng.delete(victim)
                time.sleep(0.002)
        except Exception as e:  # pragma: no cover
            errors.append(("deleter", e))

    def searcher():
        try:
            q = rng.standard_normal((4, D)).astype(np.float32)
            while time.time() < stop:
                res = eng.search_batch(q, k=5)
                for r in res:
                    for c in r:
                        assert np.isfinite(c.distance)
        except Exception as e:  # pragma: no cover
            errors.append(("searcher", e))

    threads = (
        [threading.Thread(target=writer) for _ in range(2)]
        + [threading.Thread(target=deleter)]
        + [threading.Thread(target=searcher) for _ in range(2)]
    )
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errors, errors

    # Invariants after the storm: stats consistent, scan matches pk, search sane.
    st = eng.stats()
    assert st["live_rows"] >= 0
    live_ids = {c.id for c in eng.scan()}
    assert len(live_ids) == st["live_rows"]
    # A known-live id must be findable; a deleted one must not.
    if live_ids:
        some = next(iter(live_ids))
        eng.get(some)
    eng.commit()
    st2 = eng.stats()
    assert st2["memtable_rows"] == 0
    assert st2["live_rows"] == st["live_rows"]

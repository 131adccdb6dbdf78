"""Metrics observer + query stats / explain (reference: examples/observability
Prometheus adapter, examples/explain)."""

import numpy as np

import vecgo
from vecgo.engine import EngineOptions
from vecgo.engine.metrics import CountingObserver


def main():
    obs = CountingObserver()  # export obs.counters to Prometheus/StatsD/etc.
    db = vecgo.Open(vecgo.Memory(), EngineOptions(dim=24, observer=obs))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    db.insert_batch(x, metadatas=[{"group": f"g{i % 4}"} for i in range(500)])
    db.commit()

    from vecgo import metadata as md

    res = db.search(x[0], k=5, filter=md.eq("group", "g0"), with_stats=True)
    print("--- QueryStats.explain() ---")
    print(res.stats.explain())
    print("estimated cost:", res.stats.estimated_cost())

    print("--- engine counters ---")
    for k, v in sorted(obs.counters.items()):
        print(f"{k}: {v}")
    print("--- engine stats ---")
    for k, v in db.stats().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

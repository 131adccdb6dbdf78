"""Query explanation and statistics (reference: examples/explain/main.go).

Shows the planner's decisions for unfiltered, categorical-filtered, and
range-filtered queries: strategy, segment pruning, per-phase timings, and
the abstract cost model (QueryStats.explain / estimated_cost).
"""

import numpy as np

import vecgo
from vecgo import metadata as md


def main():
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(dim=128))
    categories = ["electronics", "books", "clothing", "home", "sports"]
    statuses = ["active", "inactive", "pending"]
    x = np.zeros((1000, 128), np.float32)
    for i in range(1000):
        x[i, (i % 5) * 10] = 1.0
        x[i, (i % 5) * 10 + 1] = (i % 100) / 100.0
    db.insert_batch(
        x,
        metadatas=[
            {
                "category": categories[i % 5],
                "price": float(10 + i % 500),
                "status": statuses[i % 3],
            }
            for i in range(1000)
        ],
    )
    db.commit()

    q = np.zeros(128, np.float32)
    q[0] = 1.0

    print("=== 1: basic search with stats ===")
    res = db.search(q, k=10, with_stats=True)
    st = res.stats
    print(f"results: {len(res)}")
    print(st.explain())
    print(f"estimated cost: {st.estimated_cost():.1f}")

    print("\n=== 2: filtered search stats ===")
    f = md.eq("category", "electronics") & md.eq("status", "active")
    res = db.search(q, k=10, filter=f, with_stats=True)
    st = res.stats
    print(f"results: {len(res)} (selectivity {st.selectivity:.3f})")
    print(st.explain())
    print(
        f"plan time: {st.planning_time_s * 1e6:.0f}us "
        f"({100 * st.planning_time_s / max(st.total_time_s, 1e-12):.1f}% of total)"
    )

    print("\n=== 3: range filter stats ===")
    f = md.gt("price", 100) & md.lt("price", 200)
    res = db.search(q, k=10, filter=f, with_stats=True)
    print(f"results: {len(res)}")
    print(res.stats.explain())

    print("\n=== 4: cost comparison ===")
    plans = [
        ("unfiltered", None),
        ("1 category", md.eq("category", "books")),
        ("narrow range", md.gt("price", 495) & md.lte("price", 509)),
    ]
    for name, flt in plans:
        res = db.search(q, k=10, filter=flt, with_stats=True)
        st = res.stats
        print(
            f"  {name:14s} cost={st.estimated_cost():10.1f} "
            f"rows={st.rows_considered:5d} strategy={st.strategy}"
        )
    db.close()


if __name__ == "__main__":
    main()

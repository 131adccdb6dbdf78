"""Metadata filtering with typed predicates (reference: examples/modern)."""

import numpy as np

import vecgo
from vecgo import metadata as md


def main():
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(dim=32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    db.insert_batch(
        x,
        metadatas=[
            {
                "category": f"cat_{i % 5}",
                "price": float(i % 100),
                "in_stock": i % 3 == 0,
                "tags": [f"t{i % 4}", "all"],
            }
            for i in range(2000)
        ],
    )
    db.commit()

    f = (
        md.eq("category", "cat_2")
        & md.gte("price", 10)
        & md.lt("price", 60)
        & md.contains("tags", "t1")
    )
    hits = db.search(x[0], k=5, filter=f, with_stats=True)
    for h in hits:
        print(f"id={h.id} dist={h.distance:.3f} md={h.metadata}")
    print("--- query plan ---")
    print(hits.stats.explain())
    db.close()


if __name__ == "__main__":
    main()

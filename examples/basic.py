"""Basic usage: open, insert, commit, search (reference: examples/basic)."""

import numpy as np

import vecgo


def main():
    db = vecgo.Open(vecgo.Memory(), vecgo.Create(dim=64))
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((1000, 64)).astype(np.float32)
    ids = db.insert_batch(
        vectors, metadatas=[{"doc": f"doc-{i}", "rank": i} for i in range(1000)]
    )
    db.commit()  # durability boundary: everything before this is now persistent

    hits = db.search(vectors[42], k=5)
    for h in hits:
        print(f"id={h.id} dist={h.distance:.4f} metadata={h.metadata}")
    assert hits[0].id == ids[42]
    db.close()


if __name__ == "__main__":
    main()

"""Quantized segments: PQ / SQ8 / RaBitQ with exact rerank
(reference: README quantization table, examples via WithQuantization)."""

import numpy as np

import vecgo
from vecgo.engine import EngineOptions


def main():
    rng = np.random.default_rng(6)
    n, d = 20_000, 96
    centers = rng.standard_normal((64, d)).astype(np.float32)
    x = centers[rng.integers(0, 64, n)] + 0.1 * rng.standard_normal((n, d)).astype(
        np.float32
    )

    for kind, params in [("sq8", {}), ("pq", {"m": 12}), ("rabitq", {})]:
        db = vecgo.Open(
            vecgo.Memory(),
            EngineOptions(dim=d, quantizer=kind, qparams=params,
                          graph_threshold=1 << 40),
        )
        ids = db.insert_batch(x)
        db.commit()  # segment stores codes + full-precision rerank vectors
        q = x[:100] + 0.01 * rng.standard_normal((100, d)).astype(np.float32)
        res = db.search_batch(q, k=1)
        hit = np.mean([r[0].id == ids[i] for i, r in enumerate(res)])
        seg = db.engine._segments[0].segment
        print(
            f"{kind:7s} codes={seg.quant.code_bytes_per_vector()}B/vec "
            f"(raw {4 * d}B) self-recall@1={hit:.2f}"
        )
        db.close()


if __name__ == "__main__":
    main()

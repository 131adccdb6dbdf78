"""Device-resident BM25 serving: lexical scoring as a matrix product.

Reference analogue: lexical/bm25/bm25.go serves BM25 with per-term posting
iterators (DAAT) on the CPU. The device-first restructuring turns the scoring
into dense linear algebra: precompute the per-(term, doc) BM25 weight
    w[t, d] = idf_t * tf * (k1+1) / (tf + k1 * (1 - b + b * len_d / avg_len))
for the HOT vocabulary (terms with document frequency >= min_df, capped at
max_hot_terms), store it as a [n_docs, H] bf16 table in HBM, and score a
whole query batch as ONE matmul sweep:

    scores[B, n_docs] = onehot(query_terms)[B, H] @ W[n_docs, H]^T   (matmul)

followed by an exact-f32 rescore of the top pool (bf16 ranking noise is
absorbed by a pool margin — the same scan+rerank shape as the flat vector
path). Per-batch H2D is just the [B, T] int32 term-column ids (~100 KB);
the one-hot indicator is built ON DEVICE (uploading it would move 67 MB of
f32 per batch).

RARE terms (df < min_df) don't force a dense fallback: by construction their
postings are tiny, so the host computes their contributions sparsely and
EXACTLY merges them with the device pool — candidates = device pool (hot
scores, exact-rescored) ∪ rare-posting docs (hot part summed from the host
bf16 table + rare part). A doc outside both sets has a hot-only score below
the pool's floor and no rare boost, so it cannot enter the top-k: the merge
is exact up to bf16 weight quantization.

This is a SERVING SNAPSHOT: build once from a BM25Index (e.g. after commit),
rebuild on writes (Engine keys it to (version, lsn)). `search_batch` returns
the same [(id, score)] contract as BM25Index.search_batch; rankings agree
with the exact host path up to bf16 near-ties (the host index stays the
source of truth — tests/test_lexical_device.py)."""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from vecgo.lexical.bm25 import BM25Index, tokenize

_TMAX = 16  # max hot terms per query on the device path


class DeviceBM25:
    """Immutable device-resident BM25 scorer over a BM25Index snapshot."""

    def __init__(
        self,
        index: BM25Index,
        max_hot_terms: int = 4096,
        min_df: int = 8,
        pool_margin: int = 16,
    ):
        import ml_dtypes

        self.index = index
        self.pool_margin = pool_margin
        with index._lock:
            n_docs = sum(index._alive)
            n_slots = len(index._slot_id)
            self.n_slots = n_slots
            self.n_docs = n_docs
            self.slot_id = np.asarray(index._slot_id, np.int64) if n_slots else (
                np.zeros(0, np.int64)
            )
            self.alive = np.asarray(index._alive, bool) if n_slots else (
                np.zeros(0, bool)
            )
            if n_docs == 0:
                self.hot: Dict[str, int] = {}
                self.w_host = np.zeros((0, 1), ml_dtypes.bfloat16)
                self._dev = None
                self._rare_w: Dict[str, Optional[tuple]] = {}
                self.avg_len = 1.0
                self.doc_len = np.zeros(0, np.float32)
                return
            self.avg_len = index._total_len / n_docs
            self.doc_len = np.asarray(index._doc_len, np.float32)
            # hot vocabulary: by live document frequency
            dfs = []
            for t, (slots, tfs) in index._postings.items():
                df = int(self.alive[np.asarray(slots, np.int64)].sum())
                if df >= min_df:
                    dfs.append((df, t))
            dfs.sort(key=lambda x: (-x[0], x[1]))
            hot_terms = [t for _, t in dfs[:max_hot_terms]]
            self.hot = {t: i for i, t in enumerate(hot_terms)}
            h = len(hot_terms)
            w = np.zeros((n_slots, max(h, 1)), np.float32)
            for t, col in self.hot.items():
                slots, wts = self._weights_for(t)
                w[slots, col] = wts
            # bf16 storage host-side too: the host hot-part lookups for rare
            # candidates must rank CONSISTENTLY with the device rescore.
            self.w_host = w.astype(ml_dtypes.bfloat16)
            del w
            self._dev = None
            self._rare_w = {}

    def _weights_for(self, t: str) -> Tuple[np.ndarray, np.ndarray]:
        """(live slots, f32 BM25 weights) for one term — the same formula as
        BM25Index.search (bm25.py)."""
        idx = self.index
        slots, tfs = idx._postings[t]
        slots = np.asarray(slots, np.int64)
        tfs = np.asarray(tfs, np.float32)
        live = self.alive[slots]
        slots, tfs = slots[live], tfs[live]
        df = len(slots)
        if df == 0:
            return slots, tfs
        idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
        denom = tfs + idx.k1 * (
            1.0 - idx.b + idx.b * self.doc_len[slots] / max(self.avg_len, 1e-9)
        )
        return slots, (idf * tfs * (idx.k1 + 1.0) / denom).astype(np.float32)

    def _rare(self, t: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Cached postings weights for a rare (non-hot) indexed term."""
        got = self._rare_w.get(t, False)
        if got is not False:
            return got
        if t not in self.index._postings:
            self._rare_w[t] = None
            return None
        out = self._weights_for(t)
        if len(out[0]) == 0:
            out = None
        self._rare_w[t] = out
        return out

    def device_bytes(self) -> int:
        return int(self.w_host.size * 2)

    def _device(self):
        if self._dev is None:
            import jax.numpy as jnp

            # Pre-pad to a scan-block multiple HERE: blockwise_topk_scored
            # would otherwise jnp.pad the full table EVERY call (a fresh
            # ~GB-scale device copy per batch). Padding rows are alive=False.
            w = self.w_host
            alive = self.alive
            n = w.shape[0]
            block = min(131072, max(n, 1))
            pad = (-n) % block
            if pad:
                w = np.concatenate([w, np.zeros((pad, w.shape[1]), w.dtype)])
                alive = np.concatenate([alive, np.zeros(pad, bool)])
            self._dev = {
                "w16": jnp.asarray(w),  # bf16 host -> bf16 device
                "alive": jnp.asarray(alive),
                "block": block,
            }
        return self._dev

    def release_device(self):
        self._dev = None

    def encode_queries(self, queries: List[str]):
        """Returns (cols [B, T] int32 hot-term columns (-1 pad), rare [B]
        list-of-rare-indexed-terms)."""
        b = len(queries)
        cols = np.full((b, _TMAX), -1, np.int32)
        rare: List[List[str]] = [[] for _ in range(b)]
        for r, text in enumerate(queries):
            toks = sorted(set(tokenize(text)))
            j = 0
            for t in toks:
                col = self.hot.get(t)
                if col is not None:
                    if j < _TMAX:
                        cols[r, j] = col
                        j += 1
                    else:  # >T hot terms: treat overflow as rare (exact path)
                        rare[r].append(t)
                elif t in self.index._postings:
                    rare[r].append(t)
        return cols, rare

    def search_batch_arrays(
        self, queries: List[str], k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device-batch BM25: one bf16 matmul sweep + exact-f32 pool rescore +
        exact host merge of rare-term contributions. Returns (ids [B, k]
        int64 with -1 padding, scores [B, k] f32) — the vectorized serving
        contract (hybrid fusion consumes arrays directly; per-row python only
        touches the few queries that contain a rare term)."""
        b = len(queries)
        if self.n_slots == 0 or not self.hot:
            hits = self.index.search_batch(queries, k)
            out_ids = np.full((b, k), -1, np.int64)
            out_sc = np.zeros((b, k), np.float32)
            for r, hs in enumerate(hits):
                for j, (id_, s) in enumerate(hs[:k]):
                    out_ids[r, j] = id_
                    out_sc[r, j] = s
            return out_ids, out_sc
        import jax
        import jax.numpy as jnp

        cols, rare = self.encode_queries(queries)
        dev = self._device()
        kk = min(k + self.pool_margin, self.n_slots)
        cols_d = jnp.asarray(cols)  # [B, T] int32: the ONLY per-batch upload
        h = self.w_host.shape[1]
        qd = _onehot_jit(h)(cols_d)  # [B, H] bf16, built on device
        _, rows = _scan_topk(qd, dev["w16"], dev["alive"], kk)
        d_exact = _rescore(qd, rows, dev["w16"])
        sd, si = jax.lax.sort((d_exact, rows.astype(jnp.int32)), num_keys=1)
        sd = np.asarray(sd)  # [B, kk] negated scores
        si = np.asarray(si)
        scores = -sd
        valid = np.isfinite(sd) & (scores > 0)
        out_ids = np.where(
            valid[:, :k], self.slot_id[np.maximum(si[:, :k], 0)], -1
        ).astype(np.int64)
        out_sc = np.where(valid[:, :k], scores[:, :k], 0.0).astype(np.float32)
        w_host = self.w_host
        for r in range(b):
            if not rare[r]:
                continue
            rmap: Dict[int, float] = {}
            for t in rare[r]:
                pw = self._rare(t)
                if pw is None:
                    continue
                for slot, wt in zip(pw[0], pw[1]):
                    rmap[int(slot)] = rmap.get(int(slot), 0.0) + float(wt)
            cand = {
                int(si[r, j]): float(scores[r, j])
                for j in range(kk)
                if valid[r, j]
            }
            cand = {s: sc + rmap.get(s, 0.0) for s, sc in cand.items()}
            qcols = cols[r][cols[r] >= 0]
            for slot, rsc in rmap.items():
                if slot not in cand:
                    hot = float(
                        w_host[slot, qcols].astype(np.float32).sum()
                    ) if len(qcols) else 0.0
                    cand[slot] = hot + rsc
            top = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            out_ids[r] = -1
            out_sc[r] = 0.0
            for j, (slot, sc) in enumerate(top):
                if sc <= 0:
                    break
                out_ids[r, j] = int(self.slot_id[slot])
                out_sc[r, j] = sc
        return out_ids, out_sc

    def search_batch(
        self, queries: List[str], k: int = 10
    ) -> List[List[Tuple[int, float]]]:
        """List-of-(id, score) wrapper over search_batch_arrays (the
        BM25Index.search_batch contract)."""
        ids, sc = self.search_batch_arrays(queries, k)
        return [
            [
                (int(ids[r, j]), float(sc[r, j]))
                for j in range(ids.shape[1])
                if ids[r, j] >= 0
            ]
            for r in range(len(queries))
        ]


@functools.lru_cache(maxsize=8)
def _onehot_jit(h: int):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(cols):  # [B, T] int32, -1 pad -> [B, H] bf16 indicator
        oh = jax.nn.one_hot(cols, h, dtype=jnp.bfloat16)  # -1 -> all-zero row
        return oh.sum(axis=1)

    return f


def _scan_topk(qd, w16, alive, kk: int):
    """One [B, H] x [N, H]^T bf16 sweep + running top-k (negated scores:
    smaller-is-better, matching the vector kernels)."""
    from vecgo.ops import topk as T

    n = w16.shape[0]

    def score_fn(q, extra, blk):
        import jax.numpy as jnp

        s = jnp.einsum(
            "bh,nh->bn",
            q.astype(jnp.bfloat16),
            blk["w16"],
            preferred_element_type=jnp.float32,
        )
        return jnp.where(blk["alive"][None, :], -s, jnp.inf)

    return T.blockwise_topk_scored(
        qd, {"w16": w16, "alive": alive}, n, kk, _score_fn_cached(score_fn),
        block_rows=min(131072, n),
    )


_SCORE_FN = None


def _score_fn_cached(fn):
    """Stable closure object across calls -> jit cache hits (ops/topk.py)."""
    global _SCORE_FN
    if _SCORE_FN is None:
        _SCORE_FN = fn
    return _SCORE_FN


def _rescore(qd, rows, w16):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _rr(q, rows_, w):
        safe = jnp.maximum(rows_, 0)
        wv = jnp.take(w, safe, axis=0).astype(jnp.float32)  # [B, P, H]
        s = jnp.einsum(
            "bph,bh->bp", wv, q.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.where(rows_ >= 0, -s, jnp.inf)

    return _rr(qd, rows, w16)

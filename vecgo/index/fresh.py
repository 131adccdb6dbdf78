"""FreshVamana: mutable streaming graph index with soft deletes + consolidation.

Reference: internal/segment/diskann/fresh_vamana.go — lock-free COW growth
(:76-82), insert = greedy search + RobustPrune + reverse edges (:178-225,698),
soft-delete bitmap (:226), background consolidate() when DeletedRatio is high
(:804-868).

Device-first restructuring: inserts are *batched* — a whole block of new points
runs one lockstep beam search against the current device graph, one vectorized
RobustPrune, and one functional row-update; reverse edges are applied in bulk
with a re-prune of the affected nodes. Capacity grows by doubling (device
arrays are static-shaped per capacity; each growth recompiles once).
Soft-deleted nodes stay traversable (standard FreshDiskANN semantics) but are
masked out of results; consolidate() rebuilds the graph over live rows when
the deleted ratio crosses a threshold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vecgo.model import Metric

MIN_CAPACITY = 1024


class FreshVamana:
    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        r: int = 32,
        l_build: int = 64,
        alpha: float = 1.2,
        beam_width: int = 4,
        consolidate_threshold: float = 0.3,
        seed: int = 42,
    ):
        self.dim = dim
        self.metric = metric
        self.r = r
        self.l_build = l_build
        self.alpha = alpha
        self.beam_width = beam_width
        self.consolidate_threshold = consolidate_threshold
        self.rng = np.random.default_rng(seed)
        self.n = 0
        self.capacity = 0
        self.x = np.zeros((0, dim), np.float32)  # host mirror
        self.deleted = np.zeros(0, bool)
        self.medoid = 0
        self._dev = None  # dict(vectors bf16, full f32, rnorm2, graph) padded to capacity
        self._update_fn = None

    # ---------------- capacity ----------------

    def _ensure_capacity(self, need: int):
        import jax
        import jax.numpy as jnp

        if need <= self.capacity:
            return
        cap = max(MIN_CAPACITY, 1 << int(np.ceil(np.log2(need))))
        old_x = self.x
        self.x = np.zeros((cap, self.dim), np.float32)
        self.x[: self.n] = old_x[: self.n]
        old_del = self.deleted
        self.deleted = np.zeros(cap, bool)
        self.deleted[: self.n] = old_del[: self.n]
        old_dev = self._dev
        graph = np.full((cap, self.r), -1, np.int32)
        if old_dev is not None:
            graph[: self.capacity] = np.asarray(old_dev["graph"])
        self._dev = {
            "full": jnp.asarray(self.x),
            "trav": jnp.asarray(self.x, jnp.bfloat16),
            "rnorm2": jnp.asarray((self.x**2).sum(1).astype(np.float32)),
            "graph": jnp.asarray(graph),
        }
        self.capacity = cap
        if self._update_fn is None:
            self._update_fn = jax.jit(
                lambda arr, rows, vals: arr.at[rows].set(vals), donate_argnums=(0,)
            )

    def _set_rows_device(self, rows: np.ndarray, vecs: np.ndarray):
        import jax.numpy as jnp

        rows_d = jnp.asarray(rows.astype(np.int32))
        self._dev["full"] = self._update_fn(self._dev["full"], rows_d, jnp.asarray(vecs))
        self._dev["trav"] = self._update_fn(
            self._dev["trav"], rows_d, jnp.asarray(vecs, jnp.bfloat16)
        )
        self._dev["rnorm2"] = self._update_fn(
            self._dev["rnorm2"],
            rows_d,
            jnp.asarray(np.einsum("nd,nd->n", vecs, vecs, dtype=np.float64).astype(np.float32)),
        )

    # ---------------- insert ----------------

    def insert_batch(self, vectors: np.ndarray) -> np.ndarray:
        """Insert a block of vectors; returns their row indices."""
        import jax.numpy as jnp

        from vecgo.ops import beam as beam_ops
        from vecgo.utils.devbug import call_compiled

        vecs = np.asarray(vectors, np.float32)
        if self.metric == Metric.COSINE:
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30
            )
        c = vecs.shape[0]
        rows = np.arange(self.n, self.n + c)
        self._ensure_capacity(self.n + c)
        self.x[rows] = vecs
        first_batch = self.n == 0
        self.n += c
        self._set_rows_device(rows, vecs)

        if first_batch:
            self.medoid = int(
                ((vecs - vecs.mean(0)) ** 2).sum(1).argmin()
            )
        dev = self._dev
        rows_d = jnp.asarray(rows.astype(np.int32))
        q_blk = jnp.asarray(vecs)

        if first_batch or self.n <= self.r + 1:
            # Bootstrap: connect everything to everything (pruned).
            cand = np.tile(np.arange(self.n, dtype=np.int32), (c, 1))
        else:
            _, _, _, cand_ids = call_compiled(
                beam_ops.beam_search,
                q_blk,
                dev["trav"],
                dev["rnorm2"],
                dev["graph"],
                jnp.asarray([self.medoid], jnp.int32),
                ef=self.l_build,
                k=1,
                beam_width=self.beam_width,
                with_visited=True,
            )
            cand = np.asarray(cand_ids)
        new_nbrs = call_compiled(
            beam_ops.robust_prune,
            rows_d,
            q_blk,
            jnp.asarray(cand.astype(np.int32)),
            dev["full"],
            dev["rnorm2"],
            r_out=self.r,
            alpha=self.alpha,
        )
        dev["graph"] = self._update_fn(dev["graph"], rows_d, new_nbrs)

        # Bulk reverse edges: each new point adds itself to its neighbors'
        # candidate lists; affected nodes re-prune (reference :698).
        nbrs_host = np.asarray(new_nbrs)
        targets = nbrs_host.reshape(-1)
        srcs = np.repeat(rows, self.r)
        keep = targets >= 0
        targets, srcs = targets[keep], srcs[keep]
        if len(targets):
            uniq = np.unique(targets)
            # candidates = current neighbors of target + new back-edge sources
            cur = np.asarray(dev["graph"])[uniq]
            extra = np.full((len(uniq), min(self.r, 16)), -1, np.int32)
            order = np.argsort(targets, kind="stable")
            t_sorted, s_sorted = targets[order], srcs[order]
            starts = np.searchsorted(t_sorted, uniq)
            ends = np.searchsorted(t_sorted, uniq, side="right")
            for i, (s0, e0) in enumerate(zip(starts, ends)):
                take = min(e0 - s0, extra.shape[1])
                extra[i, :take] = s_sorted[s0 : s0 + take]
            cand_all = np.concatenate([cur, extra], axis=1).astype(np.int32)
            uniq_d = jnp.asarray(uniq.astype(np.int32))
            pruned = call_compiled(
                beam_ops.robust_prune,
                uniq_d,
                jnp.asarray(self.x[uniq]),
                jnp.asarray(cand_all),
                dev["full"],
                dev["rnorm2"],
                r_out=self.r,
                alpha=self.alpha,
            )
            dev["graph"] = self._update_fn(dev["graph"], uniq_d, pruned)
        return rows

    # ---------------- delete / consolidate ----------------

    def delete(self, row: int):
        self.deleted[row] = True

    @property
    def deleted_ratio(self) -> float:
        return float(self.deleted[: self.n].mean()) if self.n else 0.0

    def maybe_consolidate(self) -> bool:
        if self.deleted_ratio >= self.consolidate_threshold:
            self.consolidate()
            return True
        return False

    def consolidate(self):
        """Rebuild over live rows (reference consolidate() :804-868 patches
        edges through deleted nodes; a batched full rebuild achieves the same
        graph quality and is one device program)."""
        from vecgo.index.vamana import build_graph
        import jax.numpy as jnp

        live = ~self.deleted[: self.n]
        x_live = self.x[: self.n][live]
        n_new = x_live.shape[0]
        self.n = 0
        self.capacity = 0
        self._dev = None
        self.deleted = np.zeros(0, bool)
        self.x = np.zeros((0, self.dim), np.float32)
        if n_new == 0:
            return np.zeros(0, np.int64)
        self._ensure_capacity(n_new)
        self.x[:n_new] = x_live
        self.n = n_new
        self._set_rows_device(np.arange(n_new), x_live)
        graph, medoid, _, _ = build_graph(
            x_live, r=self.r, l_build=self.l_build, alpha=self.alpha
        )
        g = np.full((self.capacity, self.r), -1, np.int32)
        g[:n_new] = graph
        self._dev["graph"] = jnp.asarray(g)
        self.medoid = medoid
        return np.flatnonzero(live)

    # ---------------- search ----------------

    def search(self, q, k: int, mask: Optional[np.ndarray] = None, ef: int = 0):
        """Beam search; deleted rows are traversable but masked from results."""
        import jax.numpy as jnp

        from vecgo.ops import beam as beam_ops

        b = q.shape[0]
        if self.n == 0:
            return (
                jnp.full((b, k), jnp.inf, jnp.float32),
                jnp.full((b, k), -1, jnp.int32),
            )
        ef = max(ef or self.l_build, k)
        full_mask = np.ones(self.capacity, bool)
        full_mask[self.n :] = False
        full_mask[: self.n] = ~self.deleted[: self.n]
        if mask is not None:
            full_mask[: self.n] &= mask[: self.n]
        dev = self._dev
        return beam_ops.beam_search(
            q,
            dev["trav"],
            dev["rnorm2"],
            dev["graph"],
            jnp.asarray([self.medoid], jnp.int32),
            ef=ef,
            k=k,
            beam_width=self.beam_width,
            mask=jnp.asarray(full_mask),
        )

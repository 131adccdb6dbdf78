"""Multi-chip sharded search + build over a jax.sharding.Mesh.

Reference analogue (SURVEY.md §2.3-2.4): the reference's only distributed story
is stateless read replicas over shared S3 with manifest CAS; its intra-node
parallelism is goroutine fan-out. The device-side replacements:

- **Shard (database) parallelism**: corpus rows sharded across chips along a
  "shard" mesh axis; each chip computes a local top-k over its rows, then an
  all_gather + merge across devices produces the global top-k. This replaces the
  reference's per-segment goroutine fan-out (engine/search.go:790-909).
- **Query-batch data parallelism**: the query batch is sharded along a "dp"
  axis; no cross-query communication is needed.
- **Sharded k-means / index-build steps**: cluster statistics reduce with psum
  over the shard axis (build parallelism, reference pq.go:353-387).

All functions shard with shard_map over an explicit Mesh so collectives ride
the device interconnect (NVLink on a GPU host); blob/manifest durability stays host-side and orthogonal (§2.4).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vecgo.model import Metric
from vecgo.ops import distance as D
from vecgo.ops import topk as T


def make_mesh(shard: Optional[int] = None, dp: int = 1, devices=None) -> Mesh:
    """Build a ("dp", "shard") mesh; shard defaults to all remaining devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shard is None:
        shard = n // dp
    assert dp * shard == n, f"dp({dp}) * shard({shard}) != devices({n})"
    arr = np.asarray(devices).reshape(dp, shard)
    return Mesh(arr, axis_names=("dp", "shard"))


class ShardedFlat:
    """A flat corpus sharded row-wise across the mesh's "shard" axis.

    Queries are sharded along "dp" and replicated along "shard"; results are
    the exact global top-k. Pads N to a multiple of the shard count.
    """

    def __init__(
        self,
        x: np.ndarray,
        mesh: Mesh,
        metric: Metric = Metric.L2,
        block_rows: int = 8192,
        mask: Optional[np.ndarray] = None,  # host bool [N]: rows eligible
    ):
        self.mesh = mesh
        self.metric = metric.compute() if hasattr(metric, "compute") else metric
        self.n = x.shape[0]
        self.dim = x.shape[1]
        self.block_rows = block_rows
        n_shards = mesh.shape["shard"]
        pad = (-self.n) % n_shards
        xp = np.pad(np.asarray(x, np.float32), ((0, pad), (0, 0)))
        if metric == Metric.COSINE:
            norms = np.linalg.norm(xp, axis=1, keepdims=True)
            xp = xp / np.maximum(norms, 1e-30)
        self.shard_rows = xp.shape[0] // n_shards
        x_sharding = NamedSharding(mesh, P("shard", None))
        self.x = jax.device_put(xp, x_sharding)
        rn = np.einsum("nd,nd->n", xp, xp, dtype=np.float64).astype(np.float32)
        self.rnorm2 = jax.device_put(rn, NamedSharding(mesh, P("shard")))
        self.mask = None
        if mask is not None:
            mp = np.zeros(xp.shape[0], bool)
            mp[: self.n] = mask[: self.n]
            self.mask = jax.device_put(mp, NamedSharding(mesh, P("shard")))
        self._search_fn = None
        self._search_k = None

    def _build_search(self, k: int):
        mesh = self.mesh
        metric = self.metric
        shard_rows = self.shard_rows
        n_valid = self.n
        block_rows = min(self.block_rows, shard_rows)
        has_mask = self.mask is not None

        def local_search(q, x, rn, *m):
            # q: [B/dp, d] (replicated over shard); x: [rows/shard, d]
            sidx = jax.lax.axis_index("shard")
            base = sidx * shard_rows
            # Mask out padding rows (only the last shard can contain any).
            local_valid = (
                jnp.arange(shard_rows, dtype=jnp.int32) + base < n_valid
            )
            if has_mask:
                local_valid = local_valid & m[0]
            d_loc, i_loc = T.blockwise_topk_search(
                q,
                x,
                k,
                metric=metric,
                x_norms_sq=rn,
                mask=local_valid,
                block_rows=block_rows,
                x_normalized=True,
            )
            i_glob = jnp.where(i_loc >= 0, i_loc + base, -1)
            # cross-device merge: gather every shard's top-k, reduce to global top-k.
            d_all = jax.lax.all_gather(d_loc, "shard", axis=1, tiled=True)
            i_all = jax.lax.all_gather(i_glob, "shard", axis=1, tiled=True)
            return T.topk_smallest_with_ids(d_all, i_all, k)

        in_specs = [P("dp", None), P("shard", None), P("shard")]
        if has_mask:
            in_specs.append(P("shard"))
        fn = jax.shard_map(
            local_search,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(P("dp", None), P("dp", None)),
            # Outputs ARE shard-replicated (all_gather + identical reduction on
            # every shard); the varying-axis checker can't infer that.
            check_vma=False,
        )
        return jax.jit(fn)

    def search(self, q: np.ndarray, k: int):
        """Exact sharded top-k. q [B, d] with B % dp == 0."""
        if self._search_fn is None or self._search_k != k:
            self._search_fn = self._build_search(k)
            self._search_k = k
        # Normalize on host and device_put straight onto the mesh: jnp.asarray
        # would commit to the default device, which may be a different backend
        # (e.g. a GPU while the mesh is a virtual CPU one).
        qd = np.asarray(q, np.float32)
        if self.metric == Metric.COSINE:
            qd = qd / np.maximum(
                np.linalg.norm(qd, axis=1, keepdims=True), 1e-30
            )
        q_sharding = NamedSharding(self.mesh, P("dp", None))
        qd = jax.device_put(qd, q_sharding)
        if self.mask is not None:
            d, i = self._search_fn(qd, self.x, self.rnorm2, self.mask)
        else:
            d, i = self._search_fn(qd, self.x, self.rnorm2)
        return d, i


class ShardedIVF:
    """The flagship serving structure sharded across the mesh: the SQ8-coded
    blocked-IVF table (ops/ivf.IVFCodedTable) splits on its CLUSTER axis
    along "shard"; queries split along "dp". Each chip probes its local
    top-`n_probe_local` clusters and scans them; per-shard winners all_gather
    across devices and reduce to the global pool (reference analogue: SURVEY §2.3
    row 5 / engine/search.go:790-909 segment fan-out, re-expressed as SPMD).

    Every chip's local probe ranking preserves the global order restricted to
    its clusters, so with n_probe_local >= ceil(n_probe/shards) the union of
    probed clusters covers the single-chip probe set — the sharded pool is a
    superset in quality. Distances are the coded (decoded-x̂) distances; the
    final exact-on-x rerank of the tiny top-k window stays host-side, as in
    single-chip serving. Graph refinement is intentionally absent here:
    refinement gathers arbitrary rows (all-to-all); the sharded path widens
    the shortlist instead (scan cost is per-shard and interconnect traffic stays one
    all_gather of [B, P*kk]).
    """

    def __init__(self, table, mesh: Mesh, group: int = 8):
        from vecgo.ops.ivf import IVFCodedTable

        self.mesh = mesh
        self.group = group
        n_sh = mesh.shape["shard"]
        k_pad, s, d = table.codes.shape
        step = n_sh * group
        k_full = ((k_pad + step - 1) // step) * step
        pad = k_full - k_pad

        def _host(a):
            return np.asarray(a)

        codes = _host(table.codes)
        scale = _host(table.scale)
        bn = _host(table.bnorm2)
        xn = _host(table.xnorm2)
        rows = _host(table.rows)
        cents = _host(table.centroids)
        cn = _host(table.cnorm2)
        if pad:
            codes = np.concatenate([codes, np.zeros((pad, s, d), np.int8)])
            scale = np.concatenate([scale, np.full(pad, 1.0, np.float32)])
            bn = np.concatenate([bn, np.full((pad, s), np.inf, np.float32)])
            xn = np.concatenate([xn, np.full((pad, s), np.inf, np.float32)])
            rows = np.concatenate([rows, np.full((pad, s), -1, np.int32)])
            cents = np.concatenate([cents, np.zeros((pad, d), np.float32)])
            cn = np.concatenate([cn, np.full(pad, np.inf, np.float32)])
        sh = lambda *p: NamedSharding(mesh, P(*p))  # noqa: E731
        self.k_full, self.s, self.d = k_full, s, d
        self.codes = jax.device_put(codes, sh("shard", None, None))
        self.scale = jax.device_put(scale, sh("shard"))
        self.bnorm2 = jax.device_put(bn, sh("shard", None))
        self.xnorm2 = jax.device_put(xn, sh("shard", None))
        self.rows = jax.device_put(rows, sh("shard", None))
        self.cents = jax.device_put(cents, sh("shard", None))
        self.cn = jax.device_put(cn, sh("shard"))
        self._table_cls = IVFCodedTable
        self._fns = {}

    def _build(self, b_local: int, n_probe_local: int, kk: int):
        from vecgo.ops.ivf import _ivf_scan_body

        mesh = self.mesh
        group = self.group
        cls = self._table_cls
        qcap = max(
            32,
            ((3 * b_local * n_probe_local // max(self.k_full // mesh.shape["shard"], 1)) + 31)
            // 32 * 32,
        )
        qcap = min(qcap, b_local)

        def local(q, codes, scale, bn, xn, rows, cents, cn):
            tbl = cls(
                codes=codes, scale=scale, bnorm2=bn, xnorm2=xn, rows=rows,
                slot_of_row=jnp.zeros((1,), jnp.int32),  # unused by the scan
                centroids=cents, cnorm2=cn,
            )
            sd, srows = _ivf_scan_body(
                q, tbl, None, n_probe_local, kk, qcap, group
            )
            # srows are SEGMENT rows — already global; merge across devices.
            d_all = jax.lax.all_gather(sd, "shard", axis=1, tiled=True)
            i_all = jax.lax.all_gather(srows, "shard", axis=1, tiled=True)
            from vecgo.ops.beam import _dedup_topk

            # Pool width: 2x one shard's candidate count (callers cut to
            # ef/k), bounded by everything gathered.
            w = min(
                n_probe_local * kk * mesh.shape["shard"],
                max(64, 2 * n_probe_local * kk),
            )
            return _dedup_topk(d_all, i_all, w)

        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P("dp", None), P("shard", None, None), P("shard"),
                P("shard", None), P("shard", None), P("shard", None),
                P("shard", None), P("shard"),
            ),
            out_specs=(P("dp", None), P("dp", None)),
            check_vma=False,
        )
        return jax.jit(fn)

    def search(self, q: np.ndarray, n_probe_local: int = 8, kk: int = 16):
        """Sharded shortlist scan. Returns (dists, rows) host arrays — the
        global candidate pool sorted by coded distance (callers cut to k or
        exact-rerank the window host-side)."""
        q = np.asarray(q, np.float32)
        b = q.shape[0]
        dp = self.mesh.shape.get("dp", 1)
        pad = (-b) % dp
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
        key = (q.shape[0] // dp, n_probe_local, kk)
        if key not in self._fns:
            self._fns[key] = self._build(*key)
        qd = jax.device_put(q, NamedSharding(self.mesh, P("dp", None)))
        d, rows = self._fns[key](
            qd, self.codes, self.scale, self.bnorm2, self.xnorm2,
            self.rows, self.cents, self.cn,
        )
        return np.asarray(d)[:b], np.asarray(rows)[:b]


def sharded_kmeans_step(mesh: Mesh):
    """One Lloyd iteration over a row-sharded corpus: local one-hot-matmul
    cluster stats + psum over the shard axis. Returns a jitted step fn
    (x_shard, centers) -> (centers', inertia)."""

    def step(x, centers):
        # x: [rows/shard, d] local; centers: [K, d] replicated.
        k = centers.shape[0]
        c_norms = D.row_norms_sq(centers)
        dmat = (
            D.row_norms_sq(x)[:, None]
            + c_norms[None, :]
            - 2.0
            * jax.lax.dot_general(
                x, centers, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        assign = jnp.argmin(dmat, axis=1)
        onehot = (
            assign[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
        ).astype(jnp.float32)
        sums = jax.lax.dot_general(
            onehot, x, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        counts = jnp.sum(onehot, axis=0)
        inertia = jnp.sum(jnp.maximum(jnp.min(dmat, axis=1), 0.0))
        sums = jax.lax.psum(sums, ("dp", "shard"))
        counts = jax.lax.psum(counts, ("dp", "shard"))
        inertia = jax.lax.psum(inertia, ("dp", "shard"))
        new_centers = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], centers
        )
        return new_centers, inertia

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(("dp", "shard"), None), P(None, None)),
        out_specs=(P(None, None), P()),
    )
    return jax.jit(fn)

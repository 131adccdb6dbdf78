"""Engine-integrated multi-chip sharding.

Reference analogue (SURVEY.md §2.3): the reference scales reads with
stateless replicas over shared S3 (vecgo.go:151-179) and fans searches out
per segment across goroutines (engine/search.go:790-909). The device-side
replacement shards the ENGINE's data plane across a device mesh:

- **ShardedSnapshotSearcher**: takes an engine snapshot, concatenates its
  committed segments into one virtual row space, row-shards it across the
  mesh's devices (tombstones baked into the shard mask), and answers batched
  queries with per-shard local top-k + all_gather merge across devices. Results map
  back to global ids via the concatenated id column.
- **sharded_cluster_knn**: the FLOP-dominant stage of the clustered Vamana
  build (index/build_fast) sharded over the mesh — clusters are independent
  work units; each device computes exact KNN for its cluster slice and the
  per-point candidate tables merge with an elementwise max-reduce (slots are
  written by exactly one device; -1 is the identity). Build throughput scales
  with mesh size.
- **dryrun_engine_sharded**: one tiny end-to-end pass of both planes, used by
  __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from vecgo.model import Metric
from vecgo.parallel.mesh import ShardedFlat, ShardedIVF


class ShardedSnapshotSearcher:
    """Row-shards a snapshot's committed segments across a device mesh.

    Built once per snapshot/mesh (device_put of the corpus); queries then run
    exact sharded search. Deletions visible at the snapshot are baked into
    the shard mask. The memtable (mutable, small) is NOT included — callers
    searching a live engine should flush first or merge memtable results
    host-side (the reference's read replicas are likewise committed-only).
    """

    def __init__(self, snapshot, mesh: Mesh, metric: Metric = Metric.L2):
        self.mesh = mesh
        self.metric = metric
        xs, ids, mask_parts = [], [], []
        self.seg_ids = []
        for h in snapshot.segments:
            seg = h.segment
            if seg.n == 0:
                continue
            xs.append(np.asarray(seg.vectors, np.float32))
            ids.append(np.asarray(seg.ids, np.int64))
            dead = snapshot.tombstones.deleted_mask(seg.seg_id, seg.n, snapshot.lsn)
            mask_parts.append(~dead if dead is not None else np.ones(seg.n, bool))
            self.seg_ids.append(seg.seg_id)
        if not xs:
            self.flat = None
            self.ids = np.zeros(0, np.int64)
            return
        x = np.concatenate(xs)
        self.ids = np.concatenate(ids)
        mask = np.concatenate(mask_parts)
        self.flat = ShardedFlat(x, mesh, metric=metric, mask=mask)

    def search(self, q: np.ndarray, k: int):
        """Exact sharded top-k over the snapshot. Returns (ids [B,k] int64
        with -1 padding, dists [B,k] f32), both host. Query batches pad to a
        dp multiple transparently."""
        q = np.asarray(q, np.float32)
        b = q.shape[0]
        if self.flat is None:
            return np.full((b, k), -1, np.int64), np.full((b, k), np.inf, np.float32)
        dp = self.mesh.shape.get("dp", 1)
        pad = (-b) % dp
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
        d, rows = self.flat.search(q, k)
        rows = np.asarray(rows)[:b]
        d = np.asarray(d)[:b]
        out = np.where(rows >= 0, self.ids[np.maximum(rows, 0)], -1)
        return out, np.where(rows >= 0, d, np.inf)


class ShardedEngineSearcher:
    """FULL engine serving plane over a device mesh (VERDICT r4 #5 — the
    reference's fan-out covers memtable + all segments, engine/search.go:
    790-909; this is that contract re-expressed as SPMD).

    Per-source plan, mirroring the single-chip planner:

    - **VamanaSegment (coded)**: the segment's OWN SQ8-residual coded table —
      no f32 re-upload — cluster-shards across the mesh (ShardedIVF scan +
      all_gather merge). Optional coded GRAPH refinement runs dp-parallel
      under shard_map with the coded table + graph REPLICATED per device:
      graph gathers are all-to-all-hostile, and the coded table is ~9% of the
      f32 corpus, so replication is the affordable answer on the refinement
      stage while the scan stage shards FLOPs and bytes.
    - **FlatSegment**: rows shard via ShardedFlat (flat segments' serving
      plane IS full-precision rows); tombstones baked into the shard mask.
    - **memtable**: host-side exact numpy scoring (small + mutable), merged
      into the global pool host-side.

    MVCC: per-source tombstones are dropped before the merge; multi-version
    ("dirty") ids verify against the PK chain at the merge — the same
    visibility rule as engine/search._finish_chunk. The final ranking is an
    exact f32 rerank of each source's candidate window.
    """

    def __init__(
        self,
        snapshot,
        mesh: Mesh,
        metric: Metric = Metric.L2,
        pk=None,
        include_memtable: bool = True,
    ):
        from vecgo.index.flat import FlatSegment

        self.mesh = mesh
        self.metric = metric
        self.pk = pk
        self.lsn = snapshot.lsn
        self.sources = []  # (kind, seg_id, payload...)
        self._refine_fns = {}
        for h in snapshot.segments:
            seg = h.segment
            if seg.n == 0:
                continue
            dead = snapshot.tombstones.deleted_mask(
                seg.seg_id, seg.n, snapshot.lsn
            )
            if getattr(seg, "ivf_members", None) is not None:
                # Coded graph segment: shard its own coded table.
                dev = seg.device_state()
                table = dev["ivfq"]
                siv = ShardedIVF(table, mesh)
                deleted = (
                    np.flatnonzero(dead) if dead is not None
                    else np.zeros(0, np.int64)
                )
                self.sources.append((
                    "ivf", seg.seg_id, seg, siv, table, set(deleted.tolist()),
                ))
            elif isinstance(seg, FlatSegment):
                mask = ~dead if dead is not None else None
                sf = ShardedFlat(
                    np.asarray(seg.vectors, np.float32), mesh,
                    metric=metric, mask=mask,
                )
                self.sources.append(("flat", seg.seg_id, seg, sf))
            else:  # legacy table-less vamana: exact sharded scan of its rows
                mask = ~dead if dead is not None else None
                sf = ShardedFlat(
                    np.asarray(seg.vectors, np.float32), mesh,
                    metric=metric, mask=mask,
                )
                self.sources.append(("flat", seg.seg_id, seg, sf))
        self.mem = None
        if include_memtable and snapshot.mem_rows:
            mem = snapshot.memtable
            n_vis = snapshot.mem_rows
            vecs = np.stack([mem.vector(r) for r in range(n_vis)]).astype(
                np.float32
            )
            ids = np.asarray(mem.ids[:n_vis], np.int64)
            lsns = np.asarray(mem.lsns[:n_vis], np.int64)
            dead = mem.deleted_mask(n_vis, snapshot.lsn)
            alive = ~dead if dead is not None else np.ones(n_vis, bool)
            self.mem = (vecs, ids, lsns, alive)

    # ---------------- dp-parallel coded graph refinement ----------------

    def _refine(self, seg_key, table, graph_host, q: np.ndarray,
                pool: np.ndarray, ef: int, beam_width: int, steps: int):
        """Refine a candidate pool through the coded graph, sharded over the
        query (dp x shard flattened) axis; table + graph replicated."""
        mesh = self.mesh
        axes = tuple(mesh.axis_names)
        n_dev = int(np.prod([mesh.shape[a] for a in axes]))
        arr_leaves = [l for l in table if l is not None]
        pad_none = len(table) - len(arr_leaves)  # trailing Optional fields
        key = (seg_key, pool.shape[1], ef, beam_width, steps, pad_none)
        if key not in self._refine_fns:
            from vecgo.ops import beam as beam_ops
            from vecgo.ops.ivf import IVFCodedTable

            def local(q_, pool_, g_, *leaves):
                tbl = IVFCodedTable(*leaves, *([None] * pad_none))
                qc = jnp.einsum(
                    "bd,kd->bk", q_.astype(jnp.float32), tbl.centroids
                )
                d2, p2 = beam_ops.beam_search_coded(
                    q_, tbl, g_, pool_, qc, ef=ef, k=ef,
                    beam_width=beam_width, max_steps=steps,
                )
                return d2, p2

            fn = jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(axes, None), P(axes, None), P())
                + (P(),) * len(arr_leaves),
                out_specs=(P(axes, None), P(axes, None)),
                check_vma=False,
            )
            self._refine_fns[key] = jax.jit(fn)
        b = q.shape[0]
        pad = (-b) % n_dev
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
            pool = np.concatenate(
                [pool, np.full((pad, pool.shape[1]), 0, pool.dtype)]
            )
        from jax.sharding import NamedSharding

        rep = NamedSharding(self.mesh, P())
        row_sh = NamedSharding(self.mesh, P(tuple(self.mesh.axis_names), None))
        leaves = [jax.device_put(np.asarray(x), rep) for x in arr_leaves]
        d2, p2 = self._refine_fns[key](
            jax.device_put(q, row_sh),
            jax.device_put(np.asarray(pool, np.int32), row_sh),
            jax.device_put(np.asarray(graph_host, np.int32), rep),
            *leaves,
        )
        return np.asarray(d2)[:b], np.asarray(p2)[:b]

    # ---------------- search ----------------

    def search(self, q: np.ndarray, k: int, n_probe_local: int = 8,
               kk: int = 16, refine_steps: int = 0, ef: int = 64,
               beam_width: int = 4):
        """Sharded fan-out over every source; returns (ids [B,k] int64 -1
        pad, dists [B,k] f32), exact-f32-ranked and MVCC-visible."""
        q = np.asarray(q, np.float32)
        b = q.shape[0]
        cand_d, cand_id, cand_lsn = [], [], []

        def _exact(qb, vecs, rows):
            safe = np.maximum(rows, 0)
            v = vecs[safe]  # [B, P, d]
            dd = (
                np.einsum("bd,bd->b", qb, qb)[:, None]
                + np.einsum("bpd,bpd->bp", v, v)
                - 2.0 * np.einsum("bpd,bd->bp", v, qb)
            )
            return np.where(rows >= 0, np.maximum(dd, 0.0), np.inf).astype(
                np.float32
            )

        for src in self.sources:
            if src[0] == "ivf":
                _, seg_id, seg, siv, table, deleted = src
                d, rows = siv.search(q, n_probe_local=n_probe_local, kk=kk)
                if refine_steps > 0:
                    # entry pool for the dp-parallel beam: best <=ef coded
                    # candidates (beam internals pad the frontier to ef).
                    _, rows = self._refine(
                        seg_id, table, seg.graph, q, rows[:, :ef], ef,
                        beam_width, refine_steps,
                    )
                rows = rows.astype(np.int64)
                if deleted:
                    dead = np.isin(rows, np.fromiter(deleted, np.int64))
                    rows = np.where(dead, -1, rows)
                vecs = np.asarray(seg.vectors, np.float32)
                dd = _exact(q, vecs, rows)
            else:
                _, seg_id, seg, sf = src
                dd, rows = sf.search(q, min(k + 16, seg.n))
                dd = np.asarray(dd)
                rows = np.asarray(rows).astype(np.int64)
                dd = np.where(rows >= 0, dd, np.inf).astype(np.float32)
            ids_src = np.asarray(seg.ids, np.int64)
            lsn_src = np.asarray(seg.lsns, np.int64)
            safe = np.maximum(rows, 0)
            cand_d.append(np.where(rows >= 0, dd, np.inf))
            cand_id.append(np.where(rows >= 0, ids_src[safe], -1))
            cand_lsn.append(np.where(rows >= 0, lsn_src[safe], -1))
        if self.mem is not None:
            vecs, ids, lsns, alive = self.mem
            dd = (
                np.einsum("bd,bd->b", q, q)[:, None]
                + np.einsum("nd,nd->n", vecs, vecs)[None, :]
                - 2.0 * q @ vecs.T
            )
            dd = np.where(alive[None, :], np.maximum(dd, 0.0), np.inf)
            kk_m = min(k + 16, vecs.shape[0])
            sel = np.argpartition(dd, kk_m - 1, axis=1)[:, :kk_m]
            dsel = np.take_along_axis(dd, sel, axis=1).astype(np.float32)
            cand_d.append(dsel)
            cand_id.append(np.where(np.isfinite(dsel), ids[sel], -1))
            cand_lsn.append(np.where(np.isfinite(dsel), lsns[sel], -1))
        if not cand_d:
            return (
                np.full((b, k), -1, np.int64),
                np.full((b, k), np.inf, np.float32),
            )
        D_all = np.concatenate(cand_d, axis=1)
        I_all = np.concatenate(cand_id, axis=1)
        L_all = np.concatenate(cand_lsn, axis=1)
        order = np.argsort(D_all, axis=1, kind="stable")
        D_all = np.take_along_axis(D_all, order, axis=1)
        I_all = np.take_along_axis(I_all, order, axis=1)
        L_all = np.take_along_axis(L_all, order, axis=1)
        valid = np.isfinite(D_all) & (I_all >= 0)
        # MVCC visibility + dedup (same rule as engine/search._finish_chunk):
        # single-version ids are trivially visible; dirty ids check the chain.
        dirty = self.pk.dirty_sorted() if self.pk is not None else np.zeros(
            0, np.int64
        )
        if len(dirty):
            from vecgo.engine.pk import DELETED

            flagged = valid & np.isin(I_all, dirty)
            for bi, j in zip(*np.nonzero(flagged)):
                ent = self.pk.get_entry(int(I_all[bi, j]), self.lsn)
                if (
                    ent is None
                    or ent[1] == DELETED
                    or ent[0] != int(L_all[bi, j])
                ):
                    valid[bi, j] = False
        out_ids = np.full((b, k), -1, np.int64)
        out_d = np.full((b, k), np.inf, np.float32)
        for bi in range(b):
            seen = set()
            o = 0
            for j in range(D_all.shape[1]):
                if not valid[bi, j]:
                    continue
                cid = int(I_all[bi, j])
                if cid in seen:
                    continue
                seen.add(cid)
                out_ids[bi, o] = cid
                out_d[bi, o] = D_all[bi, j]
                o += 1
                if o == k:
                    break
        return out_ids, out_d


def sharded_cluster_knn(
    x16, rnorm2, members: np.ndarray, mem_slot: np.ndarray,
    knn: int, overlap: int, n_out: int, g: int, mesh: Mesh,
):
    """Mesh-sharded twin of build_fast._cluster_knn: the cluster axis splits
    across every mesh device; per-point candidate tables merge with pmax
    (each (point, slot) pair is owned by exactly one cluster => one device;
    -1 padding is the identity for max)."""
    from vecgo.index.build_fast import _cluster_knn

    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    k_pad, cmax = members.shape
    step = g * n_dev
    k_full = ((k_pad + step - 1) // step) * step
    if k_full > k_pad:
        members = np.concatenate(
            [members, np.full((k_full - k_pad, cmax), -1, np.int32)]
        )
        mem_slot = np.concatenate(
            [mem_slot, np.zeros((k_full - k_pad, cmax), np.int32)]
        )
    axes = tuple(mesh.axis_names)

    def local(x16_, rn_, mem_, slot_):
        cand = _cluster_knn(x16_, rn_, mem_, slot_, knn, overlap, n_out, g)
        return jax.lax.pmax(cand, axes)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(axes, None), P(axes, None)),
        out_specs=P(None, None, None),
        check_vma=False,
    )
    from jax.sharding import NamedSharding

    row_sh = NamedSharding(mesh, P(axes, None))
    return jax.jit(fn)(
        x16,
        rnorm2,
        jax.device_put(np.asarray(members, np.int32), row_sh),
        jax.device_put(np.asarray(mem_slot, np.int32), row_sh),
    )


def sharded_prune(
    cand, x16, rnorm2, x_occ, rn_occ,
    r: int, alpha: float, block: int, rev_cap: int, mesh: Mesh,
    one_pass: bool = False,
):
    """Mesh-sharded RobustPrune + reverse re-prune (the build's FLOP-heavy
    tail, extending the sharded build beyond cluster-KNN — SURVEY §2.3 build
    parallelism). Candidate rows split across every device; the corpus
    replicates; the forward graph all_gathers once across devices for the reverse
    pass, then each shard re-prunes its slice. Exact same semantics as the
    single-device _prune_all + _prune_with_reverse pipeline.

    one_pass=True: `cand` already carries reverse candidates (the build's
    default reverse-of-knn path) — ONE prune pass per shard and no
    intermediate all_gather at all (matches the single-device default)."""
    from vecgo.index.build_fast import _prune_blocks, _reverse_dev

    axes = tuple(mesh.axis_names)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    n_pad, l = cand.shape
    lblock = min(block, max(128, n_pad // n_dev))
    step = n_dev * lblock
    n_full = ((n_pad + step - 1) // step) * step
    if n_full > n_pad:
        cand = jnp.concatenate(
            [cand, jnp.full((n_full - n_pad, l), -1, cand.dtype)]
        )
    local_rows = n_full // n_dev

    def local(cand_, x16_, rn_, xo_, rno_):
        idx = jnp.int32(0)
        mult = 1
        for a in reversed(axes):
            idx = idx + jax.lax.axis_index(a) * mult
            mult *= mesh.shape[a]
        row0 = idx * local_rows
        g_loc = _prune_blocks(
            cand_, x16_, rn_, xo_, rno_, r, alpha, lblock, row0=row0
        )
        if one_pass:
            return jax.lax.all_gather(g_loc, axes, axis=0, tiled=True)
        g_full = jax.lax.all_gather(g_loc, axes, axis=0, tiled=True)
        rev = _reverse_dev(g_full, rev_cap)
        rev_loc = jax.lax.dynamic_slice_in_dim(rev, row0, local_rows, 0)
        cand2 = jnp.concatenate([g_loc, rev_loc], axis=1)
        g2 = _prune_blocks(
            cand2, x16_, rn_, xo_, rno_, r, alpha, lblock, row0=row0
        )
        return jax.lax.all_gather(g2, axes, axis=0, tiled=True)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axes, None), P(), P(), P(), P()),
        out_specs=P(None, None),
        check_vma=False,
    )
    out = jax.jit(fn)(cand, x16, rnorm2, x_occ, rn_occ)
    return out[:n_pad]


def dryrun_engine_sharded(mesh: Mesh) -> None:
    """Tiny end-to-end pass: engine snapshot -> sharded search; sharded
    cluster-KNN build stage. Runs on the dryrun's virtual CPU mesh."""
    from vecgo.blobstore import MemoryStore
    from vecgo.engine import Engine, EngineOptions
    from vecgo.utils import testutil as tu

    d = 16
    n = 64 * int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    eng = Engine.open(
        MemoryStore(),
        EngineOptions(dim=d, flush_threshold=10**9, graph_threshold=10**9),
        create=True,
    )
    x = tu.gaussian_vectors(n, d, seed=50)
    ids = eng.insert_batch(x)
    eng.commit()
    eng.delete(ids[1])
    snap = eng.snapshot()
    try:
        searcher = ShardedSnapshotSearcher(snap, mesh, eng.options.metric)
        got, dist = searcher.search(x[:8], k=3)
    finally:
        snap.release()
    assert got.shape == (8, 3)
    assert int(got[0, 0]) == ids[0] and float(dist[0, 0]) < 1e-5
    assert all(int(i) != ids[1] for i in got[1])  # tombstone respected

    # Sharded build stage: exact per-cluster KNN over the mesh. device_put
    # from host numpy so nothing lands on the (possibly non-CPU) default
    # device.
    import ml_dtypes
    from jax.sharding import NamedSharding

    rep = NamedSharding(mesh, P())
    x16 = jax.device_put(x.astype(ml_dtypes.bfloat16), rep)
    rn = jax.device_put(
        np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32), rep
    )
    members = np.arange(n, dtype=np.int32).reshape(4, n // 4)
    slots = np.zeros((4, n // 4), np.int32)
    cand = sharded_cluster_knn(x16, rn, members, slots, 8, 1, n, 1, mesh)
    cand = np.asarray(cand[:n])
    assert cand.shape == (n, 1, 8) and (cand.reshape(n, -1) >= 0).any(axis=1).all()

    # Sharded FLAGSHIP serving structure: the SQ8-coded blocked-IVF table
    # cluster-sharded over the mesh, per-shard scan + all_gather merge
    # (parallel/mesh.ShardedIVF).
    from vecgo.ops import ivf as ivf_ops
    from vecgo.parallel.mesh import ShardedIVF

    xf = jax.device_put(np.asarray(x, np.float32), rep)
    table = ivf_ops.device_table_coded(members, xf)
    siv = ShardedIVF(table, mesh)
    # The toy membership is index-sliced (not geometric): probe every real
    # cluster so the exact self-match is guaranteed in the pool.
    dd, rows = siv.search(x[:8], n_probe_local=4, kk=4)
    assert rows.shape[0] == 8 and (rows[:, 0] == np.arange(8)).all(), rows[:, 0]
    # Coded (decoded-x̂) self-distance: bounded by the SQ8 residual step —
    # far below the ~2d expected inter-point distance on gaussian data.
    assert float(dd[0, 0]) < 1.0, float(dd[0, 0])

    # ---- FULL engine serving plane sharded (VERDICT r4 #5): a snapshot
    # with a coded VAMANA segment + memtable rows + deletes + an update,
    # served through ShardedEngineSearcher (cluster-sharded coded scan,
    # dp-parallel coded graph refinement, host memtable merge, PK-chain
    # visibility), checked against exact brute force over visible rows.
    eng2 = Engine.open(
        MemoryStore(),
        EngineOptions(
            dim=d, flush_threshold=10**9, graph_threshold=64,
            compaction_threshold=2, serve_ivf_min_n=64,
        ),
        create=True,
    )
    x2 = tu.gaussian_vectors(6 * 64, d, seed=51)
    ids2 = eng2.insert_batch(x2[:256])
    eng2.commit()
    eng2.insert_batch(x2[256:320])
    eng2.commit()
    eng2.compact([h.seg_id for h in eng2._segments])  # -> vamana segment
    ids_mem = eng2.insert_batch(x2[320:360])  # memtable rows
    eng2.delete(ids2[3])  # segment tombstone
    eng2.delete(ids_mem[1])  # memtable tombstone
    eng2.insert(x2[360], id=ids2[5])  # update: dirty id (old row stale)
    assert any(
        getattr(h.segment, "ivf_members", None) is not None
        for h in eng2._segments
    ), "dryrun must exercise the CODED sharded path"
    snap2 = eng2.snapshot()
    try:
        ses = ShardedEngineSearcher(snap2, mesh, eng2.options.metric, eng2.pk)
        got_ids, got_d = ses.search(
            x2[:6], k=5, n_probe_local=8, kk=16, refine_steps=2, ef=32,
        )
    finally:
        snap2.release()
    exp_ids, _ = _brute_visible(eng2, x2[:6], 5)
    assert (got_ids == exp_ids).all(), (got_ids, exp_ids)
    assert int(got_ids[3, 0]) != ids2[3]  # deleted id never surfaces
    eng2.close()
    print(
        "dryrun_engine_sharded OK: sharded snapshot search + sharded build "
        "knn + sharded coded-IVF serving + FULL sharded engine plane "
        "(coded scan + dp graph refinement + memtable merge + MVCC)"
    )


def _brute_visible(eng, q: np.ndarray, k: int):
    """Exact reference answer over the engine's VISIBLE rows (via scan)."""
    recs = [(c.id, c.vector) for c in eng.scan()]
    ids = np.asarray([r[0] for r in recs], np.int64)
    vv = np.stack([r[1] for r in recs]).astype(np.float32)
    dd = (
        np.einsum("bd,bd->b", q, q)[:, None]
        + np.einsum("nd,nd->n", vv, vv)[None, :]
        - 2.0 * q @ vv.T
    )
    order = np.argsort(dd, axis=1, kind="stable")[:, :k]
    return ids[order], np.take_along_axis(dd, order, axis=1)

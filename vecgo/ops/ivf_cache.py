"""Cluster-granular device cache: coded two-stage serving beyond HBM.

The reference serves beyond-RAM DiskANN segments through lazy block reads and
a (file, offset)-keyed block cache (diskann/segment.go:1151,
internal/cache/types.go:22-43, two-tier RAM->NVMe engine.go:425-477). The
round-2 device analogue degraded such segments to full-corpus streaming scans
— every query batch re-uploaded all rows.

This module is the device-side equivalent of the reference's block cache, with
the IVF CLUSTER as the cache unit (a cluster block is this engine's "disk
block": contiguous, capacity-capped, probe-addressed):

- The full SQ8-residual coded table lives BELOW the device: either in host
  memory (MemHostTable — encoded at open, or zero-copy views of persisted
  `ivfq.*` sections), or in the STORE itself (LazyHostTable — cluster blocks
  arrive by block-granular ranged reads; a CachingStore supplies the RAM/NVMe
  tiers). 1 byte/dim/slot, same layout as ops/ivf's IVFCodedTable.
- The device holds only (a) all K centroids (tiny: K*d*4) for probe
  selection and (b) a fixed-size cache of C cluster blocks (C*S*(d+12)
  bytes) updated by LRU on probe misses.
- Per batch: probes are selected on device against the full centroid set,
  missing clusters upload as ONE batched H2D + donated scatter (in place),
  probes remap to cache slots, and the standard grouped scan
  (ops/ivf._scan_groups) runs over the cache. Winners rerank exactly on the
  host (index/common.rerank_host_rows), as in the other beyond-HBM paths.

Hit economics: repeated/clustered query traffic concentrates probes, so
steady-state H2D is proportional to the probe-set churn, not the corpus
(the reference's cache argument, verbatim). Worst case (uniform random
probes, cold cache) degenerates to ~1 byte/dim/row per batch — the same
bytes the streaming scan pays every batch.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

_UNUSED = None  # lazily-built jnp dummy for IVFCodedTable's unused fields


def _encode_host(
    members: np.ndarray,  # [K, S] int32, -1 padded
    x: np.ndarray,  # [N, d] f32 host vectors
    chunk: int = 64,
) -> dict:
    """Numpy SQ8-residual encode, chunked over clusters (the host-side twin
    of ops/ivf._coded_build; member means = the Lloyd update)."""
    k, s = members.shape
    n, d = x.shape
    codes = np.zeros((k, s, d), np.int8)
    bn = np.full((k, s), np.inf, np.float32)
    xn = np.full((k, s), np.inf, np.float32)
    scale = np.zeros(k, np.float32)
    cent = np.zeros((k, d), np.float32)
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        m = members[c0:c1]
        valid = m >= 0
        v = x[np.maximum(m, 0)].astype(np.float32)
        v[~valid] = 0.0
        cnt = valid.sum(axis=1).astype(np.float32)
        ce = v.sum(axis=1) / np.maximum(cnt, 1.0)[:, None]
        res = np.where(valid[:, :, None], v - ce[:, None, :], 0.0)
        sc = np.maximum(np.abs(res).max(axis=(1, 2)) / 127.0, 1e-12)
        cd = np.clip(np.round(res / sc[:, None, None]), -127, 127).astype(np.int8)
        rh = cd.astype(np.float32) * sc[:, None, None]
        codes[c0:c1] = cd
        bn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", rh, rh), np.inf)
        xh = ce[:, None, :] + rh
        xn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", xh, xh), np.inf)
        scale[c0:c1] = sc
        cent[c0:c1] = ce
    cn = np.einsum("kd,kd->k", cent, cent).astype(np.float32)
    empty = (members >= 0).sum(axis=1) == 0
    cn[empty] = np.inf  # probing never selects empty clusters
    return {
        "codes": codes,
        "bn": bn,
        "xn": xn,
        "rows": np.ascontiguousarray(members, dtype=np.int32),
        "scale": scale,
        "cent": cent,
        "cnorm2": cn,
    }


def _encode_host_pq(
    members: np.ndarray,  # [K, S] int32, -1 padded
    x: np.ndarray,  # [N, d] f32 host vectors
    kind: str = "pq",  # "pq" | "opq" (learned rotation before PQ)
    m: int = 0,  # subspaces; 0 = d//4 (4x fewer bytes than SQ8)
    seed: int = 42,
    sample: int = 65536,
    chunk: int = 64,
) -> dict:
    """PQ-residual TRANSPORT encode: cluster blocks ship as m bytes/slot
    (vs d for SQ8) and are decoded+requantized to the SQ8 cache layout on
    device at admission. This is the reference's PQ compression axis
    (quantization/pq.go, diskann codes-resident serving segment.go:503-708)
    recast device-first: PQ compresses the STORE/H2D bytes, while the hot scan
    keeps the dense int8 layout matrix units want.

    bn/scale describe the FINAL double-quantized representation
    (sc * round(decode(pq(res)) / sc)) so device scoring is self-consistent;
    the one-hot f32 decode on device reproduces the host decode exactly."""
    from vecgo.quantization.pq import OPQQuantizer, PQQuantizer

    k, s = members.shape
    n, d = x.shape
    m = int(m) if m else max(1, d // 4)
    # Pass 1: per-cluster means + a residual sample for codebook training.
    cent = np.zeros((k, d), np.float32)
    rng = np.random.default_rng(seed)
    samples = []
    per_chunk = max(256, sample // max(1, k // chunk))
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        mem = members[c0:c1]
        valid = mem >= 0
        v = x[np.maximum(mem, 0)].astype(np.float32)
        v[~valid] = 0.0
        cnt = valid.sum(axis=1).astype(np.float32)
        ce = v.sum(axis=1) / np.maximum(cnt, 1.0)[:, None]
        cent[c0:c1] = ce
        res = (v - ce[:, None, :]).reshape(-1, d)[valid.reshape(-1)]
        if len(res):
            take = min(len(res), per_chunk)
            samples.append(res[rng.choice(len(res), take, replace=False)])
    res_sample = (
        np.concatenate(samples) if samples else np.zeros((1, d), np.float32)
    )
    if len(res_sample) > sample:
        res_sample = res_sample[rng.choice(len(res_sample), sample, replace=False)]
    q = (OPQQuantizer if kind == "opq" else PQQuantizer)(d, m=m)
    q.train(res_sample, seed=seed)
    rot = getattr(q, "rotation", None)
    pq = q.pq if kind == "opq" else q

    # Pass 2: encode every slot's residual; stats over the decoded form.
    codes = np.zeros((k, s, m), np.uint8)
    bn = np.full((k, s), np.inf, np.float32)
    scale = np.zeros(k, np.float32)
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        mem = members[c0:c1]
        valid = mem >= 0
        v = x[np.maximum(mem, 0)].astype(np.float32)
        v[~valid] = 0.0
        res = np.where(valid[:, :, None], v - cent[c0:c1, None, :], 0.0)
        flat = res.reshape(-1, d)
        if rot is not None:
            flat = flat @ rot
        cd_pq = pq._assign(flat)
        dec = pq._decode_codes(cd_pq)
        if rot is not None:
            dec = dec @ rot.T
        dec = dec.reshape(c1 - c0, s, d)
        dec[~valid] = 0.0
        sc = np.maximum(np.abs(dec).max(axis=(1, 2)) / 127.0, 1e-12)
        cd = np.clip(
            np.round(dec / sc[:, None, None]), -127, 127
        ).astype(np.int8)
        rh = cd.astype(np.float32) * sc[:, None, None]
        codes[c0:c1] = cd_pq.reshape(c1 - c0, s, m)
        bn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", rh, rh), np.inf)
        scale[c0:c1] = sc
    cn = np.einsum("kd,kd->k", cent, cent).astype(np.float32)
    cn[(members >= 0).sum(axis=1) == 0] = np.inf
    return {
        "pq": codes,
        "cb": np.asarray(pq.codebooks, np.float32),
        "rot": None if rot is None else np.asarray(rot, np.float32),
        "bn": bn,
        "rows": np.ascontiguousarray(members, dtype=np.int32),
        "scale": scale,
        "cent": cent,
        "cnorm2": cn,
    }


class MemHostTable:
    """In-memory host side of the cluster cache: the full coded table as
    numpy arrays (either encoded at open via _encode_host, or zero-copy
    views of persisted `ivfq.*` container sections)."""

    def __init__(self, h: dict):
        self.rows = h["rows"]
        self.cent = h["cent"]
        self.cnorm2 = h["cnorm2"]
        self.scale = h["scale"]
        # Transport representation: dense int8 rows ("sq8") or PQ codes
        # ("pq"/"opq" — m bytes/slot, decoded on device at admission).
        self.kind = "pq" if "pq" in h else "sq8"
        self.cb = h.get("cb")
        self.rot = h.get("rot")
        self._codes = h["pq"] if self.kind == "pq" else h["codes"]
        self._bn = h["bn"]

    def fetch(self, idx: np.ndarray):
        """(codes [m,S,d] i8 | pq [m,S,M] u8, bn [m,S] f32) for clusters
        `idx`."""
        return self._codes[idx], self._bn[idx]


class LazyHostTable:
    """Store-backed host side: cluster blocks come from block-granular ranged
    reads of the persisted `ivfq.*` sections (reference: lazy block reads
    through the (file, offset)-keyed cache, diskann/segment.go:1151,
    internal/cache/types.go:22-43). Only the small per-cluster arrays
    (centroids, norms, scales, membership) are resident; codes stay in the
    store — a CachingStore underneath gives the RAM/NVMe block-cache tiers.

    O(fetched clusters) bytes per miss batch, independent of N: a remote
    segment serves without ever downloading its vectors or code table."""

    def __init__(self, lazy, members: np.ndarray):
        self.lazy = lazy
        self.rows = np.ascontiguousarray(members, np.int32)
        self.cent = np.asarray(lazy.load("ivfq.cent"), np.float32)
        self.cnorm2 = np.asarray(lazy.load("ivfq.cnorm2"), np.float32)
        self.scale = np.asarray(lazy.load("ivfq.scale"), np.float32)
        self.kind = "pq" if lazy.has("ivfq.pq") else "sq8"
        self._codes_sec = "ivfq.pq" if self.kind == "pq" else "ivfq.codes"
        self.cb = (
            np.asarray(lazy.load("ivfq.cb"), np.float32)
            if lazy.has("ivfq.cb")
            else None
        )
        self.rot = (
            np.asarray(lazy.load("ivfq.rot"), np.float32)
            if lazy.has("ivfq.rot")
            else None
        )
        self.store_bytes = 0
        # Compressed sections can't be offset-sliced; materialize once and
        # serve from memory (correct, loses the O(block) read economics —
        # store codes uncompressed for the cloud tier).
        self._mem = None
        if any(
            lazy.entries.get(s, {}).get("compression")
            for s in (self._codes_sec, "ivfq.bn")
        ):
            self._mem = (lazy.load(self._codes_sec), lazy.load("ivfq.bn"))

    def fetch(self, idx: np.ndarray):
        if self._mem is not None:
            return self._mem[0][idx], self._mem[1][idx]
        k = len(idx)
        codes = [None] * k
        bn = [None] * k
        # Coalesce ascending runs of consecutive clusters into single ranged
        # reads (admission order is probe-rank order, so runs are common for
        # clustered query traffic after the k-means' locality).
        order = np.argsort(idx, kind="stable")
        i = 0
        while i < k:
            j = i
            while j + 1 < k and idx[order[j + 1]] == idx[order[j]] + 1:
                j += 1
            c0, c1 = int(idx[order[i]]), int(idx[order[j]]) + 1
            cblk = self.lazy.load_rows(self._codes_sec, c0, c1)
            bblk = self.lazy.load_rows("ivfq.bn", c0, c1)
            self.store_bytes += cblk.nbytes + bblk.nbytes
            for t in range(i, j + 1):
                codes[order[t]] = cblk[idx[order[t]] - c0]
                bn[order[t]] = bblk[idx[order[t]] - c0]
            i = j + 1
        return np.stack(codes), np.stack(bn)


def _probe_jit():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n_probe",))
    def _probe(q, cent, cnorm2, n_probe: int):
        qf = q.astype(jnp.float32)
        qn = jnp.sum(qf * qf, axis=-1)
        cd = (
            qn[:, None]
            + cnorm2[None, :]
            - 2.0
            * jax.lax.dot_general(
                q.astype(jnp.bfloat16), cent.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        _, probes = jax.lax.top_k(-cd, n_probe)
        return probes.astype(jnp.int32)

    return _probe


def _scan_jit():
    import jax

    from vecgo.ops import ivf as ivf_ops

    @functools.partial(jax.jit, static_argnames=("kk", "qcap", "group"))
    def _scan(qf, table, probes, mask_flat, *, kk, qcap, group):
        return ivf_ops._scan_groups(
            qf, table, probes, mask_flat, kk=kk, qcap=qcap, group=group
        )

    return _scan


def _write_jit():
    import jax

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
    def _write(codes_c, bn_c, rows_c, scale_c, cent_c, slots, bc, bb, br, bs, bce):
        return (
            codes_c.at[slots].set(bc),
            bn_c.at[slots].set(bb),
            rows_c.at[slots].set(br),
            scale_c.at[slots].set(bs),
            cent_c.at[slots].set(bce),
        )

    return _write


def _write_pq_jit():
    """Admission-time PQ decode: uploaded blocks are m bytes/slot; the cache
    keeps the dense int8 layout the grouped scan wants. The one-hot f32
    einsum is an exact codebook row-select (one 1.0 per row), so the device
    reproduces the host-side decode that bn/scale were computed from."""
    import jax
    import jax.numpy as jnp

    @functools.partial(
        jax.jit, donate_argnums=(0, 1, 2, 3, 4), static_argnames=("d", "use_rot")
    )
    def _write(
        codes_c, bn_c, rows_c, scale_c, cent_c,
        slots, pqb, cb, rot, bb, br, bs, bce, *, d, use_rot,
    ):
        mp, s, mm = pqb.shape
        ks = cb.shape[1]
        oh = (
            pqb[..., None].astype(jnp.int32)
            == jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, ks), 3)
        ).astype(jnp.float32)
        dec = jnp.einsum(
            "bsmk,mkd->bsmd", oh, cb, preferred_element_type=jnp.float32
        )
        dec = dec.reshape(mp, s, -1)[..., :d]
        if use_rot:
            dec = jnp.einsum("bsj,fj->bsf", dec, rot)  # un-rotate (OPQ)
        dec = jnp.where((br >= 0)[..., None], dec, 0.0)
        cd = jnp.clip(
            jnp.round(dec / bs[:, None, None]), -127, 127
        ).astype(jnp.int8)
        return (
            codes_c.at[slots].set(cd),
            bn_c.at[slots].set(bb),
            rows_c.at[slots].set(br),
            scale_c.at[slots].set(bs),
            cent_c.at[slots].set(bce),
        )

    return _write


class ClusterCachedTable:
    """Fixed-HBM coded serving table for beyond-HBM graph segments.

    device_bytes ≈ cache_clusters*S*(d+12) + K*(d+8): independent of N.
    `probe_and_scan` has the same results contract as ops/ivf.ivf_scan
    (dists vs decoded x̂; segment rows; -1 invalid) minus probes that had to
    be dropped when a batch's unique probe set exceeds the cache (counted in
    stats["dropped_probes"])."""

    def __init__(
        self,
        members: np.ndarray = None,  # [K, S] int32 (-1 padded) — e.g. seg.ivf_members
        vectors: np.ndarray = None,  # [N, d] f32 host vectors (encode at open)
        cache_clusters: int = 256,
        group: int = 8,
        host=None,  # MemHostTable | LazyHostTable (persisted-codes path)
    ):
        import jax.numpy as jnp

        if host is None:
            host = MemHostTable(
                _encode_host(np.asarray(members), np.asarray(vectors, np.float32))
            )
        self.host = host
        k, s = host.rows.shape
        self.k, self.s, self.d = k, s, host.cent.shape[1]
        c = int(min(max(group, cache_clusters), ((k + group - 1) // group) * group))
        c = ((c + group - 1) // group) * group
        self.c = c
        self.group = group
        self.cent_dev = jnp.asarray(host.cent)
        self.cnorm2_dev = jnp.asarray(host.cnorm2)
        # Cache buffers (slot-major). bn=+inf marks empty slots: a probe that
        # somehow hits an unfilled slot scores nothing.
        self.codes_c = jnp.zeros((c, s, self.d), jnp.int8)
        self.bn_c = jnp.full((c, s), jnp.inf, jnp.float32)
        self.rows_c = jnp.full((c, s), -1, jnp.int32)
        self.scale_c = jnp.ones((c,), jnp.float32)
        self.cent_c = jnp.zeros((c, self.d), jnp.float32)
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # cluster -> slot
        self._free = list(range(c))[::-1]
        self._probe = _probe_jit()
        self._scan = _scan_jit()
        self._write = _write_jit()
        self._write_pq = None
        self._cb_dev = self._rot_dev = None
        if getattr(host, "kind", "sq8") == "pq":
            self._write_pq = _write_pq_jit()
            self._cb_dev = jnp.asarray(host.cb)
            self._rot_dev = (
                jnp.asarray(host.rot)
                if host.rot is not None
                else jnp.zeros((1, 1), jnp.float32)
            )
        self.stats = {
            "hits": 0, "misses": 0, "h2d_bytes": 0, "dropped_probes": 0,
            "batches": 0,
        }

    def device_bytes(self) -> int:
        return int(
            self.c * (self.s * (self.d + 4 + 4) + self.d * 4 + 4)
            + self.k * (self.d * 4 + 4)
        )

    # ------------------------------------------------------------------
    def _ensure_cached(self, wanted: np.ndarray) -> dict:
        """LRU-admit `wanted` clusters (probe-rank order); returns
        cluster -> slot for everything now resident."""
        import jax.numpy as jnp

        missing = [int(cl) for cl in wanted if cl not in self._lru]
        for cl in wanted:
            cl = int(cl)
            if cl in self._lru:
                self._lru.move_to_end(cl)
        n_admit = min(len(missing), self.c)
        if n_admit < len(missing):
            self.stats["dropped_probes"] += len(missing) - n_admit
            missing = missing[:n_admit]
        self.stats["hits"] += len(wanted) - len(missing)
        self.stats["misses"] += len(missing)
        if missing:
            wanted_set = set(int(x) for x in wanted)
            slots = []
            for cl in missing:
                if self._free:
                    slot = self._free.pop()
                else:
                    # Evict LRU not wanted by THIS batch.
                    victim = None
                    for cand in self._lru:
                        if cand not in wanted_set:
                            victim = cand
                            break
                    if victim is None:  # whole cache is wanted; drop instead
                        self.stats["dropped_probes"] += 1
                        continue
                    slot = self._lru.pop(victim)
                slots.append(slot)
                self._lru[cl] = slot
                self._lru.move_to_end(cl)
            admitted = missing[: len(slots)]
            if slots:
                h = self.host
                idx = np.asarray(admitted, np.int64)
                codes_b, bn_b = h.fetch(idx)  # host RAM or store ranged reads
                # Pad the upload to a power-of-two chunk (bounded jit-shape
                # churn); duplicate the last entry — same slot written twice
                # with identical data.
                m = len(slots)
                mp = 1 << (m - 1).bit_length()
                pad = mp - m
                slots_a = np.asarray(slots + [slots[-1]] * pad, np.int32)
                idx_p = np.concatenate([idx, np.repeat(idx[-1:], pad)])
                pad_sel = np.concatenate(
                    [np.arange(m), np.full(pad, m - 1, np.int64)]
                )
                if self._write_pq is not None:
                    out = self._write_pq(
                        self.codes_c, self.bn_c, self.rows_c, self.scale_c,
                        self.cent_c,
                        jnp.asarray(slots_a),
                        jnp.asarray(codes_b[pad_sel]),
                        self._cb_dev,
                        self._rot_dev,
                        jnp.asarray(bn_b[pad_sel]),
                        jnp.asarray(h.rows[idx_p]),
                        jnp.asarray(h.scale[idx_p]),
                        jnp.asarray(h.cent[idx_p]),
                        d=self.d,
                        use_rot=getattr(h, "rot", None) is not None,
                    )
                else:
                    out = self._write(
                        self.codes_c, self.bn_c, self.rows_c, self.scale_c,
                        self.cent_c,
                        jnp.asarray(slots_a),
                        jnp.asarray(codes_b[pad_sel]),
                        jnp.asarray(bn_b[pad_sel]),
                        jnp.asarray(h.rows[idx_p]),
                        jnp.asarray(h.scale[idx_p]),
                        jnp.asarray(h.cent[idx_p]),
                    )
                (
                    self.codes_c, self.bn_c, self.rows_c,
                    self.scale_c, self.cent_c,
                ) = out
                # Per-cluster transport bytes: codes row (d for sq8, m for
                # pq) + bn row + centroid + scale.
                self.stats["h2d_bytes"] += int(
                    mp
                    * (
                        codes_b.nbytes // max(m, 1)
                        + self.s * 4
                        + self.d * 4
                        + 4
                    )
                )
        return self._lru

    def probe_and_scan(
        self,
        q,  # jnp/np [B, d]
        n_probe: int,
        kk: int,
        qcap: int = 0,
        row_mask: Optional[np.ndarray] = None,  # [N] bool host mask
    ) -> Tuple:
        """Two-stage stage 1 with bounded HBM. Returns (dists [B, P*kk] f32,
        seg_rows [B, P*kk] i32, -1 invalid)."""
        import jax.numpy as jnp

        from vecgo.ops import ivf as ivf_ops

        self.stats["batches"] += 1
        qd = q if hasattr(q, "dtype") and not isinstance(q, np.ndarray) else jnp.asarray(
            np.asarray(q, np.float32)
        )
        b = qd.shape[0]
        n_probe = int(min(n_probe, self.k))
        probes = np.asarray(
            self._probe(qd, self.cent_dev, self.cnorm2_dev, n_probe)
        )  # [B, P] host (small D2H)
        # Admission order = probe rank (rank-0 probes matter most under
        # cache pressure).
        wanted = []
        seen = set()
        cn_host = self.host.cnorm2
        for rank in range(n_probe):
            for cl in probes[:, rank]:
                cl = int(cl)
                if cl not in seen and np.isfinite(cn_host[cl]):
                    seen.add(cl)
                    wanted.append(cl)
        slot_of = self._ensure_cached(np.asarray(wanted, np.int64))
        # Remap probes to cache slots; missing -> dump (self.c).
        lut = np.full(self.k + 1, self.c, np.int32)
        for cl, slot in slot_of.items():
            lut[cl] = slot
        probes_m = lut[probes]

        if qcap == 0:
            # Exact no-drop capacity: the probe matrix is already host-side,
            # so size qcap to the PEAK per-cluster query load, not an
            # average-based guess. Clustered traffic (this tier's stated
            # economics) concentrates probes — an average-derived qcap
            # silently drops rank-0 probes on hot clusters; peak-sizing makes
            # the cost adapt to the batch's actual concentration instead.
            cnt = np.bincount(probes_m.ravel(), minlength=self.c + 1)[: self.c]
            peak = int(cnt.max()) if cnt.size else 1
            qcap = max(32, (peak + 31) // 32 * 32)
        qcap = min(qcap, b)
        mask_flat = None
        if row_mask is not None:
            rows_h = self.host.rows
            # Lift the [N] row mask into the CACHED slot space on host (the
            # cache is small; [C*S] bool uploads per batch are cheap).
            order = np.asarray(list(slot_of.items()), np.int64)
            mk = np.zeros((self.c, self.s), bool)
            if len(order):
                cls, sls = order[:, 0], order[:, 1]
                rr = rows_h[cls]
                mk[sls] = np.asarray(row_mask)[np.maximum(rr, 0)] & (rr >= 0)
            mask_flat = jnp.asarray(mk.reshape(-1))

        table = ivf_ops.IVFCodedTable(
            codes=self.codes_c,
            scale=self.scale_c,
            bnorm2=self.bn_c,
            xnorm2=self.bn_c,  # unused by the scan; placeholder of same shape
            rows=self.rows_c,
            slot_of_row=self.scale_c.astype(jnp.int32),  # unused placeholder
            centroids=self.cent_c,
            cnorm2=self.scale_c,  # unused by _scan_groups
        )
        return self._scan(
            qd.astype(jnp.float32), table, jnp.asarray(probes_m), mask_flat,
            kk=kk, qcap=qcap, group=self.group,
        )


__all__ = ["ClusterCachedTable", "MemHostTable", "LazyHostTable"]

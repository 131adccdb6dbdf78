"""Jitted Lloyd's k-means (reference: internal/kmeans/kmeans.go TrainKMeans:16).

Device-first restructuring: assignment is a blockwise [block, K] distance matmul
with a scan-carried (sums, counts) reduction, so memory stays O(block*K) instead
of O(N*K). Multiple codebooks (PQ's M subspaces) train simultaneously via vmap
over a leading group axis — the reference's worker-parallel training
(quantization/pq.go:275-434) becomes one batched device program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vecgo.ops import distance as dist_ops


@functools.partial(jax.jit, static_argnames=("iters", "block_rows"))
def _lloyd(x, centers, iters: int, block_rows: int):
    """x [N, d] (N % block_rows == 0), centers [K, d] -> (centers, inertia)."""
    n, d = x.shape
    k = centers.shape[0]
    xb = x.reshape(n // block_rows, block_rows, d)
    x_norms = dist_ops.row_norms_sq(x).reshape(n // block_rows, block_rows)

    def iteration(centers, _):
        c_norms = dist_ops.row_norms_sq(centers)

        def assign_block(carry, inputs):
            sums, counts, inertia = carry
            blk, blk_norms = inputs
            # [block, K] distances; one matrix product.
            dmat = (
                blk_norms[:, None]
                + c_norms[None, :]
                - 2.0
                * jax.lax.dot_general(
                    blk,
                    centers,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=dist_ops.F32_DOT,
                )
            )
            assign = jnp.argmin(dmat, axis=1)
            best = jnp.min(dmat, axis=1)
            # Scatter-free cluster reduction: a one-hot matrix product in
            # place of serialized scatter-adds.
            onehot = (
                assign[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, k), 1)
            ).astype(jnp.float32)
            sums = sums + jax.lax.dot_general(
                onehot,
                blk,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            counts = counts + jnp.sum(onehot, axis=0)
            inertia = inertia + jnp.sum(jnp.maximum(best, 0.0))
            return (sums, counts, inertia), None

        init = (
            jnp.zeros((k, d), jnp.float32),
            jnp.zeros((k,), jnp.float32),
            jnp.float32(0.0),
        )
        (sums, counts, inertia), _ = jax.lax.scan(assign_block, init, (xb, x_norms))
        new_centers = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], centers
        )
        return new_centers, inertia

    centers, inertias = jax.lax.scan(iteration, centers, None, length=iters)
    return centers, inertias[-1]


@functools.partial(jax.jit, static_argnames=("k",))
def _kmeanspp_init_jit(x, key, k: int):
    """k-means++ D^2 seeding as ONE device program.

    The host-numpy loop below pays k full passes over the sample on the
    CPU; here each step is a [n,d]@[d] matvec inside a lax.scan — sub-second total.
    """
    n, d = x.shape
    xn = dist_ops.row_norms_sq(x)

    def dist_to(c):
        return jnp.maximum(xn + jnp.sum(c * c) - 2.0 * (x @ c), 0.0)

    key, sub = jax.random.split(key)
    i0 = jax.random.randint(sub, (), 0, n)
    c0 = x[i0]

    def step(carry, i):
        centers, d2, key = carry
        key, sub = jax.random.split(key)
        # Sample index with probability ∝ D^2; if every distance is zero
        # (duplicate-heavy sample) fall back to uniform.
        any_mass = jnp.any(d2 > 0)
        logits = jnp.where(
            any_mass,
            jnp.where(d2 > 0, jnp.log(jnp.maximum(d2, 1e-30)), -jnp.inf),
            jnp.zeros_like(d2),
        )
        idx = jax.random.categorical(sub, logits)
        c = x[idx]
        centers = centers.at[i].set(c)
        d2 = jnp.minimum(d2, dist_to(c))
        return (centers, d2, key), None

    centers0 = jnp.zeros((k, d), jnp.float32).at[0].set(c0)
    (centers, _, _), _ = jax.lax.scan(
        step, (centers0, dist_to(c0), key), jnp.arange(1, k)
    )
    return centers


def _kmeanspp_init(x: np.ndarray, k: int, r: np.random.Generator) -> np.ndarray:
    """k-means++ D^2 seeding (host numpy reference; superseded by
    _kmeanspp_init_jit on the train path)."""
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), np.float32)
    centers[0] = x[r.integers(n)]
    d2 = ((x - centers[0][None]) ** 2).sum(1)
    for i in range(1, k):
        total = d2.sum()
        if not np.isfinite(total) or total <= 0:
            centers[i:] = x[r.choice(n, k - i, replace=False)]
            break
        probs = d2 / total
        idx = r.choice(n, p=probs)
        centers[i] = x[idx]
        d2 = np.minimum(d2, ((x - centers[i][None]) ** 2).sum(1))
    return centers


def train_kmeans(
    x: np.ndarray,
    k: int,
    iters: int = 15,
    seed: int = 42,
    block_rows: int = 4096,
    sample: int = 65536,
):
    """Train k centroids on x [N, d]; returns (centers [k, d] f32, inertia).

    Subsamples to `sample` rows for training (the reference trains PQ on a
    sample as well). Init = k distinct random rows (k-means++-lite analogue).
    """
    r = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n > sample:
        x = x[r.choice(n, sample, replace=False)]
        n = sample
    if n < k:
        # Degenerate: fewer points than clusters; pad with jittered repeats.
        reps = x[r.integers(0, max(n, 1), size=k - n)] if n else np.zeros((k, x.shape[1]), np.float32)
        jitter = r.standard_normal(reps.shape).astype(np.float32) * 1e-4
        centers = np.concatenate([x, reps + jitter], 0)
        return centers.astype(np.float32), 0.0
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    if pad:
        # Pad with repeats of existing rows: harmless for assignment stats
        # (they only weight the means slightly); keeps shapes static.
        x = np.concatenate([x, x[:pad]], 0)
    xd = jnp.asarray(x)
    # k-means++ seeding for moderate k (quality matters most there); plain
    # random distinct rows for large k — as good after a few Lloyd rounds.
    # Seeding runs on DEVICE over the same uploaded sample (one extra
    # matvec-scan program instead of the old host loop).
    if k <= 256:
        init = _kmeanspp_init_jit(xd[:n], jax.random.PRNGKey(seed), k)
    else:
        init = jnp.asarray(x[r.choice(n, k, replace=False)])
    centers, inertia = _lloyd(xd, init, iters, block_rows)
    return np.asarray(centers), float(inertia)


def train_kmeans_dev(
    x,
    k: int,
    iters: int = 15,
    seed: int = 42,
    block_rows: int = 4096,
    sample: int = 65536,
):
    """Device-resident train_kmeans: x is a jax.Array already on device and
    the returned (centers [k, d] f32, inertia) are DEVICE values — zero
    host↔device traffic end-to-end (train_kmeans's host round-trip moves the
    training sample D2H and the centers both ways). Sampling/seeding indices come from host RNG (tiny uploads)
    so the math matches train_kmeans's semantics.

    Callers needing host centers pay the (small) D2H themselves. Assumes
    n >= k (the degenerate pad path stays host-only in train_kmeans).
    """
    r = np.random.default_rng(seed)
    n = int(x.shape[0])
    if n > sample:
        idx = r.choice(n, sample, replace=False)
        x = jnp.take(x, jnp.asarray(idx, dtype=jnp.int32), axis=0)
        n = sample
    x = x.astype(jnp.float32)
    block_rows = min(block_rows, n)
    pad = (-n) % block_rows
    if pad:
        x = jnp.concatenate([x, x[:pad]], axis=0)
    if k <= 256:
        init = _kmeanspp_init_jit(x[:n], jax.random.PRNGKey(seed), k)
    else:
        init = jnp.take(
            x, jnp.asarray(r.choice(n, k, replace=False), dtype=jnp.int32), axis=0
        )
    return _lloyd(x, init, iters, block_rows)


def train_kmeans_grouped(
    x_groups: np.ndarray,  # [G, N, dsub]
    k: int,
    iters: int = 15,
    seed: int = 42,
    sample: int = 65536,
):
    """Train G codebooks simultaneously (PQ subspaces). Returns [G, k, dsub]."""
    r = np.random.default_rng(seed)
    g, n, dsub = x_groups.shape
    x_groups = np.asarray(x_groups, np.float32)
    if n > sample:
        idx = r.choice(n, sample, replace=False)
        x_groups = x_groups[:, idx]
        n = sample
    if n < k:
        out = np.stack(
            [train_kmeans(x_groups[i], k, iters, seed + i)[0] for i in range(g)]
        )
        return out
    init_idx = r.choice(n, k, replace=False)
    init = x_groups[:, init_idx]  # [G, k, dsub]
    block_rows = min(4096, n)
    pad = (-n) % block_rows
    if pad:
        x_groups = np.concatenate([x_groups, x_groups[:, :pad]], 1)
    lloyd = jax.vmap(lambda xs, cs: _lloyd(xs, cs, iters, block_rows))
    centers, _ = lloyd(jnp.asarray(x_groups), jnp.asarray(init))
    return np.asarray(centers)


@functools.partial(jax.jit, static_argnames=("block_rows",))
def _assign_jit(x, centers, block_rows: int):
    n, d = x.shape
    xb = x.reshape(n // block_rows, block_rows, d)
    c_norms = dist_ops.row_norms_sq(centers)
    cdt = x.dtype if x.dtype == jnp.bfloat16 else None

    def body(_, blk):
        dmat = dist_ops.squared_l2(blk, centers, c_norms, compute_dtype=cdt)
        return None, (jnp.argmin(dmat, 1).astype(jnp.int32), jnp.min(dmat, 1))

    _, (assign, dists) = jax.lax.scan(body, None, xb)
    return assign.reshape(-1), dists.reshape(-1)


def assign_partitions(
    x: np.ndarray,
    centers: np.ndarray,
    block_rows: int = 65536,
    transfer_dtype=None,  # jnp.bfloat16 halves the H2D bytes (coarse
    #                       assignment is boundary-fuzz tolerant)
):
    """Nearest-centroid assignment (reference: kmeans.AssignPartition:142).

    Returns (assign [N] int32, dist [N] f32).
    """
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    block_rows = min(block_rows, max(n, 1))
    pad = (-n) % block_rows
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)], 0)
    xd = jnp.asarray(x, dtype=transfer_dtype) if transfer_dtype else jnp.asarray(x)
    a, dist = _assign_jit(xd, jnp.asarray(centers), block_rows)
    return np.asarray(a[:n]), np.asarray(dist[:n])


def closest_centroids(q: np.ndarray, centers: np.ndarray, nprobe: int):
    """Per-query nprobe nearest centroids (reference: kmeans.FindClosestCentroids:217)."""
    from vecgo.ops import topk as topk_ops

    d, i = topk_ops.topk_smallest(
        dist_ops.squared_l2(jnp.asarray(q, jnp.float32), jnp.asarray(centers)),
        min(nprobe, centers.shape[0]),
    )
    return np.asarray(i), np.asarray(d)

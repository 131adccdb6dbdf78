"""Batched lockstep graph search + vectorized RobustPrune.

This is the device restructuring of the reference's pointer-chasing traversals —
HNSW searchLayer (hnsw/hnsw.go:1120, KNNSearchWithContext:1755) and DiskANN
beam search (diskann/segment.go:503-708) — and of the Vamana builder's
RobustPrune (diskann/writer.go:571-625).

Design (SURVEY.md §7.1):
- B queries walk the graph in lockstep. Per-query state is a fixed-width
  search list of `ef` (id, dist, expanded) triples — exactly DiskANN's L-list,
  kept as dense arrays instead of a heap, and kept SORTED by distance.
- Each step expands the `beam_width` nearest unexpanded entries, gathers their
  [W, R] neighbor rows, dedups against the list, scores all new candidates
  with one batched matmul, and merges via a single 3-operand lax.sort.
- Termination: lax.while_loop until every query's list is fully expanded (or
  max_steps). No host sync inside the loop.
- Filtered search keeps a separate masked result list (post-filter quality in
  a single pass: traversal is unmasked, results are masked) — replacing the
  reference's 4 traversal modes (hnsw.go:1220/1159/1406/1711). With no mask
  the result IS the search list, so no extra per-step work.

Performance notes (not yet measured on the GPU): per-row
top_k/take_along_axis on [B, ef+W*R] tiles were the throughput limiters
inside loops, NOT the gathers or matmuls. Hence:
- list maintenance uses two multi-operand lax.sorts per step — an
  (id, dist)-keyed sort for exact id-dedup, then a dist-keyed re-sort —
  replacing O(B*M^2) compare matrices and all take_along_axis gathers,
- beam selection uses rank-mask arithmetic + a masked weighted-sum extraction
  (elementwise only, no sort/gather/scatter),
- `expanded` updates are elementwise mask ops (no scatter).

The visited-dedup is list-local: a node that falls off the ef-list can be
re-scored later. This trades a little extra compute for O(ef) state — the
lockstep analogue of the reference's epoch visited set (searcher/visited.go).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_INF = jnp.inf
_BIG = jnp.float32(3.0e38)


def _score_rows(q_bf16, qn, vectors, rnorm2, ids):
    """Distances from q [B,d] to vectors[ids] [B,M] via gathered matmul."""
    b, m = ids.shape
    safe = jnp.maximum(ids, 0)
    v = jnp.take(vectors, safe.reshape(-1), axis=0).reshape(b, m, -1)
    prod = jnp.einsum(
        "bmd,bd->bm", v, q_bf16, preferred_element_type=jnp.float32
    )
    return qn + jnp.take(rnorm2, safe) - 2.0 * prod


def _extract_by_rank(values, rank_mask_rank, w, fill):
    """values [B, L] -> [B, W]: entry with rank r (1-based, where mask) lands in
    column r-1; pure compare+weighted-sum (no sort/gather).

    rank_mask_rank: int32 [B, L], >=1 where selected (its output column + 1),
    0 where not selected.
    """
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, w, 1), 1)
    m = (rank_mask_rank[:, None, :] == cols + 1)  # [B, W, L]
    picked = jnp.sum(
        jnp.where(m, values[:, None, :], 0), axis=2
    )
    any_ = jnp.any(m, axis=2)
    return jnp.where(any_, picked, fill), any_


def beam_search(
    q,  # [B, d] float
    vectors,  # [N, d] (bf16 traversal copy)
    rnorm2,  # [N] f32
    graph,  # [N, R] int32, -1 padded
    entry_ids,  # [E] shared entry points, or [B, E] per-query (IVF-guided)
    *,
    ef: int,
    k: int,
    beam_width: int = 8,
    max_steps: int = 0,
    mask=None,  # [N] bool or None: result filter (traversal unrestricted)
    with_visited: bool = False,
):
    """Batched greedy/beam search. Returns (res_d [B,k], res_i [B,k]) plus,
    when with_visited, the final search list (cand_d [B,ef], cand_i [B,ef]).

    Jit policy: each static config (incl. masked-ness) gets its OWN jit
    object (`_beam_jit`) — jax-0.9.0 occasionally collides cache entries
    when one jitted function alternates None<->array optional args
    ("Execution supplied 5 buffers but compiled program expected 6");
    per-variant jits make that structurally impossible (utils/devbug.py).
    """
    if max_steps == 0:
        # Enough steps to (a) expand every list slot once (ef/W) and (b) walk
        # from the entry point to a query's neighborhood (~graph diameter,
        # which grows with log N). Capping here (instead of ef steps) matters:
        # one straggler query otherwise keeps the whole batch iterating.
        import math

        n = vectors.shape[0]
        max_steps = ef // max(beam_width, 1) + 8 + int(
            math.ceil(math.log2(max(n, 2)))
        )
    from vecgo.utils.devbug import dispatch_guarded

    fn = _beam_jit(ef, k, beam_width, max_steps, with_visited, mask is not None)
    if mask is not None:
        return dispatch_guarded(fn, q, vectors, rnorm2, graph, entry_ids, mask)
    return dispatch_guarded(fn, q, vectors, rnorm2, graph, entry_ids)


@functools.lru_cache(maxsize=None)
def _beam_jit(ef, k, beam_width, max_steps, with_visited, masked):
    def unmasked(q, v, rn, g, e):
        return beam_search_traced(
            q, v, rn, g, e, ef=ef, k=k, beam_width=beam_width,
            max_steps=max_steps, with_visited=with_visited,
        )

    def masked_fn(q, v, rn, g, e, m):
        return beam_search_traced(
            q, v, rn, g, e, mask=m, ef=ef, k=k, beam_width=beam_width,
            max_steps=max_steps, with_visited=with_visited,
        )

    return jax.jit(masked_fn if masked else unmasked)


def beam_search_traced(
    q,
    vectors,
    rnorm2,
    graph,
    entry_ids,
    *,
    ef: int,
    k: int,
    beam_width: int = 8,
    max_steps: int = 0,
    mask=None,
    with_visited: bool = False,
    score_fn=None,  # optional ids[B,M] -> dists[B,M] (e.g. SQ8-coded scorer)
):
    """Un-jitted beam search body — call this from INSIDE other jitted
    programs (nesting jits feeds the cache-collision bug above).

    With score_fn set, `vectors`/`rnorm2` may be None: all candidate scoring
    goes through the closure (the quantized-serving path scores int8 residual
    codes instead of a bf16 full copy — reference: diskann beam over PQ/INT4
    distances, segment.go:503-708)."""
    b, d = q.shape
    r = graph.shape[1]
    w = beam_width
    m = w * r
    if max_steps == 0:
        import math

        n = graph.shape[0]
        max_steps = ef // w + 8 + int(math.ceil(math.log2(max(n, 2))))

    qf = q.astype(jnp.float32)
    q16 = q.astype(jnp.bfloat16)
    qn = jnp.sum(qf * qf, axis=-1, keepdims=True)  # [B,1]
    if score_fn is None:
        score_fn = lambda ids: _score_rows(q16, qn, vectors, rnorm2, ids)  # noqa: E731

    e = entry_ids.shape[-1]
    if entry_ids.ndim == 1:
        init_ids = jnp.broadcast_to(entry_ids[None, :], (b, e)).astype(jnp.int32)
    else:
        init_ids = entry_ids.astype(jnp.int32)
    init_d = score_fn(init_ids)
    init_d = jnp.where(init_ids >= 0, init_d, _BIG)
    pad = ef - e
    cand_ids = jnp.concatenate([init_ids, jnp.full((b, pad), -1, jnp.int32)], axis=1)
    cand_d = jnp.concatenate([init_d, jnp.full((b, pad), _BIG, jnp.float32)], axis=1)
    # Establish the sorted-list invariant (sentinels carry _BIG -> tail) and
    # drop duplicate entry points (per-query entries may repeat the medoid).
    cand_d, cand_ids = _dedup_topk(cand_d, cand_ids, ef)
    expanded = cand_ids < 0  # sentinels count as expanded

    track_res = mask is not None
    if track_res:
        allowed0 = jnp.take(mask, jnp.maximum(init_ids, 0)) & (init_ids >= 0)
        rd0 = jnp.where(allowed0, init_d, _BIG)
        kpad = max(k - e, 0)
        res_d = jnp.concatenate([rd0, jnp.full((b, kpad), _BIG)], axis=1)
        res_i = jnp.concatenate(
            [init_ids, jnp.full((b, kpad), -1, jnp.int32)], axis=1
        )
        res_d, res_i = _dedup_topk(res_d, res_i, k)
    else:
        res_d = jnp.zeros((b, 1), jnp.float32)
        res_i = jnp.zeros((b, 1), jnp.int32)

    def cond(state):
        step, cand_ids, cand_d, expanded, res_d, res_i = state
        active = jnp.any(~expanded & (cand_d < _BIG))
        return (step < max_steps) & active

    def body(state):
        step, cand_ids, cand_d, expanded, res_d, res_i = state
        # ---- select the W nearest unexpanded (list is sorted) ----
        unexp = (~expanded) & (cand_d < _BIG)
        rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        selm = unexp & (rank <= w)
        sel_rank = jnp.where(selm, rank, 0)
        sel_ids, sel_ok = _extract_by_rank(cand_ids, sel_rank, w, jnp.int32(-1))
        expanded = expanded | selm

        # ---- expand: gather neighbor lists ----
        nbrs = jnp.take(graph, jnp.maximum(sel_ids, 0), axis=0)  # [B, W, R]
        nbrs = jnp.where(sel_ok[:, :, None], nbrs, -1).reshape(b, m)
        fresh = nbrs >= 0

        # ---- score ----
        d_new = score_fn(nbrs)
        d_new = jnp.where(fresh, d_new, _BIG)

        # ---- merge into the sorted ef-list ----
        # Dedup by id via a (id, dist)-keyed sort: duplicate ids land adjacent
        # (min-dist copy first); kill the later copies, then re-sort by dist.
        # Two multi-operand sorts are O(B*(ef+M)) — replacing O(B*M^2)
        # compare matrices that dominated wide-beam build steps.
        all_d = jnp.concatenate([cand_d, d_new], axis=1)
        all_i = jnp.concatenate([cand_ids, nbrs], axis=1)
        all_e = jnp.concatenate([expanded, jnp.zeros_like(fresh)], axis=1).astype(
            jnp.int8
        )
        si, sd, se = jax.lax.sort((all_i, all_d, all_e), num_keys=2)
        w_all = si.shape[1]
        pos = jax.lax.broadcasted_iota(jnp.int32, si.shape, 1)
        # The kept (first) copy must inherit "expanded" from any later copy:
        # EXACT segmented suffix-OR over id-groups in log2(W) doubling
        # strides (replaces the round-2 two-pass heuristic, which could let a
        # node in a >3-copy group re-expand).
        stride = 1
        while stride < w_all:
            same = (si == jnp.roll(si, -stride, axis=1)) & (
                pos < w_all - stride
            )
            se = se | (jnp.roll(se, -stride, axis=1) & same.astype(jnp.int8))
            stride *= 2
        dup = (si == jnp.roll(si, 1, axis=1)) & (pos > 0) & (si >= 0)
        sd = jnp.where(dup, _BIG, sd)
        si = jnp.where(dup, -1, si)
        se = jnp.where(dup, jnp.int8(1), se)
        sd, si, se = jax.lax.sort((sd, si, se), num_keys=1)
        cand_d = sd[:, :ef]
        cand_ids = si[:, :ef]
        expanded = se[:, :ef] > 0

        # ---- masked result list (only when filtering) ----
        if track_res:
            allowed = jnp.take(mask, jnp.maximum(nbrs, 0)) & fresh
            rd = jnp.where(allowed, d_new, _BIG)
            md = jnp.concatenate([res_d, rd], axis=1)
            mi = jnp.concatenate([res_i, nbrs], axis=1)
            res_d, res_i = _dedup_topk(md, mi, k)

        return step + 1, cand_ids, cand_d, expanded, res_d, res_i

    state = (jnp.int32(0), cand_ids, cand_d, expanded, res_d, res_i)
    _, cand_ids, cand_d, expanded, res_d, res_i = jax.lax.while_loop(
        cond, body, state
    )
    if not track_res:
        res_d, res_i = cand_d[:, :k], cand_ids[:, :k]
    res_d = jnp.where(res_d >= _BIG, _INF, res_d)
    res_i = jnp.where(jnp.isfinite(res_d), res_i, -1)
    if with_visited:
        cand_d = jnp.where(cand_d >= _BIG, _INF, cand_d)
        return res_d, res_i, cand_d, cand_ids
    return res_d, res_i


def coded_score_closure(q, qc, table):
    """Scorer over an ops.ivf.IVFCodedTable for beam_search_traced: candidate
    row ids -> distances to the DECODED vectors x̂ = c + s*code.

    d(q, x̂) = |q|² + |x̂|² - 2(q·c + s·(q·code)); q·c comes from the
    precomputed [B, K] centroid products (`qc` — shared with probe
    selection), so each candidate costs one int8 row gather (d bytes — half
    the bf16 traversal copy's traffic) plus three scalar gathers."""
    k_pad, s, d = table.codes.shape
    codes_flat = table.codes.reshape(k_pad * s, d)
    xn_flat = table.xnorm2.reshape(-1)
    qf = q.astype(jnp.float32)
    q16 = q.astype(jnp.bfloat16)
    qn = jnp.sum(qf * qf, axis=-1, keepdims=True)  # [B,1]

    def score(ids):
        b, m = ids.shape
        safe = jnp.maximum(ids, 0)
        slot = jnp.take(table.slot_of_row, safe)  # [B, M]
        cl = slot // s
        cv = jnp.take(codes_flat, slot.reshape(-1), axis=0).reshape(b, m, d)
        prod = jnp.einsum(
            "bmd,bd->bm", cv.astype(jnp.bfloat16), q16,
            preferred_element_type=jnp.float32,
        )
        sc = jnp.take(table.scale, cl)
        qcv = jnp.take_along_axis(qc, cl, axis=1)
        xn = jnp.take(xn_flat, slot)
        return qn + xn - 2.0 * (qcv + sc * prod)

    return score


def beam_search_coded(
    q, table, graph, entry_ids, qc, *, ef, k, beam_width=4, max_steps=0,
    mask=None,
):
    """Beam search scoring SQ8 residual codes (quantized serving: the codes
    table is the only vector data in HBM). Per-variant jit objects as in
    beam_search."""
    from vecgo.utils.devbug import dispatch_guarded

    if max_steps == 0:
        import math

        n = graph.shape[0]
        max_steps = ef // max(beam_width, 1) + 8 + int(
            math.ceil(math.log2(max(n, 2)))
        )
    fn = _beam_coded_jit(ef, k, beam_width, max_steps, mask is not None)
    if mask is not None:
        return dispatch_guarded(fn, q, table, graph, entry_ids, qc, mask)
    return dispatch_guarded(fn, q, table, graph, entry_ids, qc)


@functools.lru_cache(maxsize=None)
def _beam_coded_jit(ef, k, beam_width, max_steps, masked):
    kw = dict(ef=ef, k=k, beam_width=beam_width, max_steps=max_steps)

    def unmasked(q, table, g, e, qc):
        return beam_search_traced(
            q, None, None, g, e,
            score_fn=coded_score_closure(q, qc, table), **kw,
        )

    def masked_fn(q, table, g, e, qc, m):
        return beam_search_traced(
            q, None, None, g, e, mask=m,
            score_fn=coded_score_closure(q, qc, table), **kw,
        )

    return jax.jit(masked_fn if masked else unmasked)


def _dedup_topk(d, i, k: int):
    """Unique-by-id top-k: (id, dist)-keyed sort makes duplicate ids adjacent
    with the best copy first; kill the rest, re-sort by dist, slice k."""
    si, sd = jax.lax.sort((i, d), num_keys=2)
    pos = jax.lax.broadcasted_iota(jnp.int32, si.shape, 1)
    dup = (si == jnp.roll(si, 1, axis=1)) & (pos > 0) & (si >= 0)
    sd = jnp.where(dup, _BIG, sd)
    si = jnp.where(dup, -1, si)
    sd, si = jax.lax.sort((sd, si), num_keys=1)
    return sd[:, :k], si[:, :k]


def robust_prune(
    p_ids,
    p_vecs,
    cand_ids,
    vectors,
    rnorm2,
    *,
    r_out: int,
    alpha: float,
    vectors_occ=None,
    rnorm2_occ=None,
    lazy_occlusion=None,
):
    """Jitted entry point for direct callers; per-variant jit objects (see
    beam_search). Inside an already-jitted program call robust_prune_traced."""
    from vecgo.utils.devbug import dispatch_guarded

    fn = _prune_jit(r_out, float(alpha), False, vectors_occ is not None)
    if vectors_occ is not None:
        return dispatch_guarded(
            fn, p_ids, p_vecs, cand_ids, vectors, rnorm2, vectors_occ, rnorm2_occ
        )
    return dispatch_guarded(fn, p_ids, p_vecs, cand_ids, vectors, rnorm2)


@functools.lru_cache(maxsize=None)
def _prune_jit(r_out, alpha, lazy, has_occ):
    kw = dict(r_out=r_out, alpha=alpha, lazy_occlusion=lazy)
    if has_occ:
        return jax.jit(
            lambda pi, pv, c, v, rn, vo, rno: robust_prune_traced(
                pi, pv, c, v, rn, vectors_occ=vo, rnorm2_occ=rno, **kw
            )
        )
    return jax.jit(
        lambda pi, pv, c, v, rn: robust_prune_traced(pi, pv, c, v, rn, **kw)
    )


def robust_prune_traced(
    p_ids,  # [C] int32 node being pruned (excluded from its own candidates)
    p_vecs,  # [C, d]
    cand_ids,  # [C, L] int32, -1 padded
    vectors,  # [N, d]
    rnorm2,  # [N] f32
    *,
    r_out: int,
    alpha: float,
    vectors_occ=None,  # [N, d'] optional low-dim projection for the occlusion
    rnorm2_occ=None,  # [N] norms of vectors_occ
    lazy_occlusion=None,  # accepted for API compatibility; ignored
    pick_batch: int = 8,
    impl: str = "batched",  # "batched" (default) | "seq" (fallback)
):
    """Vectorized RobustPrune (reference: diskann/writer.go:571-625).

    Semantics: scan candidates in ascending d(p, ·) order; keep a candidate
    unless an already-kept neighbor c occludes it (alpha * d(c, x) <= d(p, x));
    stop at r_out keepers. This equals the reference's pick-the-min loop —
    the sequential pick order IS the d_p order, and killed candidates are
    simply skipped.

    Device formulation ("keepers-centric batched greedy"): candidates are sorted
    by d_p once, then processed in CONTIGUOUS batches of `pick_batch`. Each
    batch is tested against the kept set with one [m, occ] x [occ, r_out]
    matmul and against itself with a triangular [m, m] pass, and survivors
    append to the kept set via one-hot-mask writes. Exact (not approximate),
    and replaces the round-1 one-pick-per-step scan whose skinny per-pick
    matvecs ran at a few percent of matmul peak (measured: the pick loop, not
    the occlusion gram, was ~95% of prune cost).

    (vectors_occ, rnorm2_occ): optional JL projection computing the occlusion
    in d' dims — occlusion is a coarse geometric filter and tolerates it; the
    pick order d_p stays full-dimension. lazy_occlusion is accepted for API
    compatibility and ignored (superseded by batching).

    Returns [C, r_out] int32 neighbor ids (-1 padded).
    """
    del lazy_occlusion  # superseded (see docstring)
    c, l = cand_ids.shape
    m = min(pick_batch, l)
    pf = p_vecs.astype(jnp.float32)
    p16 = p_vecs.astype(jnp.bfloat16)
    pn = jnp.sum(pf * pf, axis=-1, keepdims=True)

    # Dedup candidates by id BEFORE any gathers: sort each row, kill adjacent
    # duplicates (O(L log L); candidate order is irrelevant to the prune).
    si = jax.lax.sort(cand_ids, dimension=1)
    pos = jax.lax.broadcasted_iota(jnp.int32, si.shape, 1)
    dup = (si == jnp.roll(si, 1, axis=1)) & (pos > 0) & (si >= 0)
    cand_ids = jnp.where(dup, -1, si)

    safe = jnp.maximum(cand_ids, 0)
    cv16 = jnp.take(vectors, safe.reshape(-1), axis=0).reshape(
        c, l, -1
    ).astype(jnp.bfloat16)
    cn = jnp.take(rnorm2, safe)  # [C, L]
    d_p = pn + cn - 2.0 * jnp.einsum(
        "cld,cd->cl", cv16, p16, preferred_element_type=jnp.float32
    )
    valid = (cand_ids >= 0) & (cand_ids != p_ids[:, None])
    d_p = jnp.where(valid, jnp.maximum(d_p, 0.0), _BIG)

    if impl == "seq":
        # Fallback: the round-1 one-pick-per-step scan (slower but a
        # differently-shaped program — used when the batched executable
        # trips the runtime's dispatch bug; utils/devbug.py).
        if vectors_occ is not None:
            ovs = jnp.take(vectors_occ, safe.reshape(-1), axis=0).reshape(
                c, l, -1
            ).astype(jnp.bfloat16)
            ons = jnp.take(rnorm2_occ, safe)
        else:
            ovs, ons = cv16, cn
        gram = jnp.einsum(
            "cld,cmd->clm", ovs, ovs, preferred_element_type=jnp.float32
        )
        d_all = jnp.maximum(ons[:, :, None] + ons[:, None, :] - 2.0 * gram, 0.0)
        out_cols = jax.lax.broadcasted_iota(jnp.int32, (1, r_out), 1)

        def pick(carry, slot):
            alive, out_ids = carry
            dmask = jnp.where(alive, d_p, _BIG)
            best_d = jnp.min(dmask, axis=1, keepdims=True)
            ok = best_d[:, 0] < _BIG
            is_best = (dmask == best_d) & alive
            first = jnp.cumsum(is_best.astype(jnp.int32), axis=1) == 1
            is_best = is_best & first
            best_id = jnp.sum(jnp.where(is_best, cand_ids, 0), axis=1)
            best_id = jnp.where(ok, best_id, -1)
            out_ids = jnp.where(out_cols == slot, best_id[:, None], out_ids)
            d_cx = jnp.sum(jnp.where(is_best[:, :, None], d_all, 0.0), axis=1)
            killed = alpha * d_cx <= d_p
            alive = alive & ~killed & ok[:, None]
            return (alive, out_ids), None

        out_seq = jnp.full((c, r_out), -1, jnp.int32)
        (_, out_seq), _ = jax.lax.scan(
            pick, (valid, out_seq), jnp.arange(r_out, dtype=jnp.int32)
        )
        return out_seq

    # Sort candidates by d_p; gather occlusion rows in sorted order.
    d_s, ids_s = jax.lax.sort((d_p, cand_ids), num_keys=1)
    safe_s = jnp.maximum(ids_s, 0)
    if vectors_occ is not None:
        ov16 = jnp.take(vectors_occ, safe_s.reshape(-1), axis=0).reshape(
            c, l, -1
        ).astype(jnp.bfloat16)
        on = jnp.take(rnorm2_occ, safe_s)
    else:
        ov16 = jnp.take(vectors, safe_s.reshape(-1), axis=0).reshape(
            c, l, -1
        ).astype(jnp.bfloat16)
        on = jnp.take(rnorm2, safe_s)
    valid_s = d_s < _BIG

    l_pad = ((l + m - 1) // m) * m
    if l_pad > l:
        padw = l_pad - l
        ov16 = jnp.pad(ov16, ((0, 0), (0, padw), (0, 0)))
        on = jnp.pad(on, ((0, 0), (0, padw)), constant_values=_BIG)
        d_s = jnp.pad(d_s, ((0, 0), (0, padw)), constant_values=_BIG)
        ids_s = jnp.pad(ids_s, ((0, 0), (0, padw)), constant_values=-1)
        valid_s = jnp.pad(valid_s, ((0, 0), (0, padw)))

    occ_d = ov16.shape[-1]
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, r_out), 2)
    m_iota = jax.lax.broadcasted_iota(jnp.int32, (1, m), 1)
    # Empty keeper slots carry +_BIG norms: their occlusion distances are
    # astronomically large, so they can never kill (no keeper mask needed).
    k_occ = jnp.zeros((c, r_out, occ_d), jnp.float32)
    k_on = jnp.full((c, r_out), _BIG, jnp.float32)
    out_ids = jnp.full((c, r_out), -1, jnp.int32)
    count = jnp.zeros((c,), jnp.int32)

    def step(carry, xs):
        k_occ, k_on, out_ids, count = carry
        cb16, on_b, dpb, idsb, vb = xs  # [C, m, ...] batch in d_p order
        # Kills from the kept set: alpha * d(keeper, x) <= d_p(x).
        prod = jnp.einsum(
            "cmd,crd->cmr", cb16, k_occ.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        d_k = on_b[:, :, None] + k_on[:, None, :] - 2.0 * prod
        killed = jnp.any(alpha * jnp.maximum(d_k, 0.0) <= dpb[:, :, None], axis=2)
        alive_b = vb & ~killed
        # Within-batch triangular pass (earlier survivors kill later members —
        # identical to sequential processing; m is small, unrolled).
        gram_b = jnp.einsum(
            "cmd,cnd->cmn", cb16, cb16, preferred_element_type=jnp.float32
        )
        d_bb = jnp.maximum(on_b[:, :, None] + on_b[:, None, :] - 2.0 * gram_b, 0.0)
        for j in range(1, m):
            kill_j = jnp.any(
                alive_b[:, :j] & (alpha * d_bb[:, :j, j] <= dpb[:, j : j + 1]),
                axis=1,
            )
            alive_b = alive_b & ~(kill_j[:, None] & (m_iota == j))
        # Append survivors to the kept set (one-hot column writes).
        rank = jnp.cumsum(alive_b.astype(jnp.int32), axis=1)
        col = count[:, None] + rank - 1  # [C, m]
        ok_w = alive_b & (col < r_out)
        wm = ok_w[:, :, None] & (col[:, :, None] == r_iota)  # [C, m, r_out]
        hit = jnp.any(wm, axis=1)
        out_ids = jnp.where(
            hit, jnp.sum(jnp.where(wm, idsb[:, :, None], 0), axis=1), out_ids
        )
        k_on = jnp.where(
            hit, jnp.sum(jnp.where(wm, on_b[:, :, None], 0.0), axis=1), k_on
        )
        k_occ = k_occ + jnp.einsum(
            "cmr,cmd->crd", wm.astype(jnp.float32), cb16.astype(jnp.float32)
        )
        count = count + jnp.sum(ok_w.astype(jnp.int32), axis=1)
        return (k_occ, k_on, out_ids, count), None

    steps = l_pad // m
    xs = (
        jnp.moveaxis(ov16.reshape(c, steps, m, occ_d), 1, 0),
        jnp.moveaxis(on.reshape(c, steps, m), 1, 0),
        jnp.moveaxis(d_s.reshape(c, steps, m), 1, 0),
        jnp.moveaxis(ids_s.reshape(c, steps, m), 1, 0),
        jnp.moveaxis(valid_s.reshape(c, steps, m), 1, 0),
    )
    (k_occ, k_on, out_ids, count), _ = jax.lax.scan(
        step, (k_occ, k_on, out_ids, count), xs
    )
    return out_ids

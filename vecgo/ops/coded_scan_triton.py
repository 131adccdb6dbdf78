"""Pallas Triton kernel for the coded IVF group scan (GPU).

The XLA scan (ops/ivf._scan_groups_xla) walks cluster groups in a `lax.scan`:
every step writes a [group, qcap, S] f32 distance tile to device memory and
selects top-kk from it with `lax.top_k`. This kernel launches once over a
(cluster, query tile) grid. A program loads its cluster's int8 residual codes
chunk by chunk, casts them to bf16, multiplies them with the bf16 query
residuals on the tensor cores with f32 accumulation, applies the cluster's
dequant scale after the product (as the XLA scan does), and keeps the
per-query top-kk in registers. No distance tile reaches device memory.

Same results contract as ivf._scan_groups_xla for IVFCodedTable; ivf._scan_groups
picks this kernel on a GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_CHUNK = 128  # codes rows per inner step


def _kernel(qr_ref, qrn_ref, codes_ref, bn_ref, scale_ref, ld_ref, lc_ref, *,
            kk: int, chunk: int):
    qt = qr_ref.shape[0]
    s = codes_ref.shape[0]
    q = qr_ref[...].astype(jnp.bfloat16)  # [QT, d]
    qrn = qrn_ref[...]  # [QT]
    sc = scale_ref[...]  # [1]
    cols = jax.lax.broadcasted_iota(jnp.int32, (qt, chunk), 1)
    slots = jax.lax.broadcasted_iota(jnp.int32, (qt, kk), 1)

    def chunk_body(ci, carry):
        start = ci * chunk
        x = codes_ref[pl.ds(start, chunk), :].astype(jnp.bfloat16)  # [C, d]
        bn = bn_ref[pl.ds(start, chunk)]  # [C], +inf = masked/padded
        prod = pl.dot(q, x, trans_b=True) * sc[None, :]
        dd = qrn[:, None] + bn[None, :] - 2.0 * prod  # [QT, C]

        # Insert the chunk's kk best into the running list: each pass moves
        # the chunk minimum over the running maximum when it is smaller.
        def pick(_, st):
            dd, rd, ri = st
            m = jnp.min(dd, axis=1)
            j = jnp.argmin(dd, axis=1).astype(jnp.int32)
            rpos = jnp.argmax(rd, axis=1).astype(jnp.int32)
            take = m < jnp.max(rd, axis=1)
            hit = (slots == rpos[:, None]) & take[:, None]
            rd = jnp.where(hit, m[:, None], rd)
            ri = jnp.where(hit, (j + start)[:, None], ri)
            dd = jnp.where(cols == j[:, None], jnp.inf, dd)
            return dd, rd, ri

        _, rd, ri = jax.lax.fori_loop(0, kk, pick, (dd,) + carry)
        return rd, ri

    init = (
        jnp.full((qt, kk), jnp.inf, jnp.float32),
        jnp.full((qt, kk), -1, jnp.int32),
    )
    rd, ri = jax.lax.fori_loop(0, s // chunk, chunk_body, init)
    ld_ref[...] = rd
    lc_ref[...] = ri


@functools.partial(jax.jit, static_argnames=("kk", "interpret"))
def coded_cluster_topk(qr, qrn, codes, bn, scale, *, kk: int,
                       interpret: bool = False):
    """Per-(cluster, query) top-kk of the coded residual distances.

    qr [K, Q, d] f32 query residuals (q - centroid), qrn [K, Q] = |qr|²,
    codes [K, S, d] int8, bn [K, S] f32 |x̂ - c|² (+inf = masked/padded),
    scale [K] f32. Q, d and kk are powers of two, Q and d >= 16; S is a
    multiple of 128.
    Returns (ld [K, Q, kk] f32 ascending, lc [K, Q, kk] int32 in-cluster
    column, -1 where fewer than kk finite slots exist)."""
    k, qcap, d = qr.shape
    s = codes.shape[1]
    qt = min(32, qcap)
    kernel = functools.partial(_kernel, kk=kk, chunk=_CHUNK)
    ld, lc = pl.pallas_call(
        kernel,
        grid=(k, qcap // qt),
        in_specs=[
            pl.BlockSpec((None, qt, d), lambda c, t: (c, t, 0)),
            pl.BlockSpec((None, qt), lambda c, t: (c, t)),
            pl.BlockSpec((None, s, d), lambda c, t: (c, 0, 0)),
            pl.BlockSpec((None, s), lambda c, t: (c, 0)),
            pl.BlockSpec((None, 1), lambda c, t: (c, 0)),
        ],
        out_specs=(
            pl.BlockSpec((None, qt, kk), lambda c, t: (c, t, 0)),
            pl.BlockSpec((None, qt, kk), lambda c, t: (c, t, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((k, qcap, kk), jnp.float32),
            jax.ShapeDtypeStruct((k, qcap, kk), jnp.int32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="coded_cluster_topk",
    )(qr, qrn, codes, bn, scale.reshape(k, 1))
    ld, lc = jax.lax.sort((ld, lc), num_keys=1)
    return ld, jnp.where(jnp.isfinite(ld), lc, -1)


def scan_groups(qf, table, probes, mask_flat, *, kk: int, qcap: int,
                interpret: bool = False):
    """Drop-in for ivf._scan_groups_xla on an IVFCodedTable: probe inversion
    and the result scatter stay in XLA; the per-cluster scan is the kernel."""
    from vecgo.ops.ivf import _invert_probes

    b, d = qf.shape
    k_pad, s = table.bnorm2.shape
    n_probe = probes.shape[1]
    qtab, qslot = _invert_probes(probes, k_pad, qcap)
    qt = 32 if qcap >= 32 else 16
    pad_q = (-qcap) % qt  # dump-row padding: the kernel wants whole tiles
    if pad_q:
        qtab = jnp.pad(qtab, ((0, 0), (0, pad_q)), constant_values=b)
        qslot = jnp.pad(qslot, ((0, 0), (0, pad_q)))
    qcap_p = qcap + pad_q
    q_ext = jnp.concatenate([qf, jnp.zeros((1, d), jnp.float32)])
    qr = jnp.take(q_ext, qtab.reshape(-1), axis=0).reshape(k_pad, qcap_p, d)
    qr = qr - table.centroids[:, None, :]
    qrn = jnp.sum(qr * qr, axis=-1)
    bn = table.bnorm2
    if mask_flat is not None:
        bn = jnp.where(mask_flat.reshape(k_pad, s), bn, jnp.inf)
    codes = table.codes
    pad_s = (-s) % _CHUNK
    if pad_s:
        codes = jnp.pad(codes, ((0, 0), (0, pad_s), (0, 0)))
        bn = jnp.pad(bn, ((0, 0), (0, pad_s)), constant_values=jnp.inf)
    kk_p = 1 << (kk - 1).bit_length()  # Triton blocks are powers of two
    ld, lc = coded_cluster_topk(
        qr, qrn, codes, bn, table.scale, kk=kk_p, interpret=interpret
    )
    ld, lc = ld[..., :kk], lc[..., :kk]
    base = (jnp.arange(k_pad, dtype=jnp.int32) * s)[:, None, None]
    lrow = jnp.where(lc >= 0, base + lc, -1)
    out_d = (
        jnp.full((b + 1, n_probe, kk), jnp.inf, jnp.float32)
        .at[qtab, qslot].set(ld, mode="drop")[:b]
    ).reshape(b, n_probe * kk)
    out_r = (
        jnp.full((b + 1, n_probe, kk), -1, jnp.int32)
        .at[qtab, qslot].set(lrow, mode="drop")[:b]
    ).reshape(b, n_probe * kk)
    seg_rows = jnp.where(
        out_r >= 0, jnp.take(table.rows.reshape(-1), jnp.maximum(out_r, 0)), -1
    )
    return jnp.where(seg_rows >= 0, out_d, jnp.inf), seg_rows

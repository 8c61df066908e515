"""Exact dense inner-product top-k over device-resident embeddings.

Replaces ``faiss.IndexFlatIP.search`` (reference src/ingestion.py:82-83
builds the index; reference src/retrieval.py:1140,1165,1261 and the
SSG/Triangulation hop loops :622,:730 search it).  Two exact shapes:

* ``xla``     — ``scores = q @ E.T`` + ``lax.top_k``.  XLA fuses the mask
  and handles any size; materialises ``[B, N]`` scores in device memory,
  so it is bandwidth-bound for very large N.
* ``blocked`` — :func:`blocked_topk`, a scan over row blocks with a
  running merge: the same result with a ``[B, block]`` score buffer.

Both return identical results (ties broken by lower index first).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

NEG_INF = -3.0e38  # plain float, so jitted code never captures a traced const

# Rows per lax.scan step of blocked_topk (the bounded-memory exact scan).
BLOCK_ROWS = 1 << 20
# Column count above which the engine offers the approximate large-scan
# mode (SearchConfig.scan_rt → approx_topk / large_topk_from_scores
# approx_rt): the [B, N] sort is where an exact scan spends its time at
# that width.
LARGE_TOPK_MIN_COLS = 1 << 19


def _mask_scores(scores: jax.Array, mask: Optional[jax.Array]) -> jax.Array:
    if mask is None:
        return scores
    if mask.ndim == 1:
        mask = mask[None, :]
    return jnp.where(mask, scores, NEG_INF)


def large_topk_from_scores(
    scores: jax.Array, k: int, approx_rt: Optional[float] = None
) -> Tuple[jax.Array, jax.Array]:
    """``lax.top_k`` semantics over a wide materialized score matrix.

    Default (``approx_rt=None``) is the exact one-shot sort.  With
    ``approx_rt`` set it calls ``lax.approx_max_k`` at that recall target;
    callers own the recall bookkeeping (the engine exposes it as
    ``SearchConfig.scan_rt``).  On the GPU, XLA lowers ``approx_max_k``
    as an exact top-k, so there the approximate tier returns exact
    results at the exact tier's cost.

    The exact tier is the one-shot sort (``lax.top_k``; the
    bounded-memory :func:`blocked_topk` for callers that cannot afford
    the score matrix).
    """
    if approx_rt is not None:
        vals, idx = jax.lax.approx_max_k(scores, k, recall_target=approx_rt)
        return vals, idx.astype(jnp.int32)
    vals, idx = jax.lax.top_k(scores, k)
    return vals, idx.astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("k", "block", "query_2pass", "approx_rt"))
def blocked_topk(
    q: jax.Array,
    emb: jax.Array,
    k: int,
    row_scale: Optional[jax.Array] = None,
    mask: Optional[jax.Array] = None,
    block: int = BLOCK_ROWS,
    assign: Optional[jax.Array] = None,
    centroids: Optional[jax.Array] = None,
    query_2pass: bool = False,
    approx_rt: Optional[float] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k by scanning row blocks with a running merge.

    Bit-identical to the one-shot ``[B, N]`` materialization (same scores,
    same lowest-index tie-break: per-block ``top_k`` prefers lower local
    indices, and the carry — earlier blocks — is concatenated first in the
    merge), but the score buffer alive at any moment is ``[B, block]`` and
    every sort runs over ``block`` columns instead of N.  This is the
    "[B, N] scores stop fitting" regime: materializing [127, 10M] f32
    costs 5 GB of device-memory write+read plus a 10M-column sort per
    query.

    Args:
        q: ``[B, D]`` f32/bf16 queries.
        emb: ``[N, D]`` corpus rows — f32, bf16, or int8 (with row_scale).
        row_scale: ``[N]`` f32 dequant scales iff ``emb`` is int8.
        mask: optional ``[N]`` or ``[B, N]`` bool routing mask.
        block: static rows per scan step (the last block clamps and
            re-masks, so any N works without padding a 10 GB buffer).
        assign/centroids: centroid-residual store (ops/quant.py
            ``quantize_rows_residual``) — per-block the exact f32 bias
            ``(q·c)[:, assign_block]`` is added to the dequantized int8
            residual dot.  Blocked is the ONLY exact shape for the
            residual scan at 10M: the one-shot bias gather materializes
            f32 [N, B] twice (gather + a layout copy feeding the sort),
            9.5 GB of HLO temp on a 16 GB chip (measured OOM).
        query_2pass: int8 only — two-level query quantization
            (ops/quant.quantize_query_2pass): the [2B, D] stacked operand
            reads each corpus block once for both passes, removing the
            query-side quantization error at ~2× matmul (not memory) cost.
        approx_rt: per-block ``lax.approx_max_k(recall_target=·)``
            instead of the exact block sort — the running merge stays
            exact, so any approximation is confined to a block.

    Returns ``(values [B, k] f32, indices [B, k] i32)``, descending.
    """
    B, D = q.shape
    N = emb.shape[0]
    block = min(block, N)
    k = min(k, N)
    n_blocks = -(-N // block)
    int8 = emb.dtype == jnp.int8
    if query_2pass and not int8:
        raise ValueError("query_2pass requires an int8 store")
    if int8:
        from .quant import quantize_query_2pass, quantize_rows

        if query_2pass:
            q_i8, q_s_hi, q_s_lo = quantize_query_2pass(q)
        else:
            q_i8, q_scale = quantize_rows(q.astype(jnp.float32))
    if assign is not None:
        if not int8:
            raise ValueError("residual assign/centroids require an int8 store")
        qc = jnp.dot(
            q.astype(jnp.float32), centroids.T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def step(carry, i):
        top_v, top_i = carry
        start = i * block
        # clamp so the slice always fits; positions before `start` were
        # already covered by the previous block and are masked out below
        sa = jnp.minimum(start, N - block)
        eb = jax.lax.dynamic_slice(emb, (sa, jnp.int32(0)), (block, D))
        if int8:
            acc = jax.lax.dot_general(
                q_i8, eb, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            # [N, 1] column slices: one slicing idiom for every per-row
            # array of the block
            sb = jax.lax.dynamic_slice(
                row_scale[:, None], (sa, jnp.int32(0)), (block, 1)
            )[:, 0]
            if query_2pass:
                accf = acc.astype(jnp.float32)
                s = (accf[:B] * q_s_hi[:, None]
                     + accf[B:] * q_s_lo[:, None]) * sb[None, :]
            else:
                s = acc.astype(jnp.float32) * q_scale[:, None] * sb[None, :]
            if assign is not None:
                ab = jax.lax.dynamic_slice(
                    assign[:, None], (sa, jnp.int32(0)), (block, 1)
                )[:, 0]
                s = s + jnp.take(qc, ab, axis=1)
        else:
            s = jnp.dot(
                q, eb.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        pos = sa + jnp.arange(block, dtype=jnp.int32)
        ok = pos >= start                      # dedup the tail-clamp overlap
        if mask is not None:
            if mask.ndim == 1:
                mb = jax.lax.dynamic_slice(
                    mask[:, None], (sa, jnp.int32(0)), (block, 1)
                )[:, 0]
                ok = ok & mb
                s = jnp.where(ok[None, :], s, NEG_INF)
            else:
                mb = jax.lax.dynamic_slice(
                    mask, (jnp.int32(0), sa), (B, block)
                )
                s = jnp.where(ok[None, :] & mb, s, NEG_INF)
        else:
            s = jnp.where(ok[None, :], s, NEG_INF)
        if approx_rt is not None:
            v, j = jax.lax.approx_max_k(s, k, recall_target=approx_rt)
        else:
            v, j = jax.lax.top_k(s, k)
        cv = jnp.concatenate([top_v, v], axis=1)
        ci = jnp.concatenate([top_i, (sa + j).astype(jnp.int32)], axis=1)
        nv, nj = jax.lax.top_k(cv, k)
        return (nv, jnp.take_along_axis(ci, nj, axis=1)), None

    init = (
        jnp.full((B, k), NEG_INF, jnp.float32),
        jnp.full((B, k), -1, jnp.int32),
    )
    (vals, idx), _ = jax.lax.scan(step, init, jnp.arange(n_blocks, dtype=jnp.int32))
    return vals, idx


@functools.partial(jax.jit, static_argnames=("k", "recall_target"))
def approx_topk(
    q: jax.Array,
    emb: jax.Array,
    k: int,
    recall_target: float = 0.999,
    mask: Optional[jax.Array] = None,
    row_scale: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Large-N scan through ``lax.approx_max_k``.

    Same contract as :func:`dense_topk` otherwise, with per-element recall
    ≈ ``recall_target`` where the backend implements the approximate
    reduction; on the GPU XLA lowers it as an exact top-k.  Replaces the
    reference's FAISS flat search (src/retrieval.py:1140) at the 10M scale
    where FAISS itself would switch to IVF/HNSW.
    """
    n = emb.shape[0]
    k = min(k, n)
    if emb.dtype == jnp.int8:
        from .quant import int8_scores

        if row_scale is None:
            raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
        scores = int8_scores(q, emb, row_scale)
    else:
        scores = jnp.dot(
            q, emb.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    scores = _mask_scores(scores, mask)
    vals, idx = jax.lax.approx_max_k(scores, k, recall_target=recall_target)
    return vals, idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _xla_topk(q: jax.Array, emb: jax.Array, mask: Optional[jax.Array], k: int):
    # HIGHEST → true f32 products (no TF32), for FAISS-exact parity;
    # the bench has a separate bf16 fast path where recall tolerates it.
    scores = jnp.dot(
        q, emb.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
    )
    scores = _mask_scores(scores, mask)
    vals, idx = jax.lax.top_k(scores, k)
    return vals, idx.astype(jnp.int32)


def dense_topk(
    q: jax.Array,
    emb: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    impl: str = "auto",
    row_scale: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k inner products of each query row against all embedding rows.

    Args:
        q: ``[B, D]`` queries (f32 or bf16).
        emb: ``[N, D]`` corpus embeddings (f32/bf16, or int8 with
            ``row_scale``).
        k: number of neighbours (static).
        mask: optional ``[N]`` or ``[B, N]`` bool — False rows are excluded
            (year/company routing, visited sets, padding).
        impl: "xla" (one-shot ``[B, N]`` scores), "blocked" (bounded-memory
            scan, :func:`blocked_topk`), or "auto" (= "xla").
        row_scale: ``[N]`` f32 dequantization scales, required iff ``emb``
            is int8 (ops/quant.py store).

    Returns:
        ``(values [B, k] f32, indices [B, k] i32)`` sorted descending.
    """
    n = emb.shape[0]
    k = min(k, n)
    if emb.dtype == jnp.int8:
        if row_scale is None:
            raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
        from .quant import int8_topk

        return int8_topk(q, emb, row_scale, k, mask)
    if impl == "blocked":
        return blocked_topk(q, emb, k, mask=mask)
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    return _xla_topk(q, emb, mask, k)

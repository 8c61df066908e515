"""Symmetric per-row int8 quantization of the embedding store.

The BASELINE metric is recall + QPS **at equal memory** (BASELINE.md; the
reference serves f32 FAISS flat-IP, src/ingestion.py:79-84).  An int8 row
store quarters the bytes of the corpus matrix — the exact-scan and IVF
probes are memory-bandwidth-bound (DESIGN.md), so fewer bytes is the one
lever left after the layout work.  Unlike the bf16 variant (whose probe
upcasts the gathered block to f32), int8 keeps the inner product in
int8×int8→int32 and applies the
dequantization as a cheap rank-1 scale on the [B, N] result:

    score(q, x) ≈ (sq · sx) · Σ round(q/sq)·round(x/sx)

with per-row scales sx = max|x|/127 and per-query sq = max|q|/127.
For unit-norm D=1024 embeddings the relative score error is ~1e-3, i.e.
recall@10 ≈ 0.99 vs the f32 oracle on clustered corpora (measured in
bench.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .topk import NEG_INF, _mask_scores

_EPS = 1e-12


def quantize_rows(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8: returns ``(q int8 [N, D], scale f32 [N])``
    with ``x ≈ q * scale[:, None]``.  All-zero rows get scale 0 (and score
    exactly 0 against everything, matching the f32 behaviour of padding)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = amax / 127.0
    inv = jnp.where(scale > _EPS, 1.0 / jnp.maximum(scale, _EPS), 0.0)
    q = jnp.clip(jnp.round(xf * inv[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_query_2pass(q: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Two-level int8 query quantization: ``q ≈ s_hi·q8_hi + s_lo·q8_lo``.

    The residual of the first int8 pass is itself int8-quantized, driving
    the query-side quantization error to ~s_hi/254² — effectively exact —
    while every product stays int8×int8→int32.  Stacking
    ``[q8_hi; q8_lo]`` into one [2B, D] operand reads the corpus block
    once for both passes (the scan is memory-bound, so the 2× matmul work
    is nearly free).  Returns ``(q8 [2B, D] int8, s_hi [B], s_lo [B])``."""
    qf = q.astype(jnp.float32)
    q_hi, s_hi = quantize_rows(qf)
    resid = qf - q_hi.astype(jnp.float32) * s_hi[..., None]
    q_lo, s_lo = quantize_rows(resid)
    return jnp.concatenate([q_hi, q_lo], axis=0), s_hi, s_lo


def int8_scores(q: jax.Array, emb_i8: jax.Array, row_scale: jax.Array) -> jax.Array:
    """``[B, N]`` f32 scores of f32/bf16 queries against an int8 row store:
    quantize the query per row, int8×int8→int32, rank-1 dequant
    epilogue.  The single definition of the quantized-dot scheme for every
    full-matrix site (exact scan, engine pair_topk, sharded shards); the
    IVF probe keeps its own gather-shaped ``bd,bwd`` variant."""
    q_i8, q_scale = quantize_rows(q.astype(jnp.float32))
    acc = jax.lax.dot_general(
        q_i8, emb_i8, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * q_scale[:, None] * row_scale[None, :]


def quantize_rows_residual(
    x: jax.Array, centroids: jax.Array, assign: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Centroid-residual int8: ``x ≈ centroids[assign] + q * scale[:, None]``.

    The recall lever past plain per-row int8: clustered corpora put most of a
    row's magnitude in its centroid, so quantizing only the residual
    shrinks the quantization step ~3× at the SAME stored bytes (int8 rows
    + f32 scale per row; the extra i32 assign is 4 bytes per 1024-byte
    row, 0.4%).  This is the IVF residual-coding idea (faiss
    IndexIVFFlat's encode-by-residual) applied to the flat exact scan —
    the reference's FAISS flat store (src/ingestion.py:79-84) has no
    equivalent because it never quantizes at all.

    Args:
        x: ``[N, D]`` f32 rows.
        centroids: ``[K, D]`` f32 (k-means of the corpus or any nearby
            codebook — a worse codebook only grows the residual, never
            breaks correctness).
        assign: optional precomputed ``[N]`` i32 nearest-centroid ids
            (e.g. from an IVF build); computed here when absent.

    Returns ``(q int8 [N, D], scale f32 [N], assign i32 [N])``.
    """
    if assign is None:
        from .kmeans import assign_clusters

        assign = assign_clusters(x.astype(jnp.float32), centroids)
    r = x.astype(jnp.float32) - centroids[assign]
    q, scale = quantize_rows(r)
    return q, scale, assign


def int8_residual_scores(
    q: jax.Array,
    emb_i8: jax.Array,
    row_scale: jax.Array,
    assign: jax.Array,
    centroids: jax.Array,
) -> jax.Array:
    """``[B, N]`` f32 scores against a centroid-residual int8 store:

        score(q, x) = (q · c_a)            — exact f32, [B, K] matmul + gather
                    + sq·sx · (q8 · r8)    — int8×int8→int32

    The centroid part is exact (no quantization error), and the query-
    quantization error now multiplies only the residual magnitude, so the
    total score noise drops by the corpus's |residual|/|row| ratio (~3×
    on clustered text embeddings) vs :func:`int8_scores`."""
    qc = jnp.dot(
        q.astype(jnp.float32), centroids.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    bias = jnp.take(qc, assign, axis=1)  # [B, N] — fused gather epilogue
    return bias + int8_scores(q, emb_i8, row_scale)


@functools.partial(jax.jit, static_argnames=("k", "query_2pass"))
def int8_residual_topk(
    q: jax.Array,
    emb_i8: jax.Array,
    row_scale: jax.Array,
    assign: jax.Array,
    centroids: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    query_2pass: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-scan top-k against a centroid-residual int8 store (same
    contract as :func:`int8_topk`).

    Runs the BLOCKED scan (ops/topk.blocked_topk with the residual bias
    folded per block): the one-shot ``[B, N]`` form OOMs at 10M rows —
    the bias gather materializes f32 [N, B] twice (about 9.5 GB of
    temporaries) where the plain int8 one-shot fuses into a single scores
    buffer.  ``query_2pass`` (default on) removes the query-side
    quantization error via :func:`quantize_query_2pass`."""
    from .topk import blocked_topk

    return blocked_topk(q, emb_i8, k, row_scale=row_scale, mask=mask,
                        assign=assign, centroids=centroids,
                        query_2pass=query_2pass)


@functools.partial(jax.jit, static_argnames=("k", "recall_target", "query_2pass"))
def int8_residual_approx_topk(
    q: jax.Array,
    emb_i8: jax.Array,
    row_scale: jax.Array,
    assign: jax.Array,
    centroids: jax.Array,
    k: int,
    recall_target: float = 0.95,
    mask: Optional[jax.Array] = None,
    query_2pass: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Fast tier of the residual scan: the same blocked pass with a
    per-block fused PartialReduce (``lax.approx_max_k``) instead of the
    exact block sort.  (The one-shot epilogue form the plain store uses —
    ops/topk.approx_topk — OOMs here: the bias gather materializes
    f32 [N, B] twice.)"""
    from .topk import blocked_topk

    return blocked_topk(q, emb_i8, k, row_scale=row_scale, mask=mask,
                        assign=assign, centroids=centroids,
                        query_2pass=query_2pass, approx_rt=recall_target)


@functools.partial(
    jax.jit, static_argnames=("k", "k_cand", "recall_target"))
def int8_residual_topk_rescored(
    q: jax.Array,
    emb_i8: jax.Array,
    row_scale: jax.Array,
    assign: jax.Array,
    centroids: jax.Array,
    k: int,
    k_cand: int = 48,
    recall_target: float = 0.95,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Two-stage residual scan: cheap candidates, near-exact rerank.

    Stage 1 runs the FASTEST residual tier (1-pass query, per-block
    PartialReduce) for ``k_cand`` candidates — a true top-k row only has
    to land anywhere in the top ``k_cand`` under the noisier stage-1
    scores, so the final recall@k tracks stage 1's recall@``k_cand``
    (≫ its recall@k).  Stage 2 gathers the ``[B, k_cand, D]`` int8
    candidate rows (k_cand·D ≈ 48 KB per query — trivial next to the
    10 GB scan) and reranks with the exact centroid bias + 2-pass query,
    i.e. the highest-precision scoring this store supports.

    Its recall@10 is meant to reach the exact 2-pass scan's at a fraction
    of the reranked rows — the shipped high-recall operating point.
    """
    from .topk import blocked_topk

    n = emb_i8.shape[0]
    k = min(k, n)
    k_cand = min(max(k_cand, k), n)
    _, cand = blocked_topk(q, emb_i8, k_cand, row_scale=row_scale,
                           mask=mask, assign=assign, centroids=centroids,
                           query_2pass=False, approx_rt=recall_target)
    ok = cand >= 0
    safe = jnp.where(ok, cand, 0)
    rows = jnp.take(emb_i8, safe, axis=0)             # [B, kc, D] int8
    sc = jnp.take(row_scale, safe)                    # [B, kc]
    a = jnp.take(assign, safe)                        # [B, kc]
    qc = jnp.dot(
        q.astype(jnp.float32), centroids.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    bias = jnp.take_along_axis(qc, a, axis=1)         # [B, kc]
    q2, s_hi, s_lo = quantize_query_2pass(q)
    B = q.shape[0]

    def qdot(qi8):                                    # [B, D] i8 → [B, kc]
        return jax.lax.dot_general(
            qi8[:, None, :], rows,
            (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )[:, 0, :].astype(jnp.float32)

    resid = (qdot(q2[:B]) * s_hi[:, None]
             + qdot(q2[B:]) * s_lo[:, None]) * sc
    scores = jnp.where(ok, bias + resid, NEG_INF)
    vals, j = jax.lax.top_k(scores, k)
    out_rows = jnp.take_along_axis(jnp.where(ok, cand, -1), j, axis=1)
    return vals, out_rows.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def int8_topk(
    q: jax.Array,
    emb_i8: jax.Array,
    row_scale: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-scan top-k against an int8 row store.

    Args:
        q: ``[B, D]`` f32/bf16 queries (quantized here, per query row).
        emb_i8: ``[N, D]`` int8 corpus rows.
        row_scale: ``[N]`` f32 per-row scales.
        k: neighbours (static).
        mask: optional ``[N]`` or ``[B, N]`` routing mask.

    Returns ``(values [B, k] f32, indices [B, k] i32)``, descending.
    """
    n = emb_i8.shape[0]
    k = min(k, n)
    # One-shot at every N.  Callers who can trade recall for speed use
    # ops.topk.approx_topk (the engine's scan_rt knob); bounded-memory
    # exact is blocked_topk.
    scores = _mask_scores(int8_scores(q, emb_i8, row_scale), mask)
    vals, idx = jax.lax.top_k(scores, k)
    return vals, idx.astype(jnp.int32)

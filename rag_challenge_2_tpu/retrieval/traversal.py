"""Graph-traversal retrieval: SSG, Triangulation, hybrid expansion.

Re-design of the reference's per-hop FAISS loops
(``_ssg_search`` reference src/retrieval.py:585-688, ``_triangulation_search``
:690-806, hybrid orchestration :1258-1418) as batched on-device loops:

* every anchor (query × doc pair, or basic-top-K seed) traverses in
  parallel as one batch dimension;
* a hop = one matmul against the corpus + ``lax.top_k`` — the reference's
  per-candidate ``faiss.reconstruct`` gather is a plain embedding-table
  gather on device;
* the visited set is the path itself (≤ max_hops+1 entries), checked by
  broadcast comparison — no [A, N] visited bitmap;
* SSG early-stop ("similarity stopped improving",
  reference src/retrieval.py:654) is per-anchor predication, not a break.

Exact semantic match to the reference:
* candidates = top-(neighbor_k+1) neighbours of the *current chunk vector*
  with visited ones dropped (so if every one of the k+1 is visited, the
  traversal stops — matching the "no candidates → break" path);
* SSG picks max chunk-to-chunk similarity and stops when it does not
  strictly improve on the previous hop.  DOCUMENTED DEVIATION: the
  reference seeds the bar at the anchor's self-similarity 1.0
  (src/retrieval.py:614), which on unit-norm embeddings no first hop can
  ever beat — its SSG silently degenerates to anchor-only.  Here the
  FIRST hop is exempt (the bar starts at -inf; you cannot "stop
  improving" before the first step) and strict improvement applies from
  hop 2 on, which is the documented intent of the algorithm;
* Triangulation picks max ``1/(1+‖(q+c+cand)/3 − q‖₂)`` and never
  early-stops;
* outputs are the traversal paths; final hit similarities are re-computed
  as query·chunk in batch (the reference recomputes them at emission,
  src/retrieval.py:1216-1233).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.topk import NEG_INF, _mask_scores


class TraversalResult(NamedTuple):
    """Paths of shape [A, max_hops+1]; position 0 is the anchor."""

    path: jax.Array        # i32 [A, H+1], -1 where traversal stopped
    valid: jax.Array       # bool [A, H+1]
    hop_score: jax.Array   # f32 [A, H+1] — internal per-hop score
                           # (SSG: chunk-to-chunk sim; Tri: centroid score;
                           #  anchor slot: 1.0 / query·anchor respectively)
    cand_ids: jax.Array    # i32 [A, H, R] — per-hop candidate rows, -1 pad
                           # (reference records top-10 candidates per hop,
                           #  src/retrieval.py:665 `candidates[:10]`)
    cand_scores: jax.Array  # f32 [A, H, R] — matching step scores


CAND_RECORD = 10  # candidates kept per hop (reference src/retrieval.py:665)

# At million-row document windows the hop cost is NOT the matmul (the
# [A, W]·[W, D] product is a few ms) but the W-wide `lax.top_k` sort that
# follows it, run once per hop per method.  When the caller opts in
# (``approx_rt``, threaded from engine SearchConfig.scan_rt) and the
# scored row is at least this wide, hop-candidate selection runs
# ``lax.approx_max_k`` instead — same trade as the 10M one-shot scan
# (ops/topk.large_topk_from_scores).  Below this width the flag is a
# no-op, so val-shape parity (tests/test_traversal.py oracle paths) is
# untouched.  On the GPU XLA lowers approx_max_k as an exact top-k.
HOP_APPROX_MIN_COLS = 1 << 16


def _cand_topk(scores: jax.Array, k: int, approx_rt: Optional[float]):
    """Top-k hop candidates over the last axis; approx when wide + opted in."""
    if approx_rt is not None and scores.shape[-1] >= HOP_APPROX_MIN_COLS:
        vals, ids = jax.lax.approx_max_k(scores, k, recall_target=approx_rt)
    else:
        vals, ids = jax.lax.top_k(scores, k)
    return vals, ids.astype(jnp.int32)


def _gather_vecs(emb, row_scale, idx):
    """Dequantizing row gather: f32 vectors whatever the store dtype."""
    v = emb[idx].astype(jnp.float32)
    if row_scale is not None:
        v = v * row_scale[idx][..., None]
    return v


def _hop_candidates(cur_vec, emb, row_scale, mask, path, neighbor_k,
                    query_vec=None, approx_rt=None):
    """Top-(k+1) neighbours of the current vectors, with visited flags.

    When ``query_vec`` is given (triangulation), the query row rides the
    same matmul as a stacked operand and the per-candidate ``q·x`` comes
    back via ``take_along_axis`` — no ``[A, k+1, D]`` vector gather."""
    lhs = cur_vec if query_vec is None else jnp.concatenate(
        [cur_vec, query_vec.astype(jnp.float32)], axis=0
    )
    if row_scale is not None:
        # int8 store: XLA fuses the int8→f32 convert into the matmul's
        # operand read; the per-row dequant is a rank-1 epilogue
        scores = jnp.einsum(
            "ad,nd->an", lhs, emb.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        ) * row_scale[None, :]
    else:
        scores = jnp.einsum(
            "ad,nd->an", lhs, emb, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    A = cur_vec.shape[0]
    vals, ids = _cand_topk(_mask_scores(scores[:A], mask), neighbor_k + 1,
                           approx_rt)
    visited = jnp.any(path[:, :, None] == ids[:, None, :], axis=1)
    qx = None if query_vec is None else jnp.take_along_axis(scores[A:], ids, axis=1)
    return vals, ids, visited, qx


@functools.partial(
    jax.jit, static_argnames=("max_hops", "neighbor_k", "mode", "approx_rt")
)
def traverse(
    emb: jax.Array,
    anchor_idx: jax.Array,
    query_vec: jax.Array,
    mask: jax.Array,
    row_scale: Optional[jax.Array] = None,
    *,
    max_hops: int = 4,
    neighbor_k: int = 30,
    mode: str = "ssg",
    approx_rt: Optional[float] = None,
) -> TraversalResult:
    """Run SSG or Triangulation traversal for a batch of anchors.

    Args:
        emb: ``[N, D]`` corpus embeddings.
        anchor_idx: ``[A]`` starting chunk rows (-1 = inactive anchor).
        query_vec: ``[A, D]`` query embedding per anchor (SSG ignores it for
            stepping but the result re-scoring uses it; Triangulation uses it
            for the centroid).
        mask: ``[A, N]`` or ``[N]`` bool — rows the anchor may visit
            (doc membership × routing × validity).
        mode: "ssg" | "triangulation".
    """
    assert mode in ("ssg", "triangulation")
    A = anchor_idx.shape[0]
    H = max_hops

    path = jnp.full((A, H + 1), -1, jnp.int32)
    path = path.at[:, 0].set(anchor_idx)
    active0 = anchor_idx >= 0
    anchor_vec = _gather_vecs(emb, row_scale, jnp.maximum(anchor_idx, 0))
    anchor_q_sim = jnp.einsum("ad,ad->a", query_vec.astype(jnp.float32), anchor_vec)
    hop_score = jnp.zeros((A, H + 1), jnp.float32)
    hop_score = hop_score.at[:, 0].set(
        jnp.where(active0, 1.0 if mode == "ssg" else anchor_q_sim, 0.0)
    )

    if mask.ndim == 1:
        mask = jnp.broadcast_to(mask[None, :], (A, mask.shape[0]))

    R = min(CAND_RECORD, neighbor_k + 1)
    cand_ids = jnp.full((A, H, R), -1, jnp.int32)
    cand_scores = jnp.zeros((A, H, R), jnp.float32)

    if mode == "triangulation":
        # triangulation's centroid distance expands algebraically:
        #   ‖(q+c+x)/3 − q‖² = (‖x‖² + ‖c−2q‖² + 2·x·(c−2q)) / 9
        # x·c is the hop matmul's own output, x·q rides the same matmul as
        # a stacked row, and ‖x‖² is a corpus-constant — so the per-hop
        # [A, k+1, D] candidate-vector gather + centroid arithmetic
        # (the Tri path's dominant HBM traffic) disappears entirely.
        if row_scale is not None:
            row_n2 = jnp.sum(
                emb.astype(jnp.float32) ** 2, axis=1
            ) * row_scale * row_scale                                # [N]
        else:
            row_n2 = jnp.sum(emb.astype(jnp.float32) ** 2, axis=1)  # [N]
        q_f = query_vec.astype(jnp.float32)
        q_n2 = jnp.sum(q_f * q_f, axis=1)                            # [A]

    def body(hop, state):
        path, hop_score, cand_ids, cand_scores, cur_idx, cur_vec, prev_sim, active = state
        vals, ids, visited, qx = _hop_candidates(
            cur_vec, emb, row_scale, mask, path, neighbor_k,
            query_vec=None if mode == "ssg" else query_vec,
            approx_rt=approx_rt,
        )
        cand_ok = (~visited) & (vals > NEG_INF / 2)

        if mode == "ssg":
            # step score = chunk-to-chunk similarity == the search score itself
            step_score = vals
        else:
            c_n2 = jnp.sum(cur_vec * cur_vec, axis=1)                # [A]
            c_q = jnp.sum(cur_vec * q_f, axis=1)                     # [A]
            const = c_n2 - 4.0 * c_q + 4.0 * q_n2                    # ‖c−2q‖²
            dist2 = (row_n2[ids] + const[:, None] + 2.0 * vals - 4.0 * qx) / 9.0
            dist = jnp.sqrt(jnp.maximum(dist2, 0.0))
            step_score = 1.0 / (1.0 + dist)

        step_score = jnp.where(cand_ok, step_score, NEG_INF)
        best_j = jnp.argmax(step_score, axis=1)                       # [A]
        best_score = jnp.take_along_axis(step_score, best_j[:, None], 1)[:, 0]
        best_id = jnp.take_along_axis(ids, best_j[:, None], 1)[:, 0]
        has_cand = jnp.any(cand_ok, axis=1)

        step = active & has_cand
        if mode == "ssg":
            # early stop: similarity must strictly improve (reference :654)
            step = step & (best_score > prev_sim)

        new_idx = jnp.where(step, best_id, cur_idx)
        path = path.at[:, hop + 1].set(jnp.where(step, best_id, -1))
        hop_score = hop_score.at[:, hop + 1].set(jnp.where(step, best_score, 0.0))

        # record the hop's top-R candidates (observability parity with the
        # reference's traversal_details, src/retrieval.py:661-668)
        r_vals, r_j = jax.lax.top_k(step_score, R)
        r_ids = jnp.take_along_axis(ids, r_j, axis=1)
        rec_ok = step[:, None] & (r_vals > NEG_INF / 2)
        cand_ids = cand_ids.at[:, hop, :].set(jnp.where(rec_ok, r_ids, -1))
        cand_scores = cand_scores.at[:, hop, :].set(jnp.where(rec_ok, r_vals, 0.0))

        new_vec = jnp.where(
            step[:, None], _gather_vecs(emb, row_scale, jnp.maximum(new_idx, 0)), cur_vec
        )
        prev_sim = jnp.where(step, best_score, prev_sim)
        return path, hop_score, cand_ids, cand_scores, new_idx, new_vec, prev_sim, step

    # first hop exempt from the early-stop bar (see module docstring —
    # the reference's 1.0 seed makes SSG a no-op on unit-norm embeddings)
    prev_sim0 = jnp.full(anchor_idx.shape, NEG_INF)
    state = (
        path, hop_score, cand_ids, cand_scores,
        jnp.maximum(anchor_idx, 0), anchor_vec, prev_sim0, active0,
    )
    path, hop_score, cand_ids, cand_scores, *_ = jax.lax.fori_loop(0, H, body, state)
    return TraversalResult(
        path=path, valid=path >= 0, hop_score=hop_score,
        cand_ids=cand_ids, cand_scores=cand_scores,
    )


@functools.partial(
    jax.jit,
    static_argnames=("window", "max_hops", "neighbor_k", "mode", "approx_rt"),
)
def traverse_windowed(
    emb: jax.Array,
    anchor_idx: jax.Array,
    query_vec: jax.Array,
    win_start: jax.Array,
    win_len: jax.Array,
    row_scale: Optional[jax.Array] = None,
    *,
    window: int,
    max_hops: int = 4,
    neighbor_k: int = 30,
    mode: str = "ssg",
    approx_rt: Optional[float] = None,
) -> TraversalResult:
    """`traverse` restricted to per-group document windows.

    A traversal can only ever visit rows of its anchor's document (the
    reference searches one per-document FAISS index per hop,
    src/retrieval.py:585-806).  Documents are stored as contiguous row
    ranges, so instead of scoring the current vectors against the WHOLE
    corpus and masking (``traverse``), each group g slices its document's
    rows ``emb[win_start[g] : win_start[g]+window]`` once and every hop
    matmul + top-k runs inside that window — at the val-set shape (6 docs ×
    ~1.7k chunks) this is ~6× fewer FLOPs and a ~6× smaller top-k domain
    per hop.

    Args:
        emb: ``[N, D]`` corpus embeddings.
        anchor_idx: ``[G, A]`` GLOBAL anchor rows, -1 = inactive.
        query_vec: ``[G, A, D]`` query embedding per anchor.
        win_start: ``[G]`` first corpus row of each group's document.
        win_len: ``[G]`` number of document rows (≤ window).
        window: static window size (max document length, padded).

    Returns a TraversalResult over ``G*A`` anchors with GLOBAL row ids,
    identical (paths, scores, candidate records) to ``traverse`` with the
    equivalent ``[G*A, N]`` document masks.
    """
    assert mode in ("ssg", "triangulation")
    G, A = anchor_idx.shape
    N, D = emb.shape
    H = max_hops
    window = min(window, N)

    # dynamic_slice clamps starts so the slice fits; recover the clamp as a
    # per-group offset so local→global stays exact for tail documents
    sa = jnp.minimum(win_start, N - window)                        # [G]
    off = win_start - sa                                           # [G]
    emb_w = jax.vmap(
        lambda s: jax.lax.dynamic_slice(emb, (s, jnp.int32(0)), (window, D))
    )(sa)                                                          # [G, W, D]
    scale_w = None
    if row_scale is not None:
        # sliced as a [N, 1] column, the same idiom as every other
        # per-row array sliced here
        scale_w = jax.vmap(
            lambda s: jax.lax.dynamic_slice(
                row_scale[:, None], (s, jnp.int32(0)), (window, 1)
            )
        )(sa)[..., 0]                                              # [G, W]
    pos = jnp.arange(window, dtype=jnp.int32)[None, :]             # [1, W]
    win_mask = (pos >= off[:, None]) & (pos < (off + win_len)[:, None])  # [G, W]

    def local_vecs(idx):
        """[G, A'] local ids → dequantized f32 vectors [G, A', D]."""
        safe = jnp.maximum(idx, 0)
        v = jnp.take_along_axis(
            emb_w, safe[:, :, None], axis=1
        ).astype(jnp.float32)
        if scale_w is not None:
            v = v * jnp.take_along_axis(scale_w, safe, axis=1)[..., None]
        return v

    anchor_local = jnp.where(anchor_idx >= 0, anchor_idx - sa[:, None], -1)
    active0 = anchor_local >= 0
    anchor_vec = local_vecs(anchor_local)
    q_f = query_vec.astype(jnp.float32)
    anchor_q_sim = jnp.einsum("gad,gad->ga", q_f, anchor_vec)

    path = jnp.full((G, A, H + 1), -1, jnp.int32)
    path = path.at[:, :, 0].set(anchor_local)
    hop_score = jnp.zeros((G, A, H + 1), jnp.float32)
    hop_score = hop_score.at[:, :, 0].set(
        jnp.where(active0, 1.0 if mode == "ssg" else anchor_q_sim, 0.0)
    )
    R = min(CAND_RECORD, neighbor_k + 1)
    cand_ids = jnp.full((G, A, H, R), -1, jnp.int32)
    cand_scores = jnp.zeros((G, A, H, R), jnp.float32)

    def hop_scores(lhs):
        if scale_w is not None:
            s = jnp.einsum(
                "gad,gwd->gaw", lhs, emb_w.astype(jnp.float32),
                preferred_element_type=jnp.float32,
            ) * scale_w[:, None, :]
        else:
            s = jnp.einsum(
                "gad,gwd->gaw", lhs, emb_w,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        return s

    if mode == "triangulation":
        # same algebraic expansion as `traverse` (see comment there) —
        # but the window is small ([G, A, W] fits comfortably), so q·x is
        # precomputed ONCE for the whole traversal instead of stacking the
        # query into every hop's matmul (halves the per-hop FLOPs)
        if scale_w is not None:
            row_n2 = jnp.sum(
                emb_w.astype(jnp.float32) ** 2, axis=2
            ) * scale_w * scale_w                                  # [G, W]
        else:
            row_n2 = jnp.sum(emb_w.astype(jnp.float32) ** 2, axis=2)
        q_n2 = jnp.sum(q_f * q_f, axis=2)                          # [G, A]
        q_scores = hop_scores(q_f)                                 # [G, A, W]

    def body(hop, state):
        path, hop_score, cand_ids, cand_scores, cur_idx, cur_vec, prev_sim, active = state
        s = hop_scores(cur_vec)
        cs = jnp.where(win_mask[:, None, :], s, NEG_INF)
        vals, ids = _cand_topk(cs, neighbor_k + 1, approx_rt)     # [G, A, k+1]
        visited = jnp.any(path[:, :, :, None] == ids[:, :, None, :], axis=2)
        cand_ok = (~visited) & (vals > NEG_INF / 2)

        if mode == "ssg":
            step_score = vals
        else:
            qx = jnp.take_along_axis(q_scores, ids, axis=2)
            c_n2 = jnp.sum(cur_vec * cur_vec, axis=2)
            c_q = jnp.sum(cur_vec * q_f, axis=2)
            const = c_n2 - 4.0 * c_q + 4.0 * q_n2                  # [G, A]
            xn2 = jnp.take_along_axis(
                jnp.broadcast_to(row_n2[:, None, :], cs.shape), ids, axis=2
            )
            dist2 = (xn2 + const[:, :, None] + 2.0 * vals - 4.0 * qx) / 9.0
            step_score = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(dist2, 0.0)))

        step_score = jnp.where(cand_ok, step_score, NEG_INF)
        best_j = jnp.argmax(step_score, axis=2)                    # [G, A]
        best_score = jnp.take_along_axis(step_score, best_j[:, :, None], 2)[:, :, 0]
        best_id = jnp.take_along_axis(ids, best_j[:, :, None], 2)[:, :, 0]
        has_cand = jnp.any(cand_ok, axis=2)

        step = active & has_cand
        if mode == "ssg":
            step = step & (best_score > prev_sim)

        new_idx = jnp.where(step, best_id, cur_idx)
        path = path.at[:, :, hop + 1].set(jnp.where(step, best_id, -1))
        hop_score = hop_score.at[:, :, hop + 1].set(jnp.where(step, best_score, 0.0))

        r_vals, r_j = jax.lax.top_k(step_score, R)
        r_ids = jnp.take_along_axis(ids, r_j, axis=2)
        rec_ok = step[:, :, None] & (r_vals > NEG_INF / 2)
        cand_ids = cand_ids.at[:, :, hop, :].set(jnp.where(rec_ok, r_ids, -1))
        cand_scores = cand_scores.at[:, :, hop, :].set(jnp.where(rec_ok, r_vals, 0.0))

        new_vec = jnp.where(step[:, :, None], local_vecs(new_idx), cur_vec)
        prev_sim = jnp.where(step, best_score, prev_sim)
        return path, hop_score, cand_ids, cand_scores, new_idx, new_vec, prev_sim, step

    prev_sim0 = jnp.full(anchor_local.shape, NEG_INF)  # first hop exempt (see traverse)
    state = (
        path, hop_score, cand_ids, cand_scores,
        jnp.maximum(anchor_local, 0), anchor_vec, prev_sim0, active0,
    )
    path, hop_score, cand_ids, cand_scores, *_ = jax.lax.fori_loop(0, H, body, state)

    # local → global rows
    path_g = jnp.where(path >= 0, path + sa[:, None, None], -1)
    cand_g = jnp.where(cand_ids >= 0, cand_ids + sa[:, None, None, None], -1)
    return TraversalResult(
        path=path_g.reshape(G * A, H + 1),
        valid=(path_g >= 0).reshape(G * A, H + 1),
        hop_score=hop_score.reshape(G * A, H + 1),
        cand_ids=cand_g.reshape(G * A, H, R),
        cand_scores=cand_scores.reshape(G * A, H, R),
    )


def emit_hits(
    emb: jax.Array,
    query_vec: jax.Array,
    res: TraversalResult,
    row_scale: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Re-score traversal paths as query·chunk similarities.

    Mirrors the reference's emission re-computation
    (src/retrieval.py:1216-1233): every path element (anchor included)
    becomes a hit with similarity = inner(query, chunk).

    Returns (rows [A, H+1] i32 with -1 for invalid, sims [A, H+1] f32).
    """
    rows = res.path
    vecs = _gather_vecs(emb, row_scale, jnp.maximum(rows, 0))     # [A, H+1, D]
    sims = jnp.einsum("ad,ahd->ah", query_vec.astype(jnp.float32), vecs)
    sims = jnp.where(res.valid, sims, 0.0)
    return rows, sims

"""The on-device query engine.

One jitted graph reproduces the whole of the reference's
``VectorRetriever.retrieve_by_company_name`` fan-out + aggregation
(reference src/retrieval.py:808-1819): the (expanded query × routed
document) ThreadPoolExecutor grid (:1475-1504) becomes a padded batch
dimension; the four retrieval methods run as batched kernels; the
lock-guarded aggregation dict (:1552-1599) is `ops.aggregate.fuse_hits`.

Methods (`method=`):
  * ``basic``            — per-(query, doc) exact top-k (reference :1138-1157)
  * ``ssg``              — anchor top-1 + greedy chunk-similarity hops (:585-688)
  * ``triangulation``    — anchor top-1 + centroid-scored hops (:690-806)
  * ``hybrid_expansion`` — basic top-50 ∪ SSG(top-10 anchors) ∪ Tri(top-20
                           anchors) (:1258-1418)

Static shapes: queries are padded to ``max_queries``, routed documents to
``max_docs``; invalid slots carry ``valid=False`` and are ignored by the
fusion op.  This keeps one compiled executable per (method, k) config.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.schema import CorpusIndex, CorpusMeta
from ..ops.aggregate import FusedCandidates, fuse_hits
from ..ops.topk import LARGE_TOPK_MIN_COLS, NEG_INF
from .traversal import (
    CAND_RECORD, TraversalResult, emit_hits, traverse, traverse_windowed)

METHOD_IDS = {"basic": 0, "ssg": 1, "triangulation": 2, "bm25": 3}

# hybrid-expansion shape constants (reference src/retrieval.py:1260,1288,1355)
HYBRID_BASIC_K = 50
HYBRID_SSG_ANCHORS = 10
HYBRID_TRI_ANCHORS = 20

# Windowed traversal slices each doc's rows once ([M, W, D] copies of the
# corpus, traversal.traverse_windowed) — a ~6× hop speedup at the val-set
# shape, but at 10M-row/1.67M-window corpora those slices total a full
# corpus duplicate in HBM.  Above this copy budget the engine traverses
# PER SLOT instead (sequential lax.cond over doc slots, one transient
# [1, W, D] window alive at a time — peak copy M× smaller, and unrouted
# slots skip their hops entirely); results stay identical.  Only when a
# single window already exceeds the budget does it fall back to the
# masked full-corpus `traverse`.
TRAVERSAL_WINDOW_COPY_CAP = 4 << 30


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static retrieval configuration (one jit specialization each)."""

    method: str = "basic"
    top_k: int = 30                 # per-(query, doc) candidates for `basic`
    max_hops: int = 4               # reference default (src/retrieval.py:808 + docs)
    neighbor_k: int = 30
    max_queries: int = 8
    max_docs: int = 8
    return_parent_pages: bool = False
    top_n: int = 30                 # final aggregated candidate count
    # hybrid BM25 fusion (BASELINE.md config 2): sparse hits join the dense
    # ones as their own retrieval method (method-diversity bonus applies);
    # BM25 scores are max-normalized per query so the max-based aggregation
    # operates on a cosine-comparable [0, 1] scale
    use_bm25: bool = False
    bm25_top_k: int = 30
    # cross-method fusion rule (ops/aggregate.fuse_hits): "max" is
    # reference parity (src/retrieval.py:1639-1661 — winner-takes-all
    # across arms); "sum" adds each arm's best clamped score per key.
    # Measured (scripts/fusion_sweep.py, DESIGN.md "Sum-fusion"): at the
    # served dense quality, sum + dense_weight 0.5 lifts the config-4
    # quality eval from 0.89 to 0.945 hit@10 (BM25-alone 0.905) and
    # degrades gracefully when the dense arm is weak (0.885 vs max-mode's
    # 0.75 at a random-init encoder) — the hybrid presets ship with it
    fuse_mode: str = "max"
    # scales every non-BM25 arm's sims before fusion (only meaningful
    # with use_bm25; 1.0 = no-op).  0.5 is the measured sweet spot for
    # "sum": dense rescues BM25 misses without letting its distractors
    # outvote BM25's calibrated [0, 1] scores
    dense_weight: float = 1.0
    # IVF acceleration for the `basic` method (million-row corpora): the
    # anchor/traversal paths stay exact; recall governed by nprobe
    use_ivf: bool = False
    ivf_nprobe: int = 8
    # 10M-scale scan mode: when set (e.g. 0.999), huge-window/full-corpus
    # top-k runs lax.approx_max_k (ops.topk.approx_topk) at this recall
    # target instead of the exact one-shot sort.  Traversal hop-candidate
    # selection takes the same route when the hop's scored row is ≥
    # traversal.HOP_APPROX_MIN_COLS wide.  On the GPU XLA lowers
    # approx_max_k as an exact top-k.  None = exact everywhere.
    scan_rt: Optional[float] = None


@functools.partial(jax.jit, static_argnames=("max_q",))
def _pad_queries(qe: jax.Array, max_q: int):
    """Pad device-resident query embeddings to the static batch: one
    dispatch, no host transfer (shapes are static, so this compiles once
    per (B, max_q))."""
    B, D = qe.shape
    q = jnp.zeros((max_q, D), jnp.float32).at[:B].set(qe.astype(jnp.float32))
    qv = jnp.arange(max_q) < B
    return q, qv


def _pad_request(query_embs, max_q: int, dim: int):
    """One request's ``[B, D]`` embeddings → padded ``([max_q, D],
    [max_q])``.  Shared by :meth:`QueryEngine.search` and
    :meth:`QueryEngine.search_many` so batched and unbatched requests
    take the SAME path: device-resident inputs (e.g.
    ``EmbeddingModel.embed_device``) are padded on device — no host
    round-trip on the serving hot path — and host arrays are padded
    host-side then uploaded once."""
    if isinstance(query_embs, jax.Array):
        B = min(query_embs.shape[0], max_q)
        return _pad_queries(query_embs[:B], max_q)
    query_embs = np.asarray(query_embs, np.float32)  # lists accepted
    B = min(query_embs.shape[0], max_q)
    q = np.zeros((max_q, dim), np.float32)
    q[:B] = query_embs[:B]
    qv = np.zeros((max_q,), bool)
    qv[:B] = True
    return jnp.asarray(q), jnp.asarray(qv)


def _bm25_texts(query_texts, question: str, max_q: int) -> List[str]:
    """BM25 text list for one request, padded to ``max_q``.  Falsy
    ``query_texts`` (None OR empty) falls back to the question text —
    one rule for both the single and the micro-batched path."""
    texts = list(query_texts or [question])[:max_q]
    return texts + [""] * (max_q - len(texts))


def _flatten_hits(rows, sims, qids, mids, valid):
    """[*, k]-shaped hit blocks → flat arrays for fuse_hits."""
    return (
        rows.reshape(-1),
        sims.reshape(-1),
        qids.reshape(-1),
        mids.reshape(-1),
        valid.reshape(-1),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "window", "hier", "sharded_rows"))
def search_device(
    index: CorpusIndex,
    q: jax.Array,          # [Q, D] padded query embeddings
    q_valid: jax.Array,    # [Q] bool
    doc_masks: jax.Array,  # [M, N] bool routed row masks, one per doc slot
    doc_valid: jax.Array,  # [M] bool
    cfg: SearchConfig,
    q_terms: Optional[jax.Array] = None,  # [Q, T] hashed term ids (use_bm25)
    ivf=None,                             # IVFIndex when cfg.use_ivf
    row_slot: Optional[jax.Array] = None,  # [N] doc-slot per row (use_bm25)
    win_start: Optional[jax.Array] = None,  # [M] doc window starts (window>0)
    win_len: Optional[jax.Array] = None,    # [M] doc window lengths
    slot_doc: Optional[jax.Array] = None,  # [M] routed doc id per slot (-1 pad)
    window: int = 0,       # static doc-window size; 0 = full-corpus hops
    hier=None,             # (Mesh, slice_axis, dev_axis): dense stage runs
                           # the two-level intra-/inter-node merge (SURVEY
                           # §5) over a (slice × device)-sharded row store
    sharded_rows: bool = False,  # the row store spans several devices
) -> Tuple[FusedCandidates, Dict]:
    """Full fan-out + aggregation for one question, on device.

    Returns ``(fused_candidates, details)`` where ``details`` is a pytree of
    device arrays for observability parity with the reference
    (traversal paths/candidates, basic-vs-expansion rows — reference
    src/retrieval.py:585-688 traversal_details, :1455-1470
    algorithm_specific_results).  Empty for ``method="basic"``.

    When ``window > 0`` (documents stored as contiguous row ranges —
    always true for `index.build` corpora), traversal hops run inside
    per-document windows (`traversal.traverse_windowed`) instead of
    masked full-corpus scans; results are bit-identical.  A store whose
    rows span several devices (``sharded_rows``) is never sliced into doc
    windows: a dynamic row slice of a sharded array makes XLA gather the
    whole store onto every device, so the dense stage scans the shards in
    place and traversal hops run unwindowed — the same results.
    """
    Q, D = q.shape
    M, N = doc_masks.shape
    emb = index.emb
    details: Dict = {}
    use_window = window > 0 and win_start is not None and win_len is not None
    # traversal's per-doc window COPIES are budgeted (pair_topk's windowed
    # top-k only slices the score matrix and stays on regardless): stacked
    # [M, W, D] windows under the cap, sequential per-slot [1, W, D]
    # windows above it (see TRAVERSAL_WINDOW_COPY_CAP)
    use_window_trav = (
        use_window and not sharded_rows
        and M * window * D * emb.dtype.itemsize <= TRAVERSAL_WINDOW_COPY_CAP
    )
    use_window_seq = (
        use_window and not use_window_trav and not sharded_rows
        and window * D * emb.dtype.itemsize <= TRAVERSAL_WINDOW_COPY_CAP
    )

    # (query, doc) anchor grid: A = Q*M
    pair_mask = doc_masks[None, :, :] & q_valid[:, None, None] & doc_valid[None, :, None]
    pair_mask = pair_mask.reshape(Q * M, N)
    q_pair = jnp.repeat(q, M, axis=0)                       # [Q*M, D]
    qid_pair = jnp.repeat(jnp.arange(Q, dtype=jnp.int32), M)

    blocks: List[Tuple] = []

    def pair_topk(k: int):
        """Per-(query, doc) exact top-k, ``[Q*M, k]`` with p = q*M + m.

        Windowed corpora (docs = contiguous row ranges) score PER SLOT:
        slice the slot's ``[window, D]`` rows out of the store, matmul
        against the queries, top-k over ``[Q, window]`` — and skip
        non-routed slots entirely with ``lax.cond``.  A typical route
        keeps 1–3 of M slots, so the corpus read (the roofline at 10M
        rows) shrinks to the routed fraction, and no ``[Q, N]`` score
        matrix or ``[M, Q, W]`` stacked copy is ever materialized.

        Read-amplification gate: ``window`` is the LONGEST doc's padded
        length, so on heavily ragged corpora (one huge doc + tiny docs)
        M·window can exceed N — there the shared full scan below reads
        less even with no slots skipped; per-slot applies only while
        M·window stays within 2× the corpus."""
        k = min(k, N)
        if hier is not None:
            # multi-node path (SURVEY §5): rows sharded P((slice, device),
            # None) — local top-k per device, all_gather merge within the
            # node, then k candidates per node across nodes.  The
            # per-(query, doc) routing rides the column-sharded pair_mask.
            from ..parallel.sharded_search import make_hierarchical_topk

            mesh_h, s_ax, d_ax = hier
            int8 = index.emb_scale is not None
            kern = make_hierarchical_topk(
                mesh_h, k, s_ax, d_ax, int8=int8, pair_mask=True)
            args = (q_pair, emb, pair_mask)
            if int8:
                args = args + (index.emb_scale,)
            return kern(*args)
        if use_window and not sharded_rows and window >= k and M * window <= 2 * N:
            from ..ops.quant import int8_scores
            from ..ops.topk import large_topk_from_scores

            pos = jnp.arange(window, dtype=jnp.int32)[None, :]
            qv_col = q_valid[:, None]

            def slot_topk(m):
                # same clamp-offset trick as traverse_windowed keeps
                # local→global exact for tail docs
                sa = jnp.minimum(win_start[m], N - window)
                off = win_start[m] - sa
                eb = jax.lax.dynamic_slice(emb, (sa, jnp.int32(0)), (window, D))
                if index.emb_scale is not None:   # int8 store (ops/quant.py)
                    sc = jax.lax.dynamic_slice(index.emb_scale, (sa,), (window,))
                    s = int8_scores(q, eb, sc)
                else:
                    s = jnp.dot(
                        q, eb.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST,
                    )
                wmask = (pos >= off) & (pos < off + win_len[m])
                s = jnp.where(wmask & qv_col, s, NEG_INF)
                if window >= LARGE_TOPK_MIN_COLS:
                    # huge per-doc windows (10M-corpus configs: W = N/M ≈
                    # 1.67M): cfg.scan_rt selects approx_max_k for the
                    # [Q, W] top-k (ops/topk.py large_topk_from_scores;
                    # exact when None)
                    v, r_loc = large_topk_from_scores(s, k, approx_rt=cfg.scan_rt)
                else:
                    v, r_loc = jax.lax.top_k(s, k)
                return v, r_loc.astype(jnp.int32) + sa

            vals_m, rows_m = [], []
            for m in range(M):
                v, r = jax.lax.cond(
                    doc_valid[m],
                    functools.partial(slot_topk, m),
                    lambda: (jnp.full((Q, k), NEG_INF, jnp.float32),
                             jnp.zeros((Q, k), jnp.int32)),
                )
                vals_m.append(v)
                rows_m.append(r)
            vals = jnp.stack(vals_m, 1).reshape(Q * M, k)        # p = q*M + m
            rows = jnp.stack(rows_m, 1).reshape(Q * M, k)
            return vals, rows
        if index.emb_scale is not None:      # int8 store (ops/quant.py)
            from ..ops.quant import int8_scores

            scores_qn = int8_scores(q, emb, index.emb_scale)
        else:
            scores_qn = jnp.dot(
                q, emb.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        # fallback (fragmented corpora): one fused mask+top_k pass per doc
        # slot.  M is small and static; a [M, Q, N] broadcast-where would
        # materialize M corpus-size score copies that XLA does NOT fuse
        # into top_k — per-slot, the where fuses into the top_k input read.
        qv_col = q_valid[:, None]
        vals_m, rows_m = [], []
        for m in range(M):
            sm = jnp.where(
                doc_masks[m][None, :] & qv_col & doc_valid[m], scores_qn, NEG_INF
            )
            v, r = jax.lax.top_k(sm, k)
            vals_m.append(v)
            rows_m.append(r)
        vals = jnp.stack(vals_m, 1).reshape(Q * M, k)            # p = q*M + m
        rows = jnp.stack(rows_m, 1).reshape(Q * M, k).astype(jnp.int32)
        return vals, rows

    def basic_block(k: int):
        if cfg.use_ivf and ivf is not None:
            from ..index.ivf import ivf_search
            from ..parallel.sharded_ivf import ShardedIVF, sharded_ivf_search

            # one batched probe-search over all (query, doc) pairs.
            # Routing mode (cheapest eligible — index/ivf.ivf_search):
            # cluster-ordered corpora route by doc EQUALITY on span-
            # gathered doc ids; contiguous-range corpora by row-range
            # compares; the [B, N] boolean pair_mask (a scatter + per-
            # probe gather) only as the general fallback.
            qv_rep = jnp.repeat(q_valid, M)
            if isinstance(ivf, ShardedIVF):
                # distributed probes (parallel/sharded_ivf): per-shard
                # local search + all-gather merge inside this same jitted
                # graph — the config-5 pod path.  Routing: contiguous
                # ORIGINAL-row windows only (the doc layout of
                # index/build); cluster-ordered stores stay single-device.
                if use_window:
                    pw_s = jnp.tile(win_start, Q)
                    pw_l = jnp.where(
                        qv_rep & jnp.tile(doc_valid, Q),
                        jnp.tile(win_len, Q), 0,
                    )
                    vals, rows = sharded_ivf_search(
                        ivf, q_pair, k, nprobe=cfg.ivf_nprobe,
                        win_start=pw_s, win_len=pw_l,
                    )
                else:
                    # no [B, N] mask mode exists for the distributed
                    # probe — silently searching the whole corpus would
                    # break routing, so refuse at trace time
                    raise ValueError(
                        "ShardedIVF requires the contiguous doc-window "
                        "layout (index/build) — rebuild the corpus index "
                        "or route with win_start/win_len"
                    )
            elif slot_doc is not None and ivf.cluster_doc is not None:
                pd = jnp.where(qv_rep, jnp.tile(slot_doc, Q), -1)
                vals, rows = ivf_search(
                    ivf, q_pair, k, nprobe=cfg.ivf_nprobe,
                    pair_doc=pd, pos_doc=index.doc_id,
                )
            elif use_window and ivf.list_row_min is not None:
                # range routing needs the per-list row bounds; a legacy
                # sidecar without them falls through to the mask mode
                pw_s = jnp.tile(win_start, Q)
                pw_l = jnp.where(
                    qv_rep & jnp.tile(doc_valid, Q), jnp.tile(win_len, Q), 0
                )
                vals, rows = ivf_search(
                    ivf, q_pair, k, nprobe=cfg.ivf_nprobe,
                    win_start=pw_s, win_len=pw_l,
                )
            else:
                vals, rows = ivf_search(
                    ivf, q_pair, k, nprobe=cfg.ivf_nprobe, mask=pair_mask
                )
        else:
            vals, rows = pair_topk(k)
        ok = vals > NEG_INF / 2
        sims = jnp.where(ok, vals, 0.0)
        qids = jnp.broadcast_to(qid_pair[:, None], rows.shape)
        mids = jnp.full(rows.shape, METHOD_IDS["basic"], jnp.int32)
        return rows, sims, qids, mids, ok, vals

    if cfg.method == "basic":
        rows, sims, qids, mids, ok, _ = basic_block(cfg.top_k)
        blocks.append((rows, sims, qids, mids, ok))

    def run_traverse(anchors_pm, n: int, mode: str):
        """Traverse from ``[Q*M, n]`` global anchor rows (-1 = inactive).

        Returns ``(res, qids [·], qv [·, D])`` whose leading order is
        (m, q, n) on the windowed path and (q, m, n) otherwise — blocks
        only feed order-insensitive fusion, so the order is free."""
        if use_window_trav:
            a_g = anchors_pm.reshape(Q, M, n).transpose(1, 0, 2).reshape(M, Q * n)
            qv_g = jnp.broadcast_to(
                q.reshape(1, Q, 1, D), (M, Q, n, D)
            ).reshape(M, Q * n, D)
            res = traverse_windowed(
                emb, a_g, qv_g, win_start, win_len, index.emb_scale,
                window=window, max_hops=cfg.max_hops,
                neighbor_k=cfg.neighbor_k, mode=mode,
                approx_rt=cfg.scan_rt,
            )
            qids = jnp.tile(jnp.repeat(jnp.arange(Q, dtype=jnp.int32), n), M)
            return res, qids, qv_g.reshape(M * Q * n, D)
        if use_window_seq:
            # million-row documents: one slot's window at a time — the
            # stacked [M, W, D] copy above would exceed the HBM budget,
            # and the masked full-corpus fallback below reads all N rows
            # per hop per (query, doc) pair.  Sequential slots keep the windowed hop cost
            # ([Q·n, W] vs [Q·M·n, N] ≈ M× fewer reads) with a single
            # transient window alive, and lax.cond skips unrouted slots
            # entirely — the same per-slot design as pair_topk.
            a_g = anchors_pm.reshape(Q, M, n).transpose(1, 0, 2)   # [M, Q, n]
            qv_g1 = jnp.broadcast_to(
                q.reshape(1, Q, 1, D), (1, Q, n, D)
            ).reshape(1, Q * n, D)
            H1 = cfg.max_hops + 1
            R = min(CAND_RECORD, cfg.neighbor_k + 1)
            A1 = Q * n

            def skip_m():
                return TraversalResult(
                    path=jnp.full((A1, H1), -1, jnp.int32),
                    valid=jnp.zeros((A1, H1), bool),
                    hop_score=jnp.zeros((A1, H1), jnp.float32),
                    cand_ids=jnp.full((A1, cfg.max_hops, R), -1, jnp.int32),
                    cand_scores=jnp.zeros((A1, cfg.max_hops, R), jnp.float32),
                )

            parts = []
            for m in range(M):
                def run_m(m=m):
                    return traverse_windowed(
                        emb, a_g[m].reshape(1, Q * n), qv_g1,
                        win_start[m : m + 1], win_len[m : m + 1],
                        index.emb_scale, window=window,
                        max_hops=cfg.max_hops, neighbor_k=cfg.neighbor_k,
                        mode=mode, approx_rt=cfg.scan_rt,
                    )
                parts.append(jax.lax.cond(doc_valid[m], run_m, skip_m))
            res = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, 0), *parts
            )
            qids = jnp.tile(jnp.repeat(jnp.arange(Q, dtype=jnp.int32), n), M)
            qv_flat = jnp.broadcast_to(
                q.reshape(1, Q, 1, D), (M, Q, n, D)
            ).reshape(M * Q * n, D)
            return res, qids, qv_flat
        qv = jnp.repeat(q_pair, n, axis=0)
        res = traverse(
            emb, anchors_pm.reshape(-1), qv,
            jnp.repeat(pair_mask, n, axis=0), index.emb_scale,
            max_hops=cfg.max_hops, neighbor_k=cfg.neighbor_k, mode=mode,
            approx_rt=cfg.scan_rt,
        )
        return res, jnp.repeat(qid_pair, n), qv

    if cfg.method in ("ssg", "triangulation"):
        # anchor = top-1 per (query, doc) (reference src/retrieval.py:1164-1169)
        a_vals, a_rows = pair_topk(1)
        anchor = jnp.where(a_vals[:, 0] > NEG_INF / 2, a_rows[:, 0], -1)
        res, qids_t, qv_flat = run_traverse(anchor[:, None], 1, cfg.method)
        rows, sims = emit_hits(emb, qv_flat, res, index.emb_scale)
        qids = jnp.broadcast_to(qids_t[:, None], rows.shape)
        mids = jnp.full(rows.shape, METHOD_IDS[cfg.method], jnp.int32)
        blocks.append((rows, sims, qids, mids, res.valid))
        details["trav"] = res
        details["trav_qids"] = qids_t

    elif cfg.method == "hybrid_expansion":
        k = HYBRID_BASIC_K
        rows, sims, qids, mids, ok, vals = basic_block(k)
        blocks.append((rows, sims, qids, mids, ok))

        def expansion(mode: str, n_anchors: int):
            a_rows = rows[:, :n_anchors]                     # [Q*M, n_anchors]
            a_ok = ok[:, :n_anchors]
            anchors_pm = jnp.where(a_ok, a_rows, -1)
            res, qq, qv_flat = run_traverse(anchors_pm, n_anchors, mode)
            r, s = emit_hits(emb, qv_flat, res, index.emb_scale)
            qids_e = jnp.broadcast_to(qq[:, None], r.shape)
            mids_e = jnp.full(r.shape, METHOD_IDS[mode], jnp.int32)
            return (r, s, qids_e, mids_e, res.valid), res

        ssg_block, ssg_res = expansion("ssg", HYBRID_SSG_ANCHORS)
        tri_block, tri_res = expansion("triangulation", HYBRID_TRI_ANCHORS)
        blocks.append(ssg_block)
        blocks.append(tri_block)
        details["basic_rows"] = rows
        details["basic_ok"] = ok
        details["basic_sims"] = sims
        details["ssg"] = ssg_res
        details["tri"] = tri_res
    elif cfg.method != "basic":
        raise ValueError(f"unknown method {cfg.method!r}")

    if cfg.use_bm25 and q_terms is not None and index.sparse is not None:
        from ..index.schema import ShardedSparseIndex
        from ..ops.bm25 import bm25_topk

        # sort+segment top-k over the gathered postings: cost scales with
        # B·T·window, never materializes a [Q, N] score matrix
        k_bm = min(cfg.bm25_top_k, N)
        if isinstance(index.sparse, ShardedSparseIndex):
            # multi-device: CSR shards live beside the dense row shards;
            # per-shard top-k + the same all-gather merge (SURVEY §2.3)
            from ..parallel.sharded_sparse import sharded_bm25_topk

            bv_mqk, brows_mqk, ok_mqk = sharded_bm25_topk(
                index.sparse, q_terms, doc_masks, k_bm, row_slot=row_slot
            )
        else:
            bv_mqk, brows_mqk, ok_mqk = bm25_topk(
                index.sparse, q_terms, doc_masks, k_bm, row_slot=row_slot,
                # contiguous-range corpora: arithmetic slot instead of the
                # [N] row_slot gather (ops/bm25.py win_start doc)
                win_start=win_start if use_window else None,
                win_len=win_len if use_window else None,
            )
        # [M, Q, k] → [Q*M, k] with row index q*M + m (matches qid_pair)
        bv = bv_mqk.transpose(1, 0, 2).reshape(Q * M, k_bm)
        brows = brows_mqk.transpose(1, 0, 2).reshape(Q * M, k_bm).astype(jnp.int32)
        ok_b = ok_mqk.transpose(1, 0, 2).reshape(Q * M, k_bm)
        # invalid query/doc slots are excluded here (bm25_topk masks by doc
        # rows only; padded queries have all -1 terms → zero scores → ~ok).
        # repeat/tile, NOT fancy indexing — static-pattern gathers lower to
        # real gather ops; repeat/tile lower to broadcasts
        ok_b = ok_b & jnp.repeat(q_valid, M)[:, None] \
                    & jnp.tile(doc_valid, Q)[:, None]
        # normalize per QUERY (max over all of the query's doc slots), not
        # per (query, doc) pair — a per-pair max inflates every routed
        # document's best lexical hit to exactly 1.0 regardless of its
        # absolute relevance, destroying cross-document BM25 ordering
        per_q = jnp.max(jnp.where(ok_b, bv, 0.0).reshape(Q, M * k_bm), axis=1)
        norm = jnp.repeat(jnp.maximum(per_q, 1e-9), M)[:, None]
        sims_b = jnp.where(ok_b, bv / norm, 0.0)
        qids_b = jnp.broadcast_to(qid_pair[:, None], brows.shape)
        mids_b = jnp.full(brows.shape, METHOD_IDS["bm25"], jnp.int32)
        blocks.append((brows, sims_b, qids_b, mids_b, ok_b))

    flat = [
        jnp.concatenate(parts)
        for parts in zip(*[_flatten_hits(*b) for b in blocks])
    ]
    rows_f, sims_f, qids_f, mids_f, valid_f = flat
    valid_f = valid_f & (rows_f >= 0)
    if cfg.use_bm25 and cfg.dense_weight != 1.0:
        # weight the dense/traversal arms against BM25's max-normalized
        # [0, 1] scores (see SearchConfig.dense_weight)
        sims_f = jnp.where(
            mids_f == METHOD_IDS["bm25"], sims_f, sims_f * cfg.dense_weight
        )
    # aggregation key: parent page vs chunk row (reference :1146-1156)
    safe_rows = jnp.maximum(rows_f, 0)
    key_f = jnp.where(
        jnp.bool_(cfg.return_parent_pages),
        index.page_seg[safe_rows],
        safe_rows,
    )
    fused = fuse_hits(
        key_f, sims_f, qids_f, mids_f, rows_f, valid_f,
        top_n=cfg.top_n, mode=cfg.fuse_mode,
    )
    return fused, details


@functools.partial(jax.jit, static_argnames=("cfg", "window", "with_terms", "sharded_rows"))
def search_many_device(
    index: CorpusIndex,
    q: jax.Array,          # [R, Q, D] padded query embeddings, R requests
    q_valid: jax.Array,    # [R, Q] bool
    doc_masks: jax.Array,  # [M, N] shared routed row masks
    doc_valid: jax.Array,  # [M] bool
    cfg: SearchConfig,
    q_terms: Optional[jax.Array] = None,   # [R, Q, T] when with_terms
    ivf=None,
    row_slot: Optional[jax.Array] = None,
    win_start: Optional[jax.Array] = None,
    win_len: Optional[jax.Array] = None,
    slot_doc: Optional[jax.Array] = None,
    window: int = 0,
    with_terms: bool = False,
    sharded_rows: bool = False,
) -> FusedCandidates:
    """R concurrent requests through ONE dispatch of the fused graph.

    The reference serves concurrent questions as independent thread-pool
    tasks (reference src/questions_processing.py:1120-1130), so every
    question pays its own full corpus scan.  Here requests that share a
    route (same routed documents — e.g. every question about the one
    deployed company) vmap over `search_device`: XLA batches the per-slot
    matmuls across requests, so the corpus rows are read from HBM once
    per micro-batch instead of once per question — the scan cost is
    amortized R ways, which is exactly the bandwidth-bound regime the
    10M-row corpora sit in (DESIGN.md).

    Fusion stays PER REQUEST (a vmapped `fuse_hits`): hit-count and
    method-diversity bonuses never mix across requests.  Observability
    details are not returned in batched mode — callers needing the
    traversal payloads use `search_device`.
    """

    def one(qi, qvi, qti):
        fused, _ = search_device(
            index, qi, qvi, doc_masks, doc_valid, cfg, qti, ivf,
            row_slot, win_start, win_len, slot_doc, window=window,
            sharded_rows=sharded_rows,
        )
        return fused

    if with_terms and q_terms is not None:
        return jax.vmap(one)(q, q_valid, q_terms)
    return jax.vmap(lambda qi, qvi: one(qi, qvi, None))(q, q_valid)


class QueryEngine:
    """Host-side orchestration around `search_device`.

    Owns the corpus index + metadata and materialises device candidates
    into the reference's result-dict shape
    (reference src/retrieval.py:1719-1754).
    """

    def __init__(self, index: CorpusIndex, meta: CorpusMeta, ivf=None,
                 hier=None):
        self.index = index
        self.meta = meta
        # optional clustered index for use_ivf configs: an IVFIndex
        # (build_ivf) or a parallel.sharded_ivf.ShardedIVF (distributed
        # probes over the index's mesh — pair with a row-sharded corpus)
        self.ivf = ivf
        # optional (Mesh, slice_axis, dev_axis): dense candidates run the
        # hierarchical two-level merge (parallel/sharded_search) — pair
        # with index.emb sharded P((slice_axis, dev_axis), None)
        self.hier = hier
        # rows split across devices: search_device must not slice doc
        # windows out of the store (see its docstring)
        self.sharded_rows = len(index.emb.sharding.device_set) > 1
        self._doc_ids_np = np.asarray(index.doc_id)
        # host copies of the routing columns, pulled once: routing is a
        # host decision and must not cost a device round-trip per question
        self._year_np = np.asarray(index.year)
        self._company_np = np.asarray(index.company_id)
        self._valid_np = np.asarray(index.valid)
        self._page_np = np.asarray(index.page)
        # per-DOC routing columns: company/year are constant within a doc,
        # so routed_docs() runs route_core over [n_docs] arrays instead of
        # per-row passes (a 10M-row mask pass per question is host time
        # the QA path would pay before every search)
        live_docs = set(np.unique(self._doc_ids_np[self._valid_np]).tolist())
        self._doc_company_np = np.asarray([
            meta.companies.index(d.company) if d.company in meta.companies
            else -1 for d in meta.docs
        ], np.int32)
        self._doc_year_np = np.asarray(
            [d.year if d.year is not None else -1 for d in meta.docs],
            np.int32,
        )
        self._doc_valid_np = np.asarray(
            [i in live_docs for i in range(len(meta.docs))], bool
        )
        self._mask_cache: Dict[tuple, tuple] = {}
        # doc_masks mutates the cache (LRU refresh + eviction); concurrent
        # webapp sessions share one engine, so cache ops take this lock
        import threading

        self._cache_lock = threading.Lock()
        # per-doc contiguous row ranges → traversal hops run doc-windowed
        # (traverse_windowed); window=0 disables if any doc is fragmented
        valid = self._valid_np
        self._doc_ranges: Dict[int, Tuple[int, int]] = {}
        self.window = 0
        longest = 0
        # single pass over the valid rows: doc boundaries are the points
        # where the (already doc-grouped, when contiguous) id column
        # changes — O(N), not O(n_docs × N)
        vrows = np.flatnonzero(valid)
        if vrows.size:
            vdocs = self._doc_ids_np[vrows]
            cuts = np.flatnonzero(np.diff(vdocs)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [vrows.size]))
            seen: set = set()
            ok = True
            for s0, e0 in zip(starts, ends):
                d = int(vdocs[s0])
                if d in seen:        # doc appears in two runs → fragmented
                    ok = False
                    break
                seen.add(d)
                first, last = int(vrows[s0]), int(vrows[e0 - 1])
                if last - first + 1 != e0 - s0:  # holes inside the run
                    ok = False
                    break
                self._doc_ranges[d] = (first, e0 - s0)
                longest = max(longest, e0 - s0)
            if not ok:
                self._doc_ranges = {}
                longest = 0
        if longest:
            self.window = min(-(-longest // 128) * 128, index.n_pad)

    def build_ivf(self, quantize: Optional[bool] = None, **kwargs):
        """Cluster the corpus for SearchConfig(use_ivf=True) queries.

        The resident device matrix is consumed directly — no host
        round-trip of the corpus (build_ivf keeps it on device).  An int8
        row store is dequantized on device for clustering (k-means on raw
        int8 codes would use the wrong geometry and ivf_search would
        crash on the missing row_scale); the f32 corpus exists only
        transiently during the build.

        ``quantize`` controls the probe store over an int8 corpus:
        ``None`` (default) keeps the higher-recall f32 probe; ``True``
        re-quantizes the IVF to int8 for 4× less probe memory.  Ignored
        for f32 corpora."""
        from ..index.ivf import build_ivf, quantize_ivf

        emb = self.index.emb
        if self.index.emb_scale is not None:
            emb = emb.astype(jnp.float32) * self.index.emb_scale[:, None]
            self.ivf = build_ivf(emb, valid=self.index.valid, **kwargs)
            if quantize:
                self.ivf = quantize_ivf(self.ivf)
        else:
            self.ivf = build_ivf(emb, valid=self.index.valid, **kwargs)
        return self.ivf

    def cluster_order(self, **build_kwargs) -> "QueryEngine":
        """A new engine over the corpus rearranged into IVF cluster order.

        One row store serves both the probe path and the flat paths
        (index/ivf.cluster_order_index) — halves serving HBM vs
        flat + IVF side by side, which is what makes probe-served 10M
        int8 corpora fit one chip.  Builds the IVF first if absent
        (``build_kwargs`` forwarded to :meth:`build_ivf`).  The returned
        engine routes/queries identically; traversal runs unwindowed
        (docs are fragmented in cluster order)."""
        from ..index.ivf import cluster_order_index, quantize_ivf

        if self.ivf is None:
            self.build_ivf(**build_kwargs)
        ivf = self.ivf
        if self.index.emb_scale is not None and ivf.emb_perm.dtype != jnp.int8:
            # the IVF buffer is about to BECOME the corpus: it must keep
            # the int8 storage budget the corpus was quantized for (the
            # f32-probe-over-int8-corpus trade in build_ivf only applies
            # while both stores coexist).  Requantizing dequantized rows
            # reproduces the original codes up to per-row rescale.
            ivf = quantize_ivf(ivf)
        new_idx, new_meta, new_ivf = cluster_order_index(
            self.index, self.meta, ivf
        )
        return QueryEngine(new_idx, new_meta, ivf=new_ivf)

    # -- routing ---------------------------------------------------------
    def routed_docs(
        self,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Doc ids matching the (company, years) route, reference order.

        The SAME routing core as the device path (`routing.route_core`),
        executed on host copies of the routing columns — no device
        round-trip, no duplicated semantics."""
        from .routing import route_core

        cid = self.meta.company_id(company) if company is not None else None
        if company is not None and cid < 0:
            raise ValueError(f"No report found with '{company}' company name.")
        mask = route_core(
            np, self._doc_valid_np, self._doc_company_np, self._doc_year_np,
            cid, selected_years,
        )
        return np.flatnonzero(mask).tolist()

    def doc_masks(
        self, doc_ids: Sequence[int], max_docs: int
    ) -> Tuple[jax.Array, jax.Array]:
        if len(doc_ids) > max_docs:
            # keep the newest documents (by year, then doc id) — dropping
            # the highest ids silently loses the latest annual reports
            import warnings

            doc_ids = sorted(
                doc_ids,
                key=lambda d: (self.meta.docs[d].year or -1, d),
                reverse=True,
            )[:max_docs]
            doc_ids = sorted(doc_ids)
            warnings.warn(
                f"route matched more than max_docs={max_docs} documents; "
                f"keeping the newest {max_docs} (raise SearchConfig.max_docs "
                "to search all)",
                stacklevel=2,
            )
        key = (tuple(doc_ids), max_docs)
        with self._cache_lock:
            cached = self._mask_cache.get(key)
            if cached is not None:
                self._mask_cache[key] = self._mask_cache.pop(key)  # LRU refresh
                return cached
        m = np.zeros((max_docs, self.index.n_pad), bool)
        v = np.zeros((max_docs,), bool)
        # slot id per corpus row (max_docs = unrouted) — lets the BM25
        # top-k replace per-doc sorts with one (slot, score) sort
        slot = np.full((self.index.n_pad,), max_docs, np.int32)
        ws = np.zeros((max_docs,), np.int32)
        wl = np.zeros((max_docs,), np.int32)
        # routed doc id per slot (-1 pad) — the cluster-ordered IVF
        # doc-equality routing mode (index/ivf.ivf_search pair_doc)
        sd = np.full((max_docs,), -1, np.int32)
        valid = np.asarray(self.index.valid)
        for i, d in enumerate(doc_ids):
            m[i] = valid & (self._doc_ids_np == d)
            slot[m[i]] = i
            v[i] = True
            sd[i] = d
            if d in self._doc_ranges:
                ws[i], wl[i] = self._doc_ranges[d]
        out = (
            jnp.asarray(m), jnp.asarray(v), jnp.asarray(slot),
            jnp.asarray(ws), jnp.asarray(wl), jnp.asarray(sd),
        )
        # bounded LRU: each route holds ~(max_docs+1)·N device bytes; an
        # unbounded cache leaks HBM under many distinct year filters
        with self._cache_lock:
            self._mask_cache[key] = out
            while len(self._mask_cache) > 16:
                self._mask_cache.pop(next(iter(self._mask_cache)))
        return out

    # -- search ----------------------------------------------------------
    def search(
        self,
        query_embs: np.ndarray,
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts: Optional[Sequence[str]] = None,
        with_details: bool = False,
    ) -> FusedCandidates:
        """Run the fan-out.  ``with_details=True`` additionally returns the
        device observability pytree — feed it to :meth:`materialize_details`
        for the reference's ``retrieval_details`` / ``algorithm_contribution``
        payloads."""
        doc_ids = self.routed_docs(company, question, selected_years)
        if not doc_ids:
            raise ValueError(f"No report found with '{company}' company name.")
        dm, dv, row_slot, ws, wl, slot_doc = self.doc_masks(doc_ids, cfg.max_docs)
        q_dev, qv_dev = _pad_request(query_embs, cfg.max_queries, self.index.dim)
        q_terms = None
        if cfg.use_bm25 and self.index.sparse is not None:
            from ..ops.bm25 import encode_queries

            texts = _bm25_texts(query_texts, question, cfg.max_queries)
            q_terms = encode_queries(texts, vocab_bits=self.index.sparse.vocab_bits)
        if cfg.use_ivf and self.ivf is None:
            raise ValueError("SearchConfig.use_ivf requires QueryEngine.build_ivf() first")
        cands, details = search_device(
            self.index, q_dev, qv_dev, dm, dv, cfg, q_terms,
            self.ivf if cfg.use_ivf else None, row_slot,
            ws, wl, slot_doc, window=self.window, hier=self.hier,
            sharded_rows=self.sharded_rows,
        )
        return (cands, details) if with_details else cands

    def search_many(
        self,
        query_embs_list: Sequence[np.ndarray],
        company: Optional[str],
        question: str = "",
        selected_years: Optional[Sequence[int]] = None,
        cfg: SearchConfig = SearchConfig(),
        query_texts_list: Optional[Sequence[Optional[Sequence[str]]]] = None,
    ) -> List[FusedCandidates]:
        """R requests sharing one (company, years) route in ONE dispatch.

        Each element of ``query_embs_list`` is one request's ``[B_i, D]``
        expanded-query embeddings; results come back as one
        ``FusedCandidates`` per request, identical to R separate
        :meth:`search` calls (vmapped fusion — see ``search_many_device``).
        The request axis is padded to the next power of two (padded rows
        carry no valid queries) so the jitted graph specializes O(log R)
        times, mirroring the query/doc-slot bucketing in qa/processor.
        """
        doc_ids = self.routed_docs(company, question, selected_years)
        if not doc_ids:
            raise ValueError(f"No report found with '{company}' company name.")
        dm, dv, row_slot, ws, wl, slot_doc = self.doc_masks(doc_ids, cfg.max_docs)
        R = len(query_embs_list)
        if R == 0:
            return []
        R_pad = 1 << (R - 1).bit_length()
        if any(isinstance(qe, jax.Array) for qe in query_embs_list):
            # device-resident inputs (pipeline.query_embedder's
            # embed_device output): pad each request on device via the
            # same helper as search() — no host round-trip
            pad_q = jnp.zeros((cfg.max_queries, self.index.dim), jnp.float32)
            pad_qv = jnp.zeros((cfg.max_queries,), bool)
            rows = [
                _pad_request(qe, cfg.max_queries, self.index.dim)
                for qe in query_embs_list
            ] + [(pad_q, pad_qv)] * (R_pad - R)
            q = jnp.stack([r[0] for r in rows])
            qv = jnp.stack([r[1] for r in rows])
        else:
            # all-host batch: ONE bulk buffer + single upload — per-request
            # device puts would add R transfers to the path micro-batching
            # exists to amortize
            q_np = np.zeros((R_pad, cfg.max_queries, self.index.dim), np.float32)
            qv_np = np.zeros((R_pad, cfg.max_queries), bool)
            for r, qe in enumerate(query_embs_list):
                qe = np.asarray(qe, np.float32)
                B = min(qe.shape[0], cfg.max_queries)
                q_np[r, :B] = qe[:B]
                qv_np[r, :B] = True
            q, qv = jnp.asarray(q_np), jnp.asarray(qv_np)
        q_terms = None
        with_terms = False
        if cfg.use_bm25 and self.index.sparse is not None:
            from ..ops.bm25 import encode_queries

            vb = self.index.sparse.vocab_bits
            term_rows = []
            for r in range(R_pad):
                if r >= R:
                    # request-axis padding: all-empty, scores nothing
                    texts = [""] * cfg.max_queries
                else:
                    qt = (query_texts_list[r]
                          if query_texts_list is not None
                          and r < len(query_texts_list) else None)
                    texts = _bm25_texts(qt, question, cfg.max_queries)
                term_rows.append(encode_queries(texts, vocab_bits=vb))
            q_terms = jnp.stack([jnp.asarray(t) for t in term_rows])
            with_terms = True
        if cfg.use_ivf and self.ivf is None:
            raise ValueError(
                "SearchConfig.use_ivf requires QueryEngine.build_ivf() first"
            )
        fused = search_many_device(
            self.index, q, qv, dm, dv, cfg,
            q_terms, self.ivf if cfg.use_ivf else None, row_slot,
            ws, wl, slot_doc, window=self.window, with_terms=with_terms,
            sharded_rows=self.sharded_rows,
        )
        return [
            jax.tree_util.tree_map(lambda a, r=r: a[r], fused)
            for r in range(R)
        ]

    # -- materialisation -------------------------------------------------
    def materialize(
        self, cands: FusedCandidates, cfg: SearchConfig
    ) -> List[Dict]:
        """Device candidates → reference-shaped result dicts
        (keys follow reference src/retrieval.py:1719-1754).

        Unit note: with ``cfg.dense_weight != 1.0`` the reported
        ``distance``/``base_similarity`` for dense-only keys are the
        WEIGHTED (pre-fusion-scaled) scores, not raw cosines — see
        FusedCandidates.base_sim and DESIGN.md "Sum-fusion"."""
        # one transfer for the whole pytree instead of one per leaf
        cands = jax.device_get(cands)
        keys = np.asarray(cands.key)
        scores = np.asarray(cands.score)
        base = np.asarray(cands.base_sim)
        nq = np.asarray(cands.n_queries)
        nm = np.asarray(cands.n_methods)
        rep = np.asarray(cands.rep_row)
        pages = self._page_np
        out = []
        method_names = {v: k for k, v in METHOD_IDS.items()}
        for i in range(len(keys)):
            if keys[i] < 0:
                continue
            if cfg.return_parent_pages:
                d, pg = self.meta.page_seg_info[int(keys[i])]
                text = self.meta.page_texts.get(int(keys[i]), "")
            else:
                row = int(keys[i])
                d = int(self._doc_ids_np[row])
                pg = int(pages[row])
                text = self.meta.chunk_texts[row] if row < len(self.meta.chunk_texts) else ""
            out.append({
                "distance": float(scores[i]),
                "base_similarity": float(base[i]),
                "page": int(pg),
                "text": text,
                "source_sha1": self.meta.docs[d].sha1,
                "source_year": self.meta.docs[d].year,
                "hit_count": int(nq[i]),
                "method_count": int(nm[i]),
                "rep_row": int(rep[i]),
            })
        return out

    def materialize_details(
        self, details: Dict, cfg: SearchConfig, max_anchor_records: int = 200
    ) -> Dict:
        """Device observability pytree → the reference's payload shapes.

        Produces ``retrieval_details`` (per-anchor traversal records with
        per-hop candidates, reference src/retrieval.py:585-688 and
        :1770-1780) and, for hybrid expansion, ``algorithm_contribution``
        (per-method new-chunk stats, reference :1781-1810).  ``new_only``
        counts unique chunks (the reference sums per-(query, doc) lists,
        which can double-count across pairs).
        """
        out: Dict = {"retrieval_details": None, "algorithm_contribution": None}
        if not details:
            return out
        details = jax.device_get(details)

        def chunk_info(row: int) -> Dict:
            d = int(self._doc_ids_np[row])
            return {
                "chunk_id": int(row),
                "page": int(self._page_np[row]),
                "source_sha1": self.meta.docs[d].sha1,
            }

        def traversal_info(res) -> List[Dict]:
            path = np.asarray(res.path)
            hop_score = np.asarray(res.hop_score)
            cand_ids = np.asarray(res.cand_ids)
            cand_scores = np.asarray(res.cand_scores)
            infos = []
            for a in range(path.shape[0]):
                if path[a, 0] < 0:
                    continue
                if len(infos) >= max_anchor_records:
                    break
                p = [int(x) for x in path[a] if x >= 0]
                hops = []
                for h in range(path.shape[1] - 1):
                    sel = int(path[a, h + 1])
                    if sel < 0:
                        break
                    cands = [
                        {
                            "idx": int(cand_ids[a, h, j]),
                            "score": float(cand_scores[a, h, j]),
                            "selected": int(cand_ids[a, h, j]) == sel,
                        }
                        for j in range(cand_ids.shape[2])
                        if cand_ids[a, h, j] >= 0
                    ]
                    hops.append({
                        "hop_number": h + 1,
                        "current_chunk": int(path[a, h]),
                        "candidates": cands,
                        "selected_idx": sel,
                        "selected_score": float(hop_score[a, h + 1]),
                    })
                infos.append({
                    "anchor": {"idx": int(path[a, 0]), "score": float(hop_score[a, 0])},
                    "hops": hops,
                    "path": p,
                    "total_hops": len(hops),
                    "total_discovered": len(p),
                })
            return infos

        if cfg.method in ("ssg", "triangulation"):
            infos = traversal_info(details["trav"])
            out["retrieval_details"] = {
                "method": cfg.method,
                "traversal_info": infos[0] if len(infos) == 1 else infos,
                "max_hops": cfg.max_hops,
                "neighbor_k": cfg.neighbor_k,
            }
        elif cfg.method == "hybrid_expansion":
            basic_rows = np.asarray(details["basic_rows"])
            basic_ok = np.asarray(details["basic_ok"])
            basic_set = set(basic_rows[basic_ok].tolist())

            def method_stats(res) -> Tuple[Dict, List[Dict]]:
                hops = np.asarray(res.path)[:, 1:]
                expanded = hops[hops >= 0]
                uniq = set(expanded.tolist())
                new = sorted(uniq - basic_set)
                stats = {
                    "total_expanded": int(expanded.size),
                    "new_only": len(new),
                    "in_basic_top50": len(uniq) - len(new),
                }
                return stats, [chunk_info(r) for r in new]

            ssg_stats, ssg_new = method_stats(details["ssg"])
            tri_stats, tri_new = method_stats(details["tri"])
            out["algorithm_contribution"] = {
                "basic_retrieval_count": len(basic_set),
                "ssg_new_chunks_count": len(ssg_new),
                "triangulation_new_chunks_count": len(tri_new),
                "ssg_new_chunks": ssg_new,
                "triangulation_new_chunks": tri_new,
                "ssg_stats": ssg_stats,
                "triangulation_stats": tri_stats,
            }
            # bounded per-anchor traversal records for the UI's drill-down
            infos = traversal_info(details["ssg"])
            out["retrieval_details"] = {
                "method": cfg.method,
                "traversal_info": infos,
                "max_hops": cfg.max_hops,
                "neighbor_k": cfg.neighbor_k,
            }
        return out

"""Batched BM25 scoring over the corpus-wide CSR term index.

Replaces per-document ``BM25Okapi.get_scores`` (reference
src/ingestion.py:19-22 builds, src/retrieval.py:261-262 scores).  The
device never loops over documents: queries arrive as padded term-id
batches and postings are gathered per term with a static window.  Each
term's postings are one contiguous span of the CSR, so the gather reads
coalesced runs and XLA fuses it into the contribution arithmetic.  Two
back halves:

* ``bm25_topk`` (the serving path) — sort+segment-sum over the gathered
  postings, then per-doc top-k via one (slot, score) sort; memory scales
  with B·T·window, never the corpus.  See DESIGN.md for measurements.
* ``bm25_scores`` — materializes the full ``[B, N]`` score matrix
  (scatter-add); the oracle for tests and small corpora.

Company/year routing is applied as masks/slots — same predicate as the
dense path, replacing the reference's per-company file selection.

Scoring model: Okapi BM25 with the non-negative (Lucene-style) idf
``log(1 + (N - df + 0.5)/(df + 0.5))``.  Exact numeric parity with
rank-bm25 is impossible anyway because the reference tokenises Chinese with
``str.split()`` (a known defect, SURVEY.md §7) while we tokenise properly
(utils/tokenize.py); the sparse path targets retrieval quality, not score
equality.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..index.schema import SparseIndex
from .topk import NEG_INF


@functools.partial(jax.jit, static_argnames=("window", "n_rows", "k1", "b"))
def _bm25_scores_impl(
    indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, dl=None, *,
    window, n_rows, k1, b,
):
    B, T = query_terms.shape
    rows, contrib = _gather_contributions(
        indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms,
        window=window, k1=k1, b=b, dl=dl,
    )
    rows_flat = rows.reshape(B, T * window)
    contrib_flat = contrib.reshape(B, T * window)
    scores = jnp.zeros((B, n_rows), jnp.float32)
    scores = jax.vmap(lambda s, r, c: s.at[r].add(c))(scores, rows_flat, contrib_flat)
    return scores


def bm25_scores(
    sparse: SparseIndex,
    query_terms: jax.Array,
    n_rows: int,
    *,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> jax.Array:
    """Score every corpus row for each query.

    Args:
        sparse: the corpus CSR term index.
        query_terms: ``[B, T]`` hashed term ids, padded with -1.
        n_rows: padded corpus row count (``CorpusIndex.n_pad``).
        window: static per-term posting gather width; defaults to the
            longest posting list in the index (exact).  Postings beyond the
            window are ignored — cap long lists at build time via
            ``max_postings_per_term`` to bound this.

    Returns:
        ``[B, n_rows]`` float32 BM25 scores (0 where no term matches).
    """
    W = int(window or max(sparse.max_postings, 1))
    return _bm25_scores_impl(
        sparse.indptr,
        sparse.chunk_ids,
        sparse.tf,
        sparse.df,
        sparse.chunk_len,
        sparse.avgdl,
        query_terms,
        sparse.dl,
        window=W,
        n_rows=n_rows,
        k1=k1,
        b=b,
    )


def _gather_contributions(
    indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, *,
    window, k1, b, dl=None,
):
    """Per-(term, posting) BM25 contributions.  Returns (rows, contrib)
    of shape [B, T, W] — the shared front half of both scoring kernels.

    Positions past a list's end are clamped into the buffer and masked
    out by ``in_window``, so the CSR needs no padding.  ``dl`` is the
    optional per-POSTING doc-length array (SparseIndex.dl): doc lengths
    then ride the same span gather instead of a random
    ``chunk_len[rows]`` gather."""
    B, T = query_terms.shape
    terms = jnp.maximum(query_terms, 0)
    starts = indptr[terms]                      # [B, T]
    counts = indptr[terms + 1] - starts         # [B, T]
    counts = jnp.where(query_terms >= 0, counts, 0)

    offs = jnp.arange(window, dtype=jnp.int32)  # [W]
    in_window = offs[None, None, :] < counts[..., None]

    pos = starts[..., None] + offs              # [B, T, W]
    pos = jnp.clip(pos, 0, chunk_ids.shape[0] - 1)
    rows = chunk_ids[pos]                       # [B, T, W]
    tfv = tf[pos]                               # [B, T, W]
    dlv = dl[pos] if dl is not None else None

    n_corpus = jnp.maximum(jnp.sum(chunk_len > 0).astype(jnp.float32), 1.0)
    dfv = df[terms]                             # [B, T]
    idf = jnp.log1p((n_corpus - dfv + 0.5) / (dfv + 0.5))
    idf = jnp.where(query_terms >= 0, idf, 0.0)

    if dlv is None:
        dlv = chunk_len[rows]
    denom = tfv + k1 * (1.0 - b + b * dlv / avgdl)
    contrib = idf[..., None] * tfv * (k1 + 1.0) / jnp.maximum(denom, 1e-9)
    contrib = jnp.where(in_window, contrib, 0.0)
    return rows, contrib


@functools.partial(jax.jit, static_argnames=("window", "k", "k1", "b"))
def _bm25_topk_impl(
    indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, doc_masks,
    row_slot, win_start=None, win_len=None, dl=None, *, window, k, k1, b,
):
    B, T = query_terms.shape
    rows, contrib = _gather_contributions(
        indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms,
        window=window, k1=k1, b=b, dl=dl,
    )
    L = T * window
    r_flat = rows.reshape(B, L)
    c_flat = contrib.reshape(B, L)

    # sort postings by row id, then segment-sum per row via the cumsum
    # difference trick (contributions are non-negative → cumsum is
    # monotone → a forward cummax propagates each segment's base)
    r_s, c_s = jax.lax.sort((r_flat, c_flat), num_keys=1)
    cs = jnp.cumsum(c_s, axis=1)
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), r_s[:, 1:] != r_s[:, :-1]], axis=1
    )
    last = jnp.concatenate(
        [r_s[:, 1:] != r_s[:, :-1], jnp.ones((B, 1), bool)], axis=1
    )
    base = jax.lax.cummax(jnp.where(first, cs - c_s, 0.0), axis=1)
    totals = cs - base                       # valid at segment-last positions
    scores = jnp.where(last & (totals > 0.0), totals, NEG_INF)  # [B, L]

    M = doc_masks.shape[0]
    safe = jnp.clip(r_s, 0, doc_masks.shape[1] - 1)

    if row_slot is not None or win_start is not None:
        # ONE sort by (slot, -score) instead of M top_k passes (each a full
        # [B, L] sort): candidates land slot-major best-first, rank within
        # slot comes from a cummax of segment starts, and a second tiny
        # sort lays out the per-doc top-k.  Requires disjoint doc masks
        # (slot per row), which routing guarantees.
        if win_start is not None:
            # contiguous-range corpora (index/build layout): the slot is
            # ARITHMETIC in the row id — a [B, L, M] compare that fuses
            # away instead of a random gather from the [N] row_slot table
            in_m = (r_s[:, :, None] >= win_start[None, None, :]) & (
                r_s[:, :, None] < (win_start + win_len)[None, None, :]
            )
            slot_of_row = jnp.where(
                in_m.any(-1), jnp.argmax(in_m, -1).astype(jnp.int32), M
            )
        else:
            slot_of_row = row_slot[safe]
        slot = jnp.where(scores > NEG_INF / 2, slot_of_row, M)
        sl, negs, rr = jax.lax.sort((slot, -scores, r_s), num_keys=2)
        pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        new_slot = jnp.concatenate(
            [jnp.ones((B, 1), bool), sl[:, 1:] != sl[:, :-1]], axis=1
        )
        seg_start = jax.lax.cummax(jnp.where(new_slot, pos, 0), axis=1)
        rank = pos - seg_start
        keep = (sl < M) & (rank < k)
        p = jnp.where(keep, sl * k + rank, M * k)
        # compact kept elements to the front in p order (kept p are unique,
        # ≤ M*k of them), then scatter only the [B, M*k] head instead of
        # two full [B, L]-update scatters
        p_c, negs_c, rr_c = jax.lax.sort((p, negs, rr), num_keys=1)
        p_h, v_h, r_h = p_c[:, : M * k], -negs_c[:, : M * k], rr_c[:, : M * k]
        out_v = jnp.zeros((B, M * k + 1), jnp.float32)
        out_r = jnp.full((B, M * k + 1), -1, jnp.int32)
        out_v = jax.vmap(lambda o, i, v: o.at[i].set(v))(out_v, p_h, v_h)
        out_r = jax.vmap(lambda o, i, v: o.at[i].set(v))(out_r, p_h, r_h)
        bv = out_v[:, : M * k].reshape(B, M, k).transpose(1, 0, 2)
        br = out_r[:, : M * k].reshape(B, M, k).transpose(1, 0, 2)
        valid = br >= 0
        return jnp.where(valid, bv, 0.0), br, valid

    def per_doc(_, m):
        in_doc = doc_masks[m][safe]          # [B, L] row-eligibility gather
        sv = jnp.where(in_doc, scores, NEG_INF)
        bv, bj = jax.lax.top_k(sv, k)
        br = jnp.take_along_axis(r_s, bj, axis=1)
        return None, (bv, br)

    _, (bv, br) = jax.lax.scan(per_doc, None, jnp.arange(M))
    valid = bv > NEG_INF / 2
    return jnp.where(valid, bv, 0.0), jnp.where(valid, br, -1), valid


def bm25_topk(
    sparse: SparseIndex,
    query_terms: jax.Array,
    doc_masks: jax.Array,
    k: int,
    *,
    row_slot: Optional[jax.Array] = None,
    win_start: Optional[jax.Array] = None,
    win_len: Optional[jax.Array] = None,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-document BM25 top-k WITHOUT materializing [B, N] scores.

    Cost scales with the gathered postings (B·T·window), not the corpus
    size.

    CONTRACT for ``row_slot``: the fast path trusts it completely —
    ``doc_masks[m]`` must equal ``row_slot == m`` exactly (as
    QueryEngine.doc_masks builds them).  A mask that is a strict SUBSET of
    its slot (e.g. additionally filtered by chunk kind) would silently
    return excluded rows; pass ``row_slot=None`` to score such masks
    through the scan path.

    Precision note: per-doc totals come from an f32 cumsum difference over
    B·T·window elements; with totals ~10–30 and running sums ~1e5 the
    absolute error is ≲0.1, so candidates tied that closely may order
    differently than the scatter path.

    Args:
        query_terms: [B, T] hashed term ids, -1 padded.
        doc_masks: [M, N_pad] bool routed row masks (disjoint per row).
        k: per-(query, doc) candidates.
        row_slot: optional [N_pad] i32 — the doc slot (0..M-1) each corpus
            row belongs to, M for unrouted rows.  Supplying it replaces the
            M per-doc top_k sorts with ONE (slot, -score) sort.
        win_start / win_len: optional [M] i32 — per-slot contiguous row
            ranges (the index/build layout).  Same CONTRACT as row_slot
            (must exactly partition the routed rows), but the slot comes
            from range compares instead of a random [N] gather.  Takes
            precedence over row_slot.

    Returns:
        ``(scores [M, B, k] f32 — 0 where invalid, rows [M, B, k] i32 — -1
        where invalid, valid [M, B, k] bool)``.
    """
    W = int(window or max(sparse.max_postings, 1))
    return _bm25_topk_impl(
        sparse.indptr, sparse.chunk_ids, sparse.tf, sparse.df,
        sparse.chunk_len, sparse.avgdl, query_terms, doc_masks,
        None if win_start is not None else row_slot, win_start, win_len,
        sparse.dl,
        window=W, k=k, k1=k1, b=b,
    )


def encode_queries(texts, max_terms: int = 64, vocab_bits: int = 20):
    """Host-side: tokenize + hash query texts into a padded [B, T] id batch
    (the C++ tokenizer when available — byte-identical ids, tested in
    test_native — else the pure-Python path)."""
    return jnp.asarray(encode_queries_host(texts, max_terms, vocab_bits))


class HostBM25Scorer:
    """Host (numpy) mirror of :func:`bm25_scores` for SMALL corpora.

    Why it exists: the pretraining teacher (models/pretrain.PairSampler)
    needs a [B, N] score matrix back ON THE HOST every step to pick
    neighbor passages.  For the few-thousand-chunk training corpora the
    same arithmetic in numpy is sub-millisecond, so the sampler scores
    locally instead of waiting on a device round trip per step.

    Parity: identical formula and f32 arithmetic to
    ``_gather_contributions`` (Lucene idf, k1/b saturation, per-posting
    doc length); the full posting list is summed, which equals the device
    path's default window = ``max_postings`` (every list fits).  Scores
    agree to f32 rounding — asserted in tests/test_bm25.py.
    """

    def __init__(self, sparse: SparseIndex):
        import numpy as np

        self.indptr = np.asarray(sparse.indptr)
        self.chunk_ids = np.asarray(sparse.chunk_ids)
        self.tf = np.asarray(sparse.tf, np.float32)
        self.df = np.asarray(sparse.df, np.float32)
        self.chunk_len = np.asarray(sparse.chunk_len, np.float32)
        self.avgdl = float(np.asarray(sparse.avgdl))
        self.n_corpus = max(float((self.chunk_len > 0).sum()), 1.0)

    def scores(self, query_ids, n_rows: int, k1: float = 1.5,
               b: float = 0.75):
        """[B, n_rows] f32 scores; ``query_ids`` [B, T] numpy, -1 padded.

        Fully vectorized: one ragged posting gather over the whole batch
        (np.repeat index arithmetic) and one ``bincount`` scatter-add."""
        import numpy as np

        B, T = query_ids.shape
        q = query_ids.astype(np.int64)
        valid = q >= 0
        terms = np.where(valid, q, 0)
        starts = self.indptr[terms]                     # [B, T]
        counts = np.where(valid, self.indptr[terms + 1] - starts, 0)
        flat_counts = counts.reshape(-1)
        total = int(flat_counts.sum())
        if total == 0:
            return np.zeros((B, n_rows), np.float32)
        # ragged flat positions into the CSR arrays
        seg_base = np.repeat(np.cumsum(flat_counts) - flat_counts, flat_counts)
        pos = (np.repeat(starts.reshape(-1), flat_counts)
               + np.arange(total) - seg_base)
        rows = self.chunk_ids[pos].astype(np.int64)
        tfv = self.tf[pos]
        dfv = self.df.astype(np.float32)[terms]          # [B, T]
        idf = np.log1p((np.float32(self.n_corpus) - dfv + np.float32(0.5))
                       / (dfv + np.float32(0.5))).astype(np.float32)
        idf_p = np.repeat(idf.reshape(-1), flat_counts)
        one_minus = np.float32(k1 * (1.0 - b))
        b_over = np.float32(k1 * b / self.avgdl)
        denom = tfv + (one_minus + b_over * self.chunk_len[rows])
        contrib = (idf_p * tfv * np.float32(k1 + 1.0)
                   / np.maximum(denom, np.float32(1e-9)))
        qi = np.repeat(np.arange(B * T) // T, flat_counts)
        out = np.bincount(qi * n_rows + rows, weights=contrib,
                          minlength=B * n_rows)
        return out.reshape(B, n_rows).astype(np.float32)


def encode_queries_host(texts, max_terms: int = 64, vocab_bits: int = 20):
    """:func:`encode_queries` without the device put — numpy [B, T]."""
    import numpy as np

    from ..utils.native import tokenize_queries_native

    texts = list(texts)
    out = tokenize_queries_native(texts, vocab_bits, max_terms)
    if out is None:
        from ..utils import tokenize as tok

        out = np.full((len(texts), max_terms), -1, np.int32)
        for i, t in enumerate(texts):
            ids = tok.token_ids(t, vocab_bits)[:max_terms]
            out[i, : len(ids)] = ids
    return np.asarray(out)

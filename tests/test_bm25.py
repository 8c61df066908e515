"""BM25 CSR scorer vs a pure-numpy oracle over the same tokenisation."""

import numpy as np
import jax.numpy as jnp
import pytest

from rag_challenge_2_tpu.index import build_corpus_index
from rag_challenge_2_tpu.ops.bm25 import bm25_scores, encode_queries
from rag_challenge_2_tpu.utils import tokenize as tok

K1, B = 1.5, 0.75


def _oracle_scores(chunk_texts, query, vocab_bits):
    """Straightforward BM25 with identical tokenisation + idf formula."""
    docs = [tok.token_ids(t, vocab_bits) for t in chunk_texts]
    n = len(docs)
    avgdl = np.mean([len(d) for d in docs])
    q_ids = tok.token_ids(query, vocab_bits)
    df = {}
    for d in docs:
        for t in set(d):
            df[t] = df.get(t, 0) + 1
    out = np.zeros(n)
    for i, d in enumerate(docs):
        for t in q_ids:  # every occurrence of a query term counts once per posting
            tf = d.count(t)
            if tf == 0:
                continue
            idf = np.log1p((n - df[t] + 0.5) / (df[t] + 0.5))
            out[i] += idf * tf * (K1 + 1) / (tf + K1 * (1 - B + B * len(d) / avgdl))
    return out


def test_bm25_matches_oracle(tiny_corpus):
    idx, meta, *_ = tiny_corpus
    vb = idx.sparse.vocab_bits
    queries = ["金盘科技 营业收入", "页面2 chunk4", "doc0"]
    qt = encode_queries(queries, max_terms=32, vocab_bits=vb)
    scores = np.asarray(bm25_scores(idx.sparse, qt, idx.n_pad, k1=K1, b=B))
    for qi, q in enumerate(queries):
        expected = _oracle_scores(meta.chunk_texts, q, vb)
        np.testing.assert_allclose(scores[qi, : idx.n_chunks], expected, rtol=1e-4, atol=1e-5)
        # padding rows never score
        assert (scores[qi, idx.n_chunks :] == 0).all() or np.allclose(scores[qi, idx.n_chunks:], 0)


def test_bm25_repeated_query_terms_accumulate(tiny_corpus):
    idx, meta, *_ = tiny_corpus
    vb = idx.sparse.vocab_bits
    s1 = np.asarray(bm25_scores(idx.sparse, encode_queries(["营业收入"], 32, vb), idx.n_pad))
    s2 = np.asarray(bm25_scores(idx.sparse, encode_queries(["营业收入 营业收入"], 32, vb), idx.n_pad))
    # rank-bm25 semantics: each query-term occurrence adds its contribution
    np.testing.assert_allclose(s2[0], 2 * s1[0] - np.zeros_like(s1[0]) * 0, rtol=1e-4, atol=1e-5)


def test_bm25_empty_query(tiny_corpus):
    idx, *_ = tiny_corpus
    qt = jnp.full((1, 16), -1, jnp.int32)
    scores = np.asarray(bm25_scores(idx.sparse, qt, idx.n_pad))
    assert np.allclose(scores, 0)


def _zipf_texts(rng, n_docs, doc_len=24, vocab=200):
    """Synthetic corpus with Zipfian token frequencies (CJK-unigram-like:
    a few near-stopword terms appear in most documents)."""
    ranks = np.arange(1, vocab + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    toks = rng.choice(vocab, size=(n_docs, doc_len), p=p)
    return [" ".join(f"t{t}" for t in row) for row in toks]


def test_capped_recall_vs_uncapped():
    """DEFAULT posting cap must not change top-10 retrieval on a corpus
    whose stopword-like terms exceed the cap (high-df ⇒ near-zero idf)."""
    from rag_challenge_2_tpu.index.build import _build_sparse

    texts = _zipf_texts(np.random.default_rng(0), 400)
    n_pad = 512
    full = _build_sparse(texts, n_pad, vocab_bits=16, max_postings_per_term=None)
    capped = _build_sparse(texts, n_pad, vocab_bits=16, max_postings_per_term=64)
    assert full.max_postings > 64 >= capped.max_postings
    # df (hence idf) must be identical — the cap only bounds the gather
    np.testing.assert_array_equal(np.asarray(full.df), np.asarray(capped.df))

    docs = (0, 17, 201, 399)
    queries = [" ".join(texts[i].split()[:6]) for i in docs]
    qt = encode_queries(queries, max_terms=16, vocab_bits=16)
    s_full = np.asarray(bm25_scores(full, qt, n_pad))
    s_cap = np.asarray(bm25_scores(capped, qt, n_pad))
    recalls = []
    for qi, d in enumerate(docs):
        top_full = np.argsort(-s_full[qi])[:10]
        top_cap = np.argsort(-s_cap[qi])[:10]
        # the discriminative signal survives: a query built from a doc's own
        # terms still retrieves that doc at rank ≤ 3 under the cap
        assert d in top_cap[:3].tolist()
        recalls.append(len(set(top_full.tolist()) & set(top_cap.tolist())) / 10)
    # even at this deliberately punishing cap (16% of the corpus — real
    # indexes cap at 4096 ≫ df of anything discriminative) the only churn
    # is among near-zero-idf ties
    assert np.mean(recalls) >= 0.7, f"capped recall@10 collapsed: {recalls}"


def test_bm25_bounded_window_million_rows():
    """Kernel correctness at 1M rows with a bounded gather window: memory is
    B·T·W, never a function of the longest raw posting list."""
    from rag_challenge_2_tpu.index.schema import SparseIndex

    rng = np.random.default_rng(7)
    N, V, W = 1_000_000, 32, 64
    counts = rng.integers(8, W + 1, size=V)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    chunk_ids = rng.integers(0, N, size=nnz).astype(np.int32)
    tf = rng.integers(1, 5, size=nnz).astype(np.float32)
    df = np.zeros(V, np.float32)
    for t in range(V):
        df[t] = len(set(chunk_ids[indptr[t]:indptr[t + 1]].tolist()))
    chunk_len = np.full(N, 20.0, np.float32)
    sp = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32), chunk_ids=jnp.asarray(chunk_ids),
        tf=jnp.asarray(tf), df=jnp.asarray(df), chunk_len=jnp.asarray(chunk_len),
        avgdl=jnp.float32(20.0), vocab_bits=5, max_postings=int(counts.max()),
    )
    q = jnp.asarray([[0, 3, 31, -1]], jnp.int32)
    scores = np.asarray(bm25_scores(sp, q, N, k1=K1, b=B, window=W))
    # numpy oracle over the same CSR
    expected = np.zeros(N)
    n_corpus = N
    for t in (0, 3, 31):
        idf = np.log1p((n_corpus - df[t] + 0.5) / (df[t] + 0.5))
        for j in range(int(indptr[t]), int(indptr[t + 1])):
            r, f = chunk_ids[j], tf[j]
            expected[r] += idf * f * (K1 + 1) / (f + K1 * (1 - B + B))
    np.testing.assert_allclose(scores[0], expected, rtol=1e-4, atol=1e-5)


def test_bm25_topk_matches_dense_scores(tiny_corpus, rng):
    """Sort+segment top-k must agree with the scatter [B, N] kernel."""
    from rag_challenge_2_tpu.ops.bm25 import bm25_topk

    idx, meta, *_ = tiny_corpus
    vb = idx.sparse.vocab_bits
    queries = ["金盘科技 营业收入", "页面2 chunk4", ""]
    qt = encode_queries(queries, max_terms=16, vocab_bits=vb)
    dense = np.asarray(bm25_scores(idx.sparse, qt, idx.n_pad))

    doc_id = np.asarray(idx.doc_id)
    valid = np.asarray(idx.valid)
    doc_masks = jnp.asarray(np.stack([valid & (doc_id == d) for d in range(3)]))
    slot = np.full(idx.n_pad, 3, np.int32)
    for i in range(3):
        slot[np.asarray(doc_masks[i])] = i
    k = 5
    # per-doc contiguous ranges (index/build layout) for the win_start path
    ws = np.array([int(np.argmax(np.asarray(doc_masks[i]))) for i in range(3)], np.int32)
    wl = np.array([int(np.asarray(doc_masks[i]).sum()) for i in range(3)], np.int32)
    for rs, win in ((None, None), (jnp.asarray(slot), None),
                    (None, (jnp.asarray(ws), jnp.asarray(wl)))):
        _check_topk(idx, meta, qt, queries, dense, doc_id, valid, doc_masks,
                    k, rs, win)


def _check_topk(idx, meta, qt, queries, dense, doc_id, valid, doc_masks, k,
                row_slot, win=None):
    from rag_challenge_2_tpu.ops.bm25 import bm25_topk

    ws, wl = win if win is not None else (None, None)
    bv, br, ok = map(np.asarray, bm25_topk(
        idx.sparse, qt, doc_masks, k, row_slot=row_slot,
        win_start=ws, win_len=wl))
    for m in range(3):
        for qi in range(len(queries)):
            ref = dense[qi].copy()
            ref[~(valid & (doc_id == m))] = -np.inf
            exp_vals = sorted((v for v in ref if v > 0), reverse=True)[:k]
            got = [(r, v) for r, v, o in zip(br[m, qi], bv[m, qi], ok[m, qi]) if o]
            # same top-k score multiset (ties may pick different rows) and
            # every returned row carries its exact dense score
            np.testing.assert_allclose(
                sorted((v for _, v in got), reverse=True), exp_vals,
                rtol=1e-4, atol=1e-5,
            )
            for r, v in got:
                assert ref[r] > 0
                np.testing.assert_allclose(v, ref[r], rtol=1e-4, atol=1e-5)
            # invalid slots zeroed
            assert all(v == 0 and r == -1 for v, r, o in
                       zip(bv[m, qi], br[m, qi], ok[m, qi]) if not o)


def _csr_oracle(sp, q_terms, n_rows, use_dl):
    """numpy BM25 straight off the CSR arrays (ops/bm25.py formula)."""
    indptr = np.asarray(sp.indptr)
    ids, tf = np.asarray(sp.chunk_ids), np.asarray(sp.tf)
    df, clen = np.asarray(sp.df), np.asarray(sp.chunk_len)
    dl = np.asarray(sp.dl) if use_dl else None
    n_corpus = max(float((clen > 0).sum()), 1.0)
    out = np.zeros((len(q_terms), n_rows))
    for qi, terms in enumerate(q_terms):
        for t in terms:
            if t < 0:
                continue
            idf = np.log1p((n_corpus - df[t] + 0.5) / (df[t] + 0.5))
            for j in range(int(indptr[t]), int(indptr[t + 1])):
                length = dl[j] if use_dl else clen[ids[j]]
                denom = tf[j] + K1 * (1 - B + B * length / float(sp.avgdl))
                out[qi, ids[j]] += idf * tf[j] * (K1 + 1) / denom
    return out


@pytest.mark.parametrize("use_dl", [True, False])
@pytest.mark.parametrize("window", ["max_postings", "wider"])
def test_bm25_window_and_dl_span_match_oracle(tiny_corpus, use_dl, window):
    """The gather clamps span positions into the unpadded CSR and masks
    them: a window wider than every posting list (here past the buffer's
    end) scores exactly like the tight one.  Doc lengths read from the
    per-posting ``dl`` span equal the ``chunk_len[rows]`` gather."""
    import dataclasses

    idx, *_ = tiny_corpus
    sp = idx.sparse
    assert sp.chunk_ids.shape[0] == int(sp.indptr[-1]), "CSR carries no padding"
    if not use_dl:
        sp = dataclasses.replace(sp, dl=None)
    W = None if window == "max_postings" else sp.chunk_ids.shape[0] + 7
    queries = ["金盘科技 营业收入", "页面2 chunk4", "doc0 doc1 页面3"]
    qt = encode_queries(queries, max_terms=16, vocab_bits=sp.vocab_bits)
    got = np.asarray(bm25_scores(sp, qt, idx.n_pad, k1=K1, b=B, window=W))
    want = _csr_oracle(sp, np.asarray(qt), idx.n_pad, use_dl)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

"""Corpus index builder + persistence round-trip."""

import numpy as np
import pytest

from rag_challenge_2_tpu.index import build_corpus_index, save_index, load_index


def test_build_shapes_and_meta(tiny_corpus):
    idx, meta, reports, embs = tiny_corpus
    n = sum(e.shape[0] for e in embs)
    assert idx.n_chunks == n
    assert idx.n_docs == len(reports)
    assert idx.emb.shape[0] % 1024 == 0
    assert np.asarray(idx.valid).sum() == n
    assert len(meta.chunk_texts) == n
    # row order matches per-doc chunk order (FAISS row-order contract)
    E = np.asarray(idx.emb)[:n]
    np.testing.assert_allclose(E, np.concatenate(embs), rtol=1e-6)


def test_page_segments_are_dense_and_consistent(tiny_corpus):
    idx, meta, *_ = tiny_corpus
    seg = np.asarray(idx.page_seg)[np.asarray(idx.valid)]
    assert seg.max() == idx.n_pages - 1
    doc = np.asarray(idx.doc_id)[np.asarray(idx.valid)]
    page = np.asarray(idx.page)[np.asarray(idx.valid)]
    for s, d, p in zip(seg, doc, page):
        assert meta.page_seg_info[s] == (d, p)


def test_year_from_sha1_fallback(rng):
    reports = [{
        "metainfo": {"sha1_name": "J2025_x", "company_name": "c"},
        "content": {"pages": [{"page": 1, "text": "t"}],
                    "chunks": [{"page": 1, "text": "营业收入", "id": 0, "type": "content"}]},
    }]
    e = [np.ones((1, 8), np.float32)]
    idx, _ = build_corpus_index(reports, e, vocab_bits=12)
    assert int(np.asarray(idx.year)[0]) == 2025


def test_sparse_index_consistency(tiny_corpus):
    idx, meta, *_ = tiny_corpus
    sp = idx.sparse
    indptr = np.asarray(sp.indptr)
    assert (np.diff(indptr) >= 0).all()
    nnz = indptr[-1]
    rows = np.asarray(sp.chunk_ids)[:nnz]
    assert (rows < idx.n_chunks).all()
    # df of each term equals number of distinct chunks in its posting list
    tf = np.asarray(sp.tf)[:nnz]
    assert (tf >= 1).all()


def test_save_load_roundtrip(tiny_corpus, tmp_path):
    idx, meta, *_ = tiny_corpus
    p = tmp_path / "corpus.npz"
    save_index(p, idx, meta)
    idx2, meta2 = load_index(p)
    np.testing.assert_allclose(np.asarray(idx.emb), np.asarray(idx2.emb))
    np.testing.assert_array_equal(np.asarray(idx.page_seg), np.asarray(idx2.page_seg))
    assert idx2.n_chunks == idx.n_chunks and idx2.n_docs == idx.n_docs
    assert meta2.companies == meta.companies
    assert meta2.chunk_texts == meta.chunk_texts
    sp, sp2 = idx.sparse, idx2.sparse
    np.testing.assert_array_equal(np.asarray(sp.indptr), np.asarray(sp2.indptr))
    np.testing.assert_allclose(float(sp.avgdl), float(sp2.avgdl))


def test_load_index_reads_padded_postings(tiny_corpus, tmp_path):
    """Index files written when the CSR was over-allocated (chunk_ids/tf
    padded past indptr[-1] with the last row and tf 0) load and score
    exactly like the unpadded CSR: no span reads the padding."""
    import json

    from rag_challenge_2_tpu.ops.bm25 import bm25_scores, encode_queries

    idx, meta, *_ = tiny_corpus
    p = tmp_path / "corpus.npz"
    save_index(p, idx, meta)
    z = dict(np.load(p))
    nnz = int(z["sp_indptr"][-1])
    pad = 2048 - nnz % 1024
    z["sp_chunk_ids"] = np.concatenate(
        [z["sp_chunk_ids"], np.full(pad, idx.n_pad - 1, np.int32)])
    z["sp_tf"] = np.concatenate([z["sp_tf"], np.zeros(pad, np.float32)])
    old = tmp_path / "old.npz"
    np.savez(old, **z)
    assert json.loads(str(z["__statics__"]))["has_sparse"]

    idx2, _ = load_index(old)
    assert idx2.sparse.chunk_ids.shape[0] == nnz + pad
    qt = encode_queries(["金盘科技 营业收入", "页面2 chunk4"], 16, idx.sparse.vocab_bits)
    want = np.asarray(bm25_scores(idx.sparse, qt, idx.n_pad))
    got = np.asarray(bm25_scores(idx2.sparse, qt, idx.n_pad))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_tokenizer_version_stamp_warns(tiny_corpus, tmp_path):
    import warnings
    from rag_challenge_2_tpu.index import store as store_mod

    idx, meta, *_ = tiny_corpus
    p = tmp_path / "c.npz"
    save_index(p, idx, meta)
    # same version → silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        load_index(p)
    # simulate version bump
    orig = store_mod.TOKENIZER_VERSION
    store_mod.TOKENIZER_VERSION = "other-v9"
    try:
        with pytest.warns(UserWarning, match="tokenizer"):
            load_index(p)
    finally:
        store_mod.TOKENIZER_VERSION = orig


def test_bf16_index_round_trip(tmp_path, rng):
    """save_index/load_index must round-trip a bfloat16 row store (npz has
    no bf16 dtype — persisted as raw bits + the emb_dtype static)."""
    import jax.numpy as jnp
    from tests.conftest import make_reports
    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.index.store import load_index, save_index

    reports, embs = make_reports(rng, n_docs=2)
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12)
    import dataclasses
    idx16 = dataclasses.replace(idx, emb=idx.emb.astype(jnp.bfloat16))
    p = tmp_path / "idx16.npz"
    save_index(p, idx16, meta)
    back, meta2 = load_index(p)
    assert back.emb.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back.emb.astype(jnp.float32)),
        np.asarray(idx16.emb.astype(jnp.float32)),
    )


def test_quantize_index_idempotent(rng):
    """Re-quantizing an int8 store must be a no-op (re-quantizing CODES
    would replace true scales with ~1 and corrupt every score)."""
    from tests.conftest import make_reports
    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.index.store import quantize_index

    reports, embs = make_reports(rng, n_docs=2)
    idx, _ = build_corpus_index(reports, embs, vocab_bits=12)
    q1 = quantize_index(idx)
    q2 = quantize_index(q1)
    assert q2 is q1
    np.testing.assert_array_equal(np.asarray(q2.emb), np.asarray(q1.emb))
    np.testing.assert_array_equal(np.asarray(q2.emb_scale), np.asarray(q1.emb_scale))


def test_missing_page_text_accumulates_all_chunks(rng):
    """A page absent from content.pages but carrying several chunks must
    synthesize its page text from ALL of them, not just the first."""
    from tests.conftest import make_reports
    from rag_challenge_2_tpu.index import build_corpus_index

    reports, embs = make_reports(rng, n_docs=1)
    rep = reports[0]
    # drop page 2 from pages[] while its chunks remain
    rep["content"]["pages"] = [p for p in rep["content"]["pages"] if p["page"] != 2]
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12)
    seg = next(s for s, (d, pg) in enumerate(meta.page_seg_info) if pg == 2)
    chunks_on_2 = [c["text"] for c in rep["content"]["chunks"] if c["page"] == 2]
    assert len(chunks_on_2) >= 2
    for t in chunks_on_2:
        assert t in meta.page_texts[seg]

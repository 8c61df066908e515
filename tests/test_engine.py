"""QueryEngine end-to-end on a synthetic corpus (no network, no LLM —
the expansion/rerank stages are stubbed per SURVEY.md §4)."""

import numpy as np
import pytest

from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig


@pytest.fixture
def engine(tiny_corpus):
    idx, meta, reports, embs = tiny_corpus
    return QueryEngine(idx, meta), reports, embs


def _q_for(embs, doc, row, rng, noise=0.01):
    q = embs[doc][row] + noise * rng.normal(size=embs[doc].shape[1])
    return (q / np.linalg.norm(q)).astype(np.float32)[None, :]


def test_basic_search_finds_planted_chunk(engine, rng):
    eng, reports, embs = engine
    q = _q_for(embs, 0, 5, rng)
    cands = eng.search(q, "金盘科技", cfg=SearchConfig(method="basic", top_k=5, top_n=10))
    res = eng.materialize(cands, SearchConfig(method="basic", top_k=5, top_n=10))
    assert res, "no results"
    assert res[0]["rep_row"] == 5
    assert res[0]["source_sha1"].startswith("J2023")


def test_search_routes_by_year(engine, rng):
    eng, reports, embs = engine
    q = _q_for(embs, 0, 0, rng, noise=0.0)
    cfg = SearchConfig(method="basic", top_k=5, top_n=20)
    cands = eng.search(q, "金盘科技", selected_years=[2024], cfg=cfg)
    res = eng.materialize(cands, cfg)
    assert all(r["source_year"] == 2024 for r in res)


def test_unknown_company_raises(engine, rng):
    eng, _, embs = engine
    q = _q_for(embs, 0, 0, rng)
    with pytest.raises(ValueError, match="No report found"):
        eng.search(q, "不存在公司")


def test_multi_query_hit_bonus(engine, rng):
    eng, reports, embs = engine
    # two near-identical queries hitting the same chunk → hit_count 2, ×1.2
    q1 = _q_for(embs, 0, 5, rng, noise=0.001)
    q2 = _q_for(embs, 0, 5, rng, noise=0.002)
    cfg = SearchConfig(method="basic", top_k=3, top_n=5)
    res = eng.materialize(eng.search(np.concatenate([q1, q2]), "金盘科技", cfg=cfg), cfg)
    assert res[0]["rep_row"] == 5
    assert res[0]["hit_count"] == 2
    assert res[0]["distance"] == pytest.approx(res[0]["base_similarity"] * 1.2, rel=1e-5)


def test_parent_page_aggregation(engine, rng):
    eng, reports, embs = engine
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(method="basic", top_k=6, top_n=5, return_parent_pages=True)
    res = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    # chunk 5 of doc 0 is on page (5 // 3) + 1 = 2
    assert res[0]["page"] == 2
    assert "page" in reports[0]["content"]["pages"][0]
    # page text, not chunk text
    assert res[0]["text"].startswith("doc0 page2")


def test_hybrid_expansion_runs_and_tags_methods(engine, rng):
    eng, reports, embs = engine
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(method="hybrid_expansion", top_n=20, max_hops=2, neighbor_k=5)
    res = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    assert res
    # with 12 chunks per doc and exhaustive expansion, some key must be
    # hit by ≥2 methods → diversity bonus applied
    assert any(r["method_count"] >= 2 for r in res)
    for r in res:
        expected = (r["base_similarity"]
                    * (1 + 0.2 * (r["hit_count"] - 1))
                    * (1 + 0.1 * (r["method_count"] - 1)))
        assert r["distance"] == pytest.approx(expected, rel=1e-5, abs=1e-6)


def test_ssg_method_end_to_end(engine, rng):
    eng, reports, embs = engine
    q = _q_for(embs, 1, 3, rng)
    cfg = SearchConfig(method="ssg", top_n=10, max_hops=3, neighbor_k=4)
    res = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    assert res
    # anchor (exact row 3 of doc 1) must be among results
    rows = [r["rep_row"] for r in res]
    assert any(r >= 0 for r in rows)


def test_hybrid_bm25_fusion(engine, rng):
    eng, reports, embs = engine
    # query text matches chunk 5's text tokens; dense vector points at chunk 7
    q = _q_for(embs, 0, 7, rng, noise=0.001)
    target_text = reports[0]["content"]["chunks"][5]["text"]
    cfg = SearchConfig(method="basic", top_k=3, top_n=10, use_bm25=True, bm25_top_k=3)
    cands = eng.search(q, "金盘科技", cfg=cfg, query_texts=[target_text])
    res = eng.materialize(cands, cfg)
    rows = {r["rep_row"] for r in res}
    assert 7 in rows, "dense hit present"
    assert 5 in rows, "bm25 hit fused in"
    # bm25-only hits have method_count 1; a chunk hit by both would get 2
    by_row = {r["rep_row"]: r for r in res}
    assert by_row[5]["method_count"] >= 1
    # normalized bm25 scores stay in [0, 1.5] (bonuses aside)
    assert 0 < by_row[5]["base_similarity"] <= 1.0


def test_bm25_retriever_standalone(engine, rng):
    from rag_challenge_2_tpu.retrieval.sparse import BM25Retriever

    eng, reports, embs = engine
    rr = BM25Retriever(eng.index, eng.meta)
    text = reports[0]["content"]["chunks"][2]["text"]
    out = rr.retrieve_by_company_name("金盘科技", text, top_n=3)
    assert out and out[0]["rep_row"] == 2
    out_p = rr.retrieve_by_company_name("金盘科技", text, top_n=3, return_parent_pages=True)
    assert out_p and out_p[0]["page"] == reports[0]["content"]["chunks"][2]["page"]
    with pytest.raises(ValueError, match="No report found"):
        rr.retrieve_by_company_name("不存在", text)


def test_ivf_accelerated_basic_search(engine, rng):
    eng, reports, embs = engine
    eng.build_ivf(n_clusters=4, iters=8)
    q = _q_for(embs, 0, 5, rng)
    cfg_ivf = SearchConfig(method="basic", top_k=5, top_n=10, use_ivf=True, ivf_nprobe=4)
    cfg_exact = SearchConfig(method="basic", top_k=5, top_n=10)
    r_ivf = eng.materialize(eng.search(q, "金盘科技", cfg=cfg_ivf), cfg_ivf)
    r_exact = eng.materialize(eng.search(q, "金盘科技", cfg=cfg_exact), cfg_exact)
    # generous nprobe on a tiny corpus → identical top hit
    assert r_ivf[0]["rep_row"] == r_exact[0]["rep_row"] == 5
    # routing respected through IVF
    assert all(r["source_sha1"].startswith("J202") for r in r_ivf)


def test_use_ivf_without_build_raises(engine, rng):
    eng, _, embs = engine
    q = _q_for(embs, 0, 0, rng)
    with pytest.raises(ValueError, match="build_ivf"):
        eng.search(q, "金盘科技", cfg=SearchConfig(method="basic", use_ivf=True))


def test_doc_truncation_keeps_newest(rng):
    # 10 docs for one company with years 2015..2024, max_docs 4
    from tests.conftest import make_reports
    from rag_challenge_2_tpu.index import build_corpus_index

    reports, embs = make_reports(
        rng, n_docs=10, companies=("金盘科技",) * 10,
        years=tuple(range(2015, 2025)), pages_per_doc=1, chunks_per_page=2,
    )
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12)
    eng = QueryEngine(idx, meta)
    import warnings
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dm, dv, *_ = eng.doc_masks(eng.routed_docs("金盘科技"), max_docs=4)
        assert any("newest" in str(x.message) for x in w)
    doc_ids = np.asarray(idx.doc_id)
    searched_docs = {int(d) for i in range(4) for d in np.unique(doc_ids[np.asarray(dm[i])])}
    years = {meta.docs[d].year for d in searched_docs}
    assert years == {2021, 2022, 2023, 2024}


def test_ssg_retrieval_details(engine, rng):
    """Traversal observability parity: per-anchor path + per-hop candidates
    with the selected one flagged (reference src/retrieval.py:585-688)."""
    eng, reports, embs = engine
    q = _q_for(embs, 0, 2, rng)
    cfg = SearchConfig(method="ssg", max_hops=3, neighbor_k=4, top_n=10)
    cands, details = eng.search(q, "金盘科技", cfg=cfg, with_details=True)
    out = eng.materialize_details(details, cfg)
    rd = out["retrieval_details"]
    assert rd["method"] == "ssg" and rd["max_hops"] == 3 and rd["neighbor_k"] == 4
    infos = rd["traversal_info"]
    infos = infos if isinstance(infos, list) else [infos]
    assert infos, "at least one anchor traversal recorded"
    for info in infos:
        assert info["path"][0] == info["anchor"]["idx"]
        assert info["total_discovered"] == len(info["path"])
        assert info["total_hops"] == len(info["hops"])
        for h, hop in enumerate(info["hops"]):
            assert hop["hop_number"] == h + 1
            assert hop["current_chunk"] == info["path"][h]
            assert hop["selected_idx"] == info["path"][h + 1]
            sel = [c for c in hop["candidates"] if c["selected"]]
            assert len(sel) == 1 and sel[0]["idx"] == hop["selected_idx"]
            assert abs(sel[0]["score"] - hop["selected_score"]) < 1e-5


def test_hybrid_algorithm_contribution(engine, rng):
    """Per-method contribution stats (reference src/retrieval.py:1781-1810)."""
    eng, reports, embs = engine
    q = _q_for(embs, 0, 2, rng)
    cfg = SearchConfig(method="hybrid_expansion", max_hops=2, neighbor_k=4, top_n=20)
    cands, details = eng.search(q, "金盘科技", cfg=cfg, with_details=True)
    out = eng.materialize_details(details, cfg)
    ac = out["algorithm_contribution"]
    assert ac is not None
    for key in ("basic_retrieval_count", "ssg_new_chunks_count",
                "triangulation_new_chunks_count", "ssg_stats", "triangulation_stats"):
        assert key in ac
    assert ac["basic_retrieval_count"] > 0
    for m in ("ssg", "triangulation"):
        st = ac[f"{m}_stats"] if m == "ssg" else ac["triangulation_stats"]
        st = ac["ssg_stats"] if m == "ssg" else ac["triangulation_stats"]
        assert st["total_expanded"] >= st["new_only"] >= 0
        # in_basic_top50 counts UNIQUE expanded chunks already in the basic
        # set (occurrence-based counting double-counted repeat discoveries)
        assert 0 <= st["in_basic_top50"] <= st["total_expanded"] - st["new_only"]
        assert st["in_basic_top50"] + st["new_only"] <= st["total_expanded"]
        assert ac[f"{m}_new_chunks_count" if m == "ssg" else "triangulation_new_chunks_count"] == st["new_only"]
    for ch in ac["ssg_new_chunks"] + ac["triangulation_new_chunks"]:
        assert set(ch) == {"chunk_id", "page", "source_sha1"}
    # default (no with_details) call shape is unchanged
    cands_only = eng.search(q, "金盘科技", cfg=cfg)
    assert not isinstance(cands_only, tuple)


@pytest.mark.parametrize("method", ["basic", "ssg", "triangulation", "hybrid_expansion"])
def test_windowed_search_matches_unwindowed(engine, rng, method):
    """QueryEngine corpora are doc-contiguous, so traversal runs through
    traverse_windowed — results must be identical to the full-corpus
    masked path (window forced to 0)."""
    eng, reports, embs = engine
    assert eng.window > 0, "build_corpus_index corpora must be doc-contiguous"
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 0, 9, rng)])
    cfg = SearchConfig(method=method, top_k=8, top_n=15, max_hops=3, neighbor_k=6)
    res_w = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    saved = eng.window
    try:
        eng.window = 0
        res_f = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    finally:
        eng.window = saved
    assert len(res_w) == len(res_f)
    for a, b in zip(res_w, res_f):
        assert a["rep_row"] == b["rep_row"] and a["page"] == b["page"]
        assert a["hit_count"] == b["hit_count"] and a["method_count"] == b["method_count"]
        np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-5)


def test_windowed_falls_back_when_topk_exceeds_window(engine, rng):
    """top_k larger than the doc window must route to the per-slot masked
    fallback (still correct, just unwindowed)."""
    eng, reports, embs = engine
    assert eng.window > 0
    q = _q_for(embs, 0, 5, rng)
    big_k = eng.window + 7
    cfg = SearchConfig(method="basic", top_k=big_k, top_n=10)
    res_w = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    saved = eng.window
    try:
        eng.window = 0
        res_f = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    finally:
        eng.window = saved
    assert [r["rep_row"] for r in res_w] == [r["rep_row"] for r in res_f]
    assert res_w[0]["rep_row"] == 5


def test_ivf_on_int8_store(engine, rng):
    """build_ivf on an int8 row store must dequantize for clustering and
    default to the faster f32 probe (DESIGN.md measurement); quantize=True
    opts into the int8 probe — RunConfig(use_ivf=True, quantize_int8=True)
    previously crashed on a missing row_scale."""
    from rag_challenge_2_tpu.index.store import quantize_index

    eng, reports, embs = engine
    eng8 = QueryEngine(quantize_index(eng.index), eng.meta)
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_ivf=True, ivf_nprobe=4)

    ivf = eng8.build_ivf(n_clusters=4, iters=6)  # default: f32 probe
    assert ivf.emb_perm.dtype.name == "float32" and ivf.row_scale is None
    res = eng8.materialize(eng8.search(q, "金盘科技", cfg=cfg), cfg)
    assert res and res[0]["rep_row"] == 5

    ivf8 = eng8.build_ivf(n_clusters=4, iters=6, quantize=True)
    assert ivf8.emb_perm.dtype.name == "int8" and ivf8.row_scale is not None
    res8 = eng8.materialize(eng8.search(q, "金盘科技", cfg=cfg), cfg)
    assert res8 and res8[0]["rep_row"] == 5


def test_traversal_window_copy_cap_fallback(engine, rng, monkeypatch):
    """Above the traversal copy budget the engine must fall back to the
    masked full-corpus traverse — identical results, no [M, W, D] corpus
    slices (the 10M/1.67M-window regime where windowed slices would
    duplicate the whole corpus in HBM)."""
    import rag_challenge_2_tpu.retrieval.engine as eng_mod

    eng, reports, embs = engine
    q = _q_for(embs, 0, 5, rng)
    # distinct shape (top_k=7) → fresh jit trace under the patched cap
    cfg = SearchConfig(method="hybrid_expansion", top_k=7, top_n=12,
                       max_hops=3, neighbor_k=5)
    base = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    monkeypatch.setattr(eng_mod, "TRAVERSAL_WINDOW_COPY_CAP", 0)
    capped = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    assert [r["rep_row"] for r in capped] == [r["rep_row"] for r in base]
    for a, b in zip(capped, base):
        assert abs(a["distance"] - b["distance"]) < 1e-4
        assert a["method_count"] == b["method_count"]


@pytest.mark.parametrize("method", ["ssg", "triangulation", "hybrid_expansion"])
def test_traversal_per_slot_seq_parity(engine, rng, method, monkeypatch):
    """Between one window and M windows of copy budget the engine must run
    the per-slot sequential traversal (the 1M+/10M-row regime) — identical
    results to the stacked windowed path."""
    import rag_challenge_2_tpu.retrieval.engine as eng_mod

    eng, reports, embs = engine
    assert eng.window > 0
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 2, rng)])
    # distinct shape (top_k=11) → fresh jit trace under the patched cap
    cfg = SearchConfig(method=method, top_k=11, top_n=16,
                       max_hops=3, neighbor_k=5)
    base = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    one_window = eng.window * eng.index.dim * eng.index.emb.dtype.itemsize
    monkeypatch.setattr(eng_mod, "TRAVERSAL_WINDOW_COPY_CAP", one_window)
    seq = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    assert [r["rep_row"] for r in seq] == [r["rep_row"] for r in base]
    for a, b in zip(seq, base):
        assert abs(a["distance"] - b["distance"]) < 1e-4
        assert a["hit_count"] == b["hit_count"]
        assert a["method_count"] == b["method_count"]


def test_windowed_pair_topk_large_route_parity(engine, rng, monkeypatch):
    """Forcing the windowed pair_topk through large_topk_from_scores (the
    10M-corpus route, W >= LARGE_TOPK_MIN_COLS) must be bit-identical to
    the direct top_k slice path when scan_rt is None (exact mode)."""
    import rag_challenge_2_tpu.retrieval.engine as eng_mod

    eng, reports, embs = engine
    q = _q_for(embs, 1, 3, rng)
    cfg = SearchConfig(method="basic", top_k=9, top_n=14, use_bm25=True)
    base = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    monkeypatch.setattr(eng_mod, "LARGE_TOPK_MIN_COLS", 1)
    forced = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    assert [r["rep_row"] for r in forced] == [r["rep_row"] for r in base]
    for a, b in zip(forced, base):
        assert abs(a["distance"] - b["distance"]) < 1e-6
        assert a["method_count"] == b["method_count"]


def test_windowed_pair_topk_scan_rt_mode(engine, rng, monkeypatch):
    """scan_rt set + huge-window route: results still valid (routed rows
    only, sorted scores) and, with approx_max_k's exact fallback on the
    CPU (and the GPU), identical to exact."""
    import rag_challenge_2_tpu.retrieval.engine as eng_mod

    eng, reports, embs = engine
    q = _q_for(embs, 1, 3, rng)
    cfg = SearchConfig(method="basic", top_k=9, top_n=14)
    base = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    monkeypatch.setattr(eng_mod, "LARGE_TOPK_MIN_COLS", 1)
    cfg_rt = SearchConfig(method="basic", top_k=9, top_n=14, scan_rt=0.99)
    fast = eng.materialize(eng.search(q, "金盘科技", cfg=cfg_rt), cfg_rt)
    assert [r["rep_row"] for r in fast] == [r["rep_row"] for r in base]


def test_cluster_ordered_engine_parity(engine, rng):
    """cluster_order() rearranges the corpus into IVF list order (one
    buffer for probes + flat paths).  Results must match the flat engine:
    same texts/pages/scores, only the row numbering changes."""
    import dataclasses

    eng, reports, embs = engine
    co = eng.cluster_order(n_clusters=4, iters=8)
    assert co.window == 0, "cluster order fragments docs -> unwindowed"
    assert co.index.emb is co.ivf.emb_perm, "one shared row store"
    q = np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 1, 2, rng)])

    # dense via full probes (nprobe = n_clusters -> exact): ordered parity
    cfg_ivf = SearchConfig(method="basic", top_k=5, top_n=10,
                           use_ivf=True, ivf_nprobe=4)
    cfg_flat = dataclasses.replace(cfg_ivf, use_ivf=False)
    res_f = eng.materialize(eng.search(q, "金盘科技", cfg=cfg_flat), cfg_flat)
    res_c = co.materialize(co.search(q, "金盘科技", cfg=cfg_ivf), cfg_ivf)
    assert [r["text"] for r in res_c] == [r["text"] for r in res_f]
    assert [r["page"] for r in res_c] == [r["page"] for r in res_f]
    np.testing.assert_allclose(
        [r["distance"] for r in res_c], [r["distance"] for r in res_f],
        rtol=1e-5)

    # hybrid dense+BM25 (BM25 ties across template chunks -> compare sets)
    cfg_b = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True,
                         use_ivf=True, ivf_nprobe=4)
    cfg_bf = dataclasses.replace(cfg_b, use_ivf=False)
    qt = ["金盘科技 营业收入"]
    rb_f = eng.materialize(
        eng.search(q, "金盘科技", cfg=cfg_bf, query_texts=qt), cfg_bf)
    rb_c = co.materialize(
        co.search(q, "金盘科技", cfg=cfg_b, query_texts=qt), cfg_b)
    assert {r["text"] for r in rb_c} == {r["text"] for r in rb_f}
    np.testing.assert_allclose(
        sorted(r["distance"] for r in rb_c),
        sorted(r["distance"] for r in rb_f), rtol=1e-5)

    # traversal methods run unwindowed over the permuted store
    cfg_t = SearchConfig(method="hybrid_expansion", top_k=5, top_n=10,
                         max_hops=2, neighbor_k=4)
    rt_f = eng.materialize(eng.search(q, "金盘科技", cfg=cfg_t), cfg_t)
    rt_c = co.materialize(co.search(q, "金盘科技", cfg=cfg_t), cfg_t)
    assert [r["text"] for r in rt_c] == [r["text"] for r in rt_f]

    # routing still works post-permutation (year filter)
    cfg_y = SearchConfig(method="basic", top_k=5, top_n=20)
    ry = co.materialize(co.search(q, "金盘科技", selected_years=[2024], cfg=cfg_y), cfg_y)
    assert ry and all(r["source_year"] == 2024 for r in ry)


def test_cluster_ordered_int8_store(engine, rng):
    """An int8 corpus cluster-orders through the quantized IVF: the shared
    store stays int8 (emb_scale = ivf row scales) and probes still find
    the planted neighbor."""
    from rag_challenge_2_tpu.index.store import quantize_index

    eng, reports, embs = engine
    idx8 = quantize_index(eng.index)
    eng8 = QueryEngine(idx8, eng.meta)
    co = eng8.cluster_order(n_clusters=4, iters=8, quantize=True)
    assert co.index.emb.dtype == np.int8 and co.index.emb_scale is not None
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10,
                       use_ivf=True, ivf_nprobe=4)
    res = co.materialize(co.search(q, "金盘科技", cfg=cfg), cfg)
    assert res and res[0]["text"].endswith("chunk5"), res[0]


def test_ragged_corpus_gates_windowed_pair_topk(rng):
    """One huge doc + tiny docs: M*window > 2N, so pair_topk must take the
    shared full-scan fallback — results identical to a windowed corpus of
    the same content (the gate is a perf decision, not a semantic one)."""
    from rag_challenge_2_tpu.index import build_corpus_index
    from tests.conftest import make_reports

    reports, embs = [], []
    # doc 0: 300 pages (huge); docs 1-2: 1 page each -> window ~= doc0 len
    # (900 chunks -> 896+128 padded window), N_pad = 1024, so
    # M*window = 3*896 > 2*1024 trips the gate
    for d, n_pages in enumerate((300, 1, 1)):
        r, e = make_reports(
            np.random.default_rng(d), n_docs=1, companies=("金盘科技",),
            years=(2022 + d,), pages_per_doc=n_pages)
        r[0]["metainfo"]["sha1_name"] = f"J{2022+d}_doc{d}"
        reports.append(r[0])
        embs.append(e[0])
    idx, meta = build_corpus_index(reports, embs, vocab_bits=16)
    eng = QueryEngine(idx, meta)
    assert eng.window > 0
    assert 3 * eng.window > 2 * idx.n_pad, "fixture must trip the gate"
    q = _q_for(embs, 0, 17, rng)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, max_docs=3)
    res_w = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    saved = eng.window
    try:
        eng.window = 0
        res_f = eng.materialize(eng.search(q, "金盘科技", cfg=cfg), cfg)
    finally:
        eng.window = saved
    assert [r["rep_row"] for r in res_w] == [r["rep_row"] for r in res_f]
    assert res_w[0]["rep_row"] == 17


def test_cluster_order_preserves_int8_budget_by_default(engine, rng):
    """cluster_order over an int8 corpus must keep the int8 storage budget
    even when the prebuilt IVF is the (default) f32 probe store — the IVF
    buffer is about to BECOME the corpus, so serving f32 would 4x the HBM
    the corpus was quantized for (the scale10m preset's whole point)."""
    from rag_challenge_2_tpu.index.store import quantize_index

    eng, reports, embs = engine
    idx8 = quantize_index(eng.index)
    eng8 = QueryEngine(idx8, eng.meta)
    eng8.build_ivf(n_clusters=4, iters=8)        # default: f32 probe store
    assert eng8.ivf.emb_perm.dtype == np.float32
    co = eng8.cluster_order()
    assert co.index.emb.dtype == np.int8 and co.index.emb_scale is not None
    q = _q_for(embs, 0, 5, rng)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10,
                       use_ivf=True, ivf_nprobe=4)
    res = co.materialize(co.search(q, "金盘科技", cfg=cfg), cfg)
    assert res and res[0]["text"].endswith("chunk5"), res[0]


# ---------------------------------------------------------------- search_many
def _assert_cands_equal(a, b, tol=1e-5):
    import jax

    a = jax.device_get(a)
    b = jax.device_get(b)
    assert np.asarray(a.key).tolist() == np.asarray(b.key).tolist()
    assert np.asarray(a.rep_row).tolist() == np.asarray(b.rep_row).tolist()
    assert np.asarray(a.n_queries).tolist() == np.asarray(b.n_queries).tolist()
    assert np.asarray(a.n_methods).tolist() == np.asarray(b.n_methods).tolist()
    np.testing.assert_allclose(
        np.asarray(a.score), np.asarray(b.score), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("method,use_bm25", [
    ("basic", False), ("basic", True), ("hybrid_expansion", True),
])
def test_search_many_matches_individual(engine, rng, method, use_bm25):
    """R batched requests == R separate search() calls, field for field
    (fusion stays per request — bonuses never mix across the batch)."""
    eng, reports, embs = engine
    cfg = SearchConfig(method=method, top_k=5, top_n=10,
                       use_bm25=use_bm25, max_queries=4)
    reqs = [
        np.concatenate([_q_for(embs, 0, 5, rng), _q_for(embs, 0, 5, rng)]),
        _q_for(embs, 1, 3, rng),
        _q_for(embs, 2, 7, rng),
    ]
    texts = [["金盘科技 营业收入", "营收"], ["毛利率"], None]
    batched = eng.search_many(
        reqs, "金盘科技", cfg=cfg, query_texts_list=texts
    )
    assert len(batched) == len(reqs)
    for qe, qt, got in zip(reqs, texts, batched):
        want = eng.search(qe, "金盘科技", cfg=cfg, query_texts=qt)
        _assert_cands_equal(got, want)


def test_search_many_empty_texts_and_device_queries(engine, rng):
    """Two regressions: an EXPLICIT empty query_texts list must take the
    same question-fallback as search() (falsy, not 'use as-is'), and
    device-resident jax.Array query embeddings must batch without a host
    round-trip and still match search()."""
    import jax.numpy as jnp

    eng, reports, embs = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10,
                       use_bm25=True, max_queries=4)
    reqs = [jnp.asarray(_q_for(embs, 0, 5, rng)),
            jnp.asarray(_q_for(embs, 1, 3, rng))]
    texts = [[], None]  # [] must behave exactly like None
    batched = eng.search_many(
        reqs, "金盘科技", question="营业收入是多少",
        cfg=cfg, query_texts_list=texts,
    )
    for qe, qt, got in zip(reqs, texts, batched):
        want = eng.search(qe, "金盘科技", question="营业收入是多少",
                          cfg=cfg, query_texts=qt)
        _assert_cands_equal(got, want)


def test_search_many_single_request(engine, rng):
    eng, reports, embs = engine
    cfg = SearchConfig(method="basic", top_k=5, top_n=10)
    q = _q_for(embs, 0, 5, rng)
    got = eng.search_many([q], "金盘科技", cfg=cfg)[0]
    want = eng.search(q, "金盘科技", cfg=cfg)
    _assert_cands_equal(got, want)


def test_search_many_with_ivf(engine, rng):
    eng, reports, embs = engine
    eng.build_ivf(n_clusters=4, iters=8)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10,
                       use_ivf=True, ivf_nprobe=4)
    reqs = [_q_for(embs, 0, 5, rng), _q_for(embs, 1, 3, rng)]
    batched = eng.search_many(reqs, "金盘科技", cfg=cfg)
    for qe, got in zip(reqs, batched):
        want = eng.search(qe, "金盘科技", cfg=cfg)
        _assert_cands_equal(got, want)

"""Web frontend: drive the HTTP API against a live server."""

import json
import threading
import urllib.request

import pytest


@pytest.fixture
def webapp(tiny_corpus, rng):
    from tests.test_qa import make_processor, BASE_SCRIPT
    from rag_challenge_2_tpu.serving.webapp import QAWebApp

    proc, provider = make_processor(tiny_corpus, rng, dict(BASE_SCRIPT))
    app = QAWebApp(proc, default_company="金盘科技")
    server = app.make_server(port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}", provider
    server.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/api/ask", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req).read())


def test_index_page_and_bank(webapp):
    url, _ = webapp
    html = urllib.request.urlopen(url + "/").read().decode()
    assert "金盘科技年报问答" in html and "hybrid_expansion" in html
    bank = json.loads(urllib.request.urlopen(url + "/api/bank").read())
    assert isinstance(bank, dict) and bank
    assert all(isinstance(v, list) and v for v in bank.values())
    assert "财务数据" in bank


def test_ask_endpoint_full_payload(webapp):
    url, _ = webapp
    out = _post(url, {"question": "2023年营业收入是多少", "method": "basic",
                      "schema": "number", "top_n": 5})
    assert out["final_answer"] == 68.9
    assert out["relevant_pages"]
    assert "all_retrieved_chunks" in out and "timing" in out


def test_ask_with_config_override_and_years(webapp):
    url, _ = webapp
    out = _post(url, {"question": "营业收入", "method": "ssg", "max_hops": 2,
                      "neighbor_k": 4, "years": [2023]})
    assert "error" not in out
    # only 2023 docs retrieved
    for c in out["all_retrieved_chunks"]:
        assert "doc" in c["text"] or c["text"]


def test_ask_empty_question(webapp):
    url, _ = webapp
    out = _post(url, {"question": "  "})
    assert out["error"] == "empty question"


def test_ask_with_history(webapp):
    url, provider = webapp
    out = _post(url, {"question": "那净利润呢", "history": [
        {"question": "2023年营收", "answer": "68.9"}]})
    assert "error" not in out
    assert any("历史对话上下文" in c["user"] for c in provider.calls)


def test_eval_endpoint(webapp):
    url, provider = webapp
    provider.scripted["标准答案"] = json.dumps(
        {"score": 1.0, "reasoning": "一致", "is_correct": True}, ensure_ascii=False)
    out = _post_path(url, "/api/eval", {"records": [
        {"question": "2024年营收是多少", "standard_answer": "68.9亿", "rag_answer": "68.9亿"},
    ]})
    assert out["statistics"]["accuracy"] == 1.0
    out2 = _post_path(url, "/api/eval", {"records": []})
    assert "error" in out2


def _post_path(url, path, payload):
    req = urllib.request.Request(
        url + path, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req).read())


def test_page_viewer_endpoint(webapp):
    url, _ = webapp
    # a page that exists in the tiny corpus (doc J2023_doc0, page 1)
    out = json.loads(urllib.request.urlopen(
        url + "/api/page?doc=J2023_doc0&page=1").read())
    assert out["page"] == 1 and "page1" in out["text"]
    missing = json.loads(urllib.request.urlopen(
        url + "/api/page?doc=J2023_doc0&page=99").read())
    assert "error" in missing
    bad = json.loads(urllib.request.urlopen(
        url + "/api/page?doc=x&page=abc").read())
    assert "error" in bad


def test_eval_run_endpoint(webapp):
    """The evaluation-analysis flow: answer through the pipeline, judge,
    aggregate (reference app_jinpan_qa.py:2846+)."""
    url, provider = webapp
    provider.scripted["标准答案"] = json.dumps(
        {"score": 1.0, "reasoning": "数值一致", "is_correct": True}, ensure_ascii=False)
    out = _post_path(url, "/api/eval_run", {
        "records": [{"question": "2023年营业收入是多少", "standard_answer": "68.9"}],
        "method": "basic", "top_n": 5,
    })
    assert out["statistics"]["total"] == 1
    rec = out["records"][0]
    assert rec["rag_answer"] == "68.9"
    assert rec["evaluation"]["is_correct"] is True
    assert rec["references"], "answered records carry citations"


def test_ask_expansion_config_passthrough(webapp):
    """expand_top_k / expand_context_size reach the processor config, and
    the sidebar carries the token estimator (reference app_jinpan_qa.py
    :1801-1808)."""
    url, _ = webapp
    out = _post(url, {"question": "2023年营业收入是多少", "method": "basic",
                      "expand_upstream": False, "expand_top_k": 7,
                      "expand_context_size": 2, "top_n": 5})
    assert "error" not in out
    html = urllib.request.urlopen(url + "/").read().decode()
    assert "expand_top_k" in html and "tokenEstimate" in html
    assert "Token 预估" in html


def test_eval_run_survives_failing_question(tiny_corpus, rng):
    """One question whose pipeline raises must not discard the batch —
    the record carries an error and the rest are answered and judged."""
    from tests.test_qa import make_processor, BASE_SCRIPT
    from rag_challenge_2_tpu.serving.webapp import QAWebApp

    proc, provider = make_processor(tiny_corpus, rng, dict(BASE_SCRIPT))
    provider.scripted["评审"] = json.dumps(
        {"score": 1.0, "reasoning": "ok", "is_correct": True}, ensure_ascii=False
    )
    app = QAWebApp(proc, default_company="金盘科技")
    orig_ask = app.ask

    def flaky(payload):
        if "炸" in payload.get("question", ""):
            raise RuntimeError("boom")
        return orig_ask(payload)

    app.ask = flaky
    out = app.eval_run({"records": [
        {"question": "金盘科技2024年营业收入是多少", "standard": "68.9"},
        {"question": "炸一下", "standard": "x"},
    ]})
    recs = out.get("records", out.get("results", []))
    assert len(recs) == 2
    errs = [r for r in recs if r.get("error")]
    assert len(errs) == 1 and "boom" in errs[0]["error"]
    assert any(r.get("rag_answer") for r in recs), recs


def test_eval_run_concurrent_workers(tiny_corpus, rng):
    """eval_run answers records through a worker pool (reference batches QA
    parallel_requests wide, src/questions_processing.py:1120-1130) —
    concurrency must be real AND order-preserving."""
    import threading as _th
    import time

    from tests.test_qa import make_processor, BASE_SCRIPT
    from rag_challenge_2_tpu.serving.webapp import QAWebApp

    proc, provider = make_processor(tiny_corpus, rng, dict(BASE_SCRIPT))
    provider.scripted["评审"] = json.dumps(
        {"score": 1.0, "reasoning": "ok", "is_correct": True}, ensure_ascii=False
    )
    app = QAWebApp(proc, default_company="金盘科技")

    gate = _th.Barrier(4, timeout=10)

    def slow_ask(payload):
        gate.wait()  # only passes if 4 questions run CONCURRENTLY
        return {"final_answer": payload["question"][-1], "references": [1]}

    app.ask = slow_ask
    records = [{"question": f"问题{i}", "standard": "x"} for i in range(4)]
    out = app.eval_run({"records": records, "parallel_requests": 4})
    assert [r["rag_answer"] for r in out["records"]] == ["0", "1", "2", "3"]
    assert out["statistics"]["total"] == 4


def test_page_viewer_image_feature_gate(tiny_corpus, rng, tmp_path, monkeypatch):
    """PDF page images render when PyMuPDF + the source PDF exist; the
    indexed-text fallback always works (reference app_jinpan_qa.py:307-352
    shows images; fitz is optional in this environment)."""
    import base64
    import sys
    import types

    from tests.test_qa import make_processor, BASE_SCRIPT
    from rag_challenge_2_tpu.serving.webapp import QAWebApp

    proc, _ = make_processor(tiny_corpus, rng, dict(BASE_SCRIPT))
    sha1 = proc.engine.meta.docs[0].sha1

    # no pdf_dir → text only
    app = QAWebApp(proc)
    out = app.page({"doc": [sha1], "page": ["1"]})
    assert out["text"] and "image_png_base64" not in out

    # fake fitz + a pdf file → image + text
    class FakePix:
        def tobytes(self, fmt):
            return b"PNGDATA"

    class FakePage:
        def get_pixmap(self, dpi):
            return FakePix()

    class FakeDoc:
        page_count = 5

        def __getitem__(self, i):
            assert i == 0  # 1-based page 1 → 0-based index 0
            return FakePage()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    fake = types.ModuleType("fitz")
    fake.open = lambda p: FakeDoc()
    monkeypatch.setitem(sys.modules, "fitz", fake)
    (tmp_path / f"{sha1}.pdf").write_bytes(b"%PDF-fake")
    app2 = QAWebApp(proc, pdf_dir=tmp_path)
    out2 = app2.page({"doc": [sha1], "page": ["1"]})
    assert base64.b64decode(out2["image_png_base64"]) == b"PNGDATA"
    assert out2["text"]

    # out-of-range page → text fallback, no crash
    out3 = app2.page({"doc": [sha1], "page": ["4"]})
    assert "image_png_base64" not in out3 or out3.get("image_png_base64")


def test_pdf_page_viewer_serves_source_bytes(tiny_corpus, rng, tmp_path):
    """With pdf_dir set, /api/page returns a pdf_url with a #page anchor
    and /api/pdf streams the raw source bytes (the dependency-free
    cited-page viewer, reference app_jinpan_qa.py:307-352)."""
    from tests.test_qa import make_processor, BASE_SCRIPT
    from rag_challenge_2_tpu.serving.webapp import QAWebApp

    blob = b"%PDF-1.4\nfixture-bytes\n%%EOF\n"
    (tmp_path / "J2023_doc0.pdf").write_bytes(blob)
    proc, _ = make_processor(tiny_corpus, rng, dict(BASE_SCRIPT))
    app = QAWebApp(proc, default_company="金盘科技", pdf_dir=tmp_path)
    server = app.make_server(port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        out = json.loads(urllib.request.urlopen(
            url + "/api/page?doc=J2023_doc0&page=2").read())
        assert out["pdf_url"] == "/api/pdf?doc=J2023_doc0#page=2"
        got = urllib.request.urlopen(url + "/api/pdf?doc=J2023_doc0")
        assert got.headers["Content-Type"] == "application/pdf"
        assert got.read() == blob
        # docs without a source PDF keep the text-only contract
        out2 = json.loads(urllib.request.urlopen(
            url + "/api/page?doc=J2024_doc1&page=1").read())
        assert "pdf_url" not in out2 and out2["page"] == 1
        # missing / traversal-shaped names 404
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/api/pdf?doc=nope")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/api/pdf?doc=..%2FJ2023_doc0")
    finally:
        server.shutdown()

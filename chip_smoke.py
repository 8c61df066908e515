"""End-to-end proof that the retrieval system runs on an NVIDIA GPU.

Run from the root of a checkout on a machine with one GPU::

    python chip_smoke.py            # phases 0-4 on one card
    python chip_smoke.py --multi    # the four-card phase only

Single card, one process:

0. Device check: a GPU backend, every device a GPU; prints the device
   kind and ``nvidia-smi``'s name and power limit.
1. The demo set through the pipeline's own stages (parse → merge → chunk
   → index, with a short encoder pretraining run), then ``load_index`` +
   ``QueryEngine.search/materialize`` for every demo question, compared
   with the same calls on the CPU device of this process.
2. The encoder at its production width: 4096 chunks of ~300 tokens
   through ``EmbeddingModel.embed``, against the same parameters' float32
   forward at highest matmul precision.
3. The validation-set shape (6 reports × 1700 chunks × 1024-d, 127
   year-routed questions): dense search against a float64 numpy oracle,
   ``bm25_topk`` against a numpy BM25 oracle, the fused
   ``hybrid_expansion`` path, and the micro-batcher under concurrent
   requests.
4. The million-row tier: the IVF probe over f32, bf16 and int8 stores
   against the exact scans, the int8 exact scan against an integer
   oracle, and BM25 with posting windows of 1024.

``--multi`` (four cards): sharded hybrid search over 10M × 1024 bf16 rows
against the single-card result, the two-level merge against the flat
merge, and one data-parallel training step against one card.

Every comparison prints its numbers and tolerance; any failure exits
non-zero.  The last line of standard output is one JSON object naming
the device.  Without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke"          # scratch inside the checkout (gitignored)
COMPANY = "金盘科技"


class CheckFailed(AssertionError):
    """A comparison fell outside its tolerance."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# --------------------------------------------------------------- helpers

def require_gpu(jax_module, n_devices: int = 1) -> list:
    """The GPU devices, or SystemExit when the backend is anything else."""
    backend = jax_module.default_backend()
    devices = jax_module.devices()
    platforms = sorted({d.platform for d in devices})
    if backend != "gpu" or platforms != ["gpu"]:
        raise SystemExit(
            f"chip_smoke: needs a GPU backend; found backend {backend!r} "
            f"with devices on {platforms}")
    if len(devices) < n_devices:
        raise SystemExit(
            f"chip_smoke: needs {n_devices} GPUs, found {len(devices)}")
    return devices


def nvidia_smi(*query: str) -> str:
    """One line per card, joined with "; "."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(query)}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def compute_app_pids() -> set:
    """PIDs ``nvidia-smi`` lists as holding a GPU context (may be empty
    where the container hides other PID namespaces)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {int(p) for p in out.split() if p.isdigit()}


def compare_topk(got_rows, got_scores, ref_rows, ref_scores, atol: float):
    """Ranked lists agree: scores position by position within ``atol``, and
    rows equal except where the reference ranks rows whose scores tie
    within ``atol`` (a neighbour in the list, or the cutoff at the end).

    Returns ``(max |Δscore|, positions that differ only by such a tie)``;
    raises :class:`CheckFailed` otherwise."""
    got_rows, ref_rows = np.asarray(got_rows), np.asarray(ref_rows)
    got_scores = np.asarray(got_scores, np.float64)
    ref_scores = np.asarray(ref_scores, np.float64)
    check(got_rows.shape == ref_rows.shape,
          f"shape {got_rows.shape} vs reference {ref_rows.shape}")
    diff = float(np.max(np.abs(got_scores - ref_scores), initial=0.0))
    check(diff <= atol, f"|Δscore| {diff:.3g} > {atol}")
    swaps = 0
    n = len(ref_rows)
    for i in np.flatnonzero(got_rows != ref_rows):
        tied = i == n - 1 or any(
            0 <= j < n and abs(ref_scores[i] - ref_scores[j]) <= atol
            for j in (i - 1, i + 1))
        check(tied, f"row {got_rows[i]} vs {ref_rows[i]} at rank {i} "
                    f"(score {ref_scores[i]:.6f}) is not a tie")
        swaps += 1
    return diff, swaps


def recall_at_k(got_rows, ref_rows) -> float:
    got_rows, ref_rows = np.asarray(got_rows), np.asarray(ref_rows)
    hits = [len(set(g.tolist()) & set(r.tolist())) / max(len(r), 1)
            for g, r in zip(got_rows, ref_rows)]
    return float(np.mean(hits))


def numpy_topk(scores: np.ndarray, k: int):
    """Descending top-k of a score vector, lower index first on ties."""
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return order, scores[order]


def bm25_oracle(indptr, chunk_ids, tf, df, chunk_len, q_terms, n_rows,
                k1: float = 1.5, b: float = 0.75) -> np.ndarray:
    """``[B, n_rows]`` float64 Okapi BM25 straight off a CSR: idf
    ``log(1 + (N - df + 0.5) / (df + 0.5))`` with N the non-empty rows,
    saturation ``tf (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl))``."""
    indptr = np.asarray(indptr, np.int64)
    chunk_ids = np.asarray(chunk_ids, np.int64)
    tf = np.asarray(tf, np.float64)
    df = np.asarray(df, np.float64)
    chunk_len = np.asarray(chunk_len, np.float64)
    n_corpus = max(float((chunk_len > 0).sum()), 1.0)
    live = chunk_len[chunk_len > 0]
    avgdl = float(live.mean()) if live.size else 1.0
    out = np.zeros((len(q_terms), n_rows))
    for qi, terms in enumerate(np.asarray(q_terms)):
        for t in terms[terms >= 0]:
            s, e = indptr[t], indptr[t + 1]
            idf = np.log1p((n_corpus - df[t] + 0.5) / (df[t] + 0.5))
            f = tf[s:e]
            rows = chunk_ids[s:e]
            norm = k1 * (1.0 - b + b * chunk_len[rows] / avgdl)
            np.add.at(out[qi], rows, idf * f * (k1 + 1.0) / (f + norm))
    return out


def check_bm25(jax, sp, q_terms, masks, n_rows, window, oracle) -> str:
    """The two BM25 scorers against the numpy oracle ``[B, n_rows]``.

    ``bm25_scores`` (one scatter-add per posting) must agree within 1e-4:
    the formula, the gather and the idf are checked there.
    ``bm25_topk`` forms each row's total as a difference of two f32 prefix
    sums over the query's sorted postings (ops/bm25.py), so its error
    grows with the prefix sum S: the tolerance is 1e-4 + 2·⌈log2 L⌉·2⁻²⁴·S
    for L = T·window postings.  Rows must match per document except ties."""
    import jax.numpy as jnp

    from rag_challenge_2_tpu.ops.bm25 import bm25_scores, bm25_topk

    dense = np.asarray(bm25_scores(sp, q_terms, n_rows, window=window))
    d_scatter = float(np.max(np.abs(dense - oracle)))
    check(d_scatter <= 1e-4, f"bm25_scores |Δ| {d_scatter:.3g} > 1e-4")
    n_docs = len(masks)
    slot = np.full(n_rows, n_docs, np.int32)
    for d in range(n_docs):
        slot[masks[d]] = d
    bv, br, ok = map(np.asarray, bm25_topk(
        sp, q_terms, jnp.asarray(masks), 10, row_slot=jnp.asarray(slot),
        window=window))
    L = np.asarray(q_terms).shape[1] * window
    worst, worst_tol, swaps = 0.0, 0.0, 0
    for i in range(len(oracle)):
        tol = 1e-4 + 2 * int(np.ceil(np.log2(L))) * 2.0**-24 * oracle[i].sum()
        for d in range(n_docs):
            r_rows, r_vals = numpy_topk(np.where(masks[d], oracle[i], -np.inf), 10)
            keep = r_vals > 0
            dd, s = compare_topk(br[d, i][ok[d, i]], bv[d, i][ok[d, i]],
                                 r_rows[keep], r_vals[keep], atol=tol)
            if dd > worst:
                worst, worst_tol = dd, tol
            swaps += s
    return (f"bm25_scores max |Δ| {d_scatter:.3g} (tol 1e-4); bm25_topk "
            f"rows equal per doc, max |Δ| {worst:.3g} (tol there "
            f"{worst_tol:.3g}), {swaps} tie swaps")


_WORDS = (
    "营业收入 净利润 研发费用 毛利率 现金流 资产负债率 干式变压器 储能系统 "
    "海外市场 数字化工厂 应收账款 存货周转 分红方案 募集资金 主营业务 "
    "销售费用 管理费用 财务费用 所得税 每股收益 股东权益 在建工程 固定资产 "
    "产能利用率 订单 客户 供应链 原材料 成本 同比增长 环比下降 报告期 公司 "
    "子公司 控股 投资 项目 风险 政策 行业 技术 产品 质量 安全 环境 治理"
).split()


def synthetic_texts(rng: np.random.Generator, n: int, n_words: int) -> list:
    """``n`` Chinese report-like passages of ``n_words`` words each, with
    figures mixed in (≈ 300 hashed tokens at 50 words)."""
    out = []
    for _ in range(n):
        words = rng.choice(_WORDS, size=n_words)
        nums = rng.integers(1, 999, size=n_words // 8)
        parts = list(words)
        for j, v in enumerate(nums):
            parts.insert(8 * j + 3, f"{v}.{rng.integers(0, 99)}亿元")
        out.append("，".join(parts) + "。")
    return out


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _parse_in_worker(parser, path):
    """Spawned worker: parse one file; report whether JAX opened a backend."""
    import jax._src.xla_bridge as xb

    parser.parse_and_export([path])
    return os.getpid(), xb.backends_are_initialized()


# ---------------------------------------------------------- phase 0: device

def phase_device(jax, n_devices: int = 1) -> dict:
    devs = require_gpu(jax, n_devices)
    smi = nvidia_smi("name", "power.limit")
    log(f"[phase 0] jax {jax.__version__} backend={jax.default_backend()} "
        f"devices={len(devs)} kind={devs[0].device_kind!r}")
    log(f"[phase 0] nvidia-smi: {smi}")
    return {"kind": devs[0].device_kind, "count": len(devs), "smi": smi}


# ------------------------------------------------------------ phase 1: demo

def phase_demo(jax, data_dir: Path, pretrain_steps: int = 20) -> None:
    from rag_challenge_2_tpu.index import load_index
    from rag_challenge_2_tpu.ingestion.pdf import PlainTextParser
    from rag_challenge_2_tpu.pipeline import Pipeline, configs
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig
    from rag_challenge_2_tpu.utils.native import native_available

    t0 = time.perf_counter()
    root = WORK / "test_set"
    shutil.copytree(data_dir, root,
                    ignore=shutil.ignore_patterns("databases", "debug_data"))
    log(f"[phase 1] native CSR builder used: {native_available()}")

    # spawn workers parse without opening the card (one JAX process per card)
    parser = PlainTextParser(WORK / "worker_parse", root / "subset.csv")
    inputs = sorted((root / "pdf_reports").glob("*.txt"))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as ex:
        results = list(ex.map(_parse_in_worker, [parser] * len(inputs), inputs))
        apps = compute_app_pids()          # workers are still alive here
    worker_pids = {pid for pid, _ in results}
    check(not any(opened for _, opened in results),
          "a parse worker initialised a JAX backend")
    check(not worker_pids & apps,
          f"parse workers {sorted(worker_pids & apps)} hold the card")
    log(f"[phase 1] spawn parse workers {sorted(worker_pids)}: no JAX backend "
        f"initialised; nvidia-smi compute processes "
        f"{sorted(apps) or 'none listed'} (this process: {os.getpid()})")

    os.environ["RAGTPU_AUTO_PRETRAIN_STEPS"] = str(pretrain_steps)
    p = Pipeline(root, configs["base"])
    p.parse_pdf_reports()
    p.process_parsed_reports()            # merge → markdown → chunk → index
    log(f"[phase 1] pipeline built {p.paths.index_path.name} "
        f"(encoder pretrained {pretrain_steps} steps) in "
        f"{time.perf_counter() - t0:.1f} s")

    questions = [q["question"] for q in
                 json.loads((root / "questions.json").read_text("utf-8"))]
    idx, meta = load_index(p.paths.index_path)
    eng = QueryEngine(idx, meta)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        idx_c, meta_c = load_index(p.paths.index_path)
        eng_c = QueryEngine(idx_c, meta_c)
    cfgs = {
        "basic+bm25": SearchConfig(method="basic", top_k=10, top_n=10,
                                   use_bm25=True),
        "hybrid_expansion": SearchConfig(method="hybrid_expansion", top_n=10,
                                         use_bm25=True),
    }
    worst, swaps, n_rows = 0.0, 0, 0
    for q in questions:
        company = next((c for c in meta.companies if c and c in q), None)
        q_emb = np.asarray(p.embedder([q]), np.float32)
        for name, cfg in cfgs.items():
            got = eng.materialize(
                eng.search(q_emb, company, q, cfg=cfg, query_texts=[q]), cfg)
            with jax.default_device(cpu):
                ref = eng_c.materialize(
                    eng_c.search(q_emb, company, q, cfg=cfg, query_texts=[q]),
                    cfg)
            check(len(got) > 0 and len(got) == len(ref),
                  f"{name}: {len(got)} rows vs {len(ref)} on the CPU")
            d, s = compare_topk([r["rep_row"] for r in got],
                                [r["distance"] for r in got],
                                [r["rep_row"] for r in ref],
                                [r["distance"] for r in ref], atol=1e-5)
            worst, swaps, n_rows = max(worst, d), swaps + s, n_rows + len(got)
    log(f"[phase 1] {len(questions)} questions × {list(cfgs)}: {n_rows} rows "
        f"equal to the CPU device's, max |Δscore| {worst:.3g} (tol 1e-5), "
        f"{swaps} tie swaps; {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------- phase 2: encoder

def phase_encoder(jax, n_chunks: int = 4096, n_words: int = 50,
                  cfg=None) -> None:
    import jax.numpy as jnp

    from rag_challenge_2_tpu.models.encoder import (
        EmbeddingModel, EncoderConfig, encode, tokenize_batch)

    cfg = cfg or EncoderConfig()
    rng = np.random.default_rng(1)
    texts = synthetic_texts(rng, n_chunks, n_words)
    toks = tokenize_batch(texts[:256], cfg.max_len, cfg.vocab_bits)
    mean_tokens = float((toks >= 0).sum(1).mean())
    model = EmbeddingModel(cfg, seed=0)
    t0 = time.perf_counter()
    model.embed(texts[:512])                         # compile
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = model.embed(texts)
    dt = time.perf_counter() - t0

    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    ref_fwd = jax.jit(functools.partial(encode, cfg=cfg32))
    refs = []
    with jax.default_matmul_precision("highest"):
        for s in range(0, n_chunks, 256):
            ids = tokenize_batch(texts[s:s + 256], cfg.max_len, cfg.vocab_bits,
                                 bucket_len=True)
            refs.append(np.asarray(ref_fwd(model.params, jnp.asarray(ids))))
    ref = np.concatenate(refs)
    cos = np.sum(got * ref, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    check(got.shape == (n_chunks, cfg.out_dim) and np.isfinite(got).all(),
          f"embeddings {got.shape}, finite={np.isfinite(got).all()}")
    check(cos.min() >= 0.995, f"min cosine to the f32 forward {cos.min():.5f}")
    log(f"[phase 2] encoder d{cfg.d_model}×{cfg.n_layers}L out {cfg.out_dim}: "
        f"{n_chunks} chunks of ~{mean_tokens:.0f} tokens, min cosine to the "
        f"f32 highest-precision forward {cos.min():.5f} (tol ≥ 0.995); "
        f"compile {compile_s:.1f} s")
    log(f"[phase 2] encoder throughput {n_chunks / dt:.1f} chunks/s on "
        f"{jax.devices()[0].device_kind} (bf16 activations, batch 512)")


# ----------------------------------------------------- phase 3: val shape

def phase_valset(jax, n_docs: int = 6, per_doc: int = 1700, dim: int = 1024,
                 n_q: int = 127, n_threads: int = 16) -> None:
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.ops.bm25 import encode_queries
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig
    from rag_challenge_2_tpu.retrieval.routing import extract_years_from_question
    from rag_challenge_2_tpu.serving.batcher import MicroBatcher

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    years = [2019 + d for d in range(n_docs)]
    reports, embs = [], []
    for d, y in enumerate(years):
        texts = synthetic_texts(rng, per_doc, 20)
        chunks = [{"page": i // 10 + 1, "text": t, "id": i, "type": "content"}
                  for i, t in enumerate(texts)]
        pages = [{"page": g + 1, "text": "\n".join(texts[10 * g:10 * g + 10])}
                 for g in range(-(-per_doc // 10))]
        reports.append({"metainfo": {"sha1_name": f"J{y}_val", "year": y,
                                     "company_name": COMPANY},
                        "content": {"pages": pages, "chunks": chunks}})
        embs.append(unit_rows(rng, per_doc, dim))
    idx, meta = build_corpus_index(reports, embs)
    eng = QueryEngine(idx, meta)
    E64 = np.concatenate(embs).astype(np.float64)
    year_of_row = np.repeat(years, per_doc)
    metrics = ["营业收入", "净利润", "研发费用", "毛利率", "现金流"]
    q_years = rng.integers(years[0], years[-1] + 1, size=n_q)
    questions = [f"{COMPANY}{y}年{metrics[i % 5]}是多少？"
                 for i, y in enumerate(q_years)]
    # queries near a routed row, so the top-10 is not noise
    anchor = [rng.choice(np.flatnonzero(year_of_row == y)) for y in q_years]
    q = E64[anchor] + 0.05 * rng.normal(size=(n_q, dim))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    log(f"[phase 3] corpus {idx.n_chunks} × {dim} f32, CSR nnz "
        f"{int(idx.sparse.indptr[-1])}, built in {time.perf_counter() - t0:.1f} s")

    # dense: QueryEngine vs a float64 oracle over the routed rows
    cfg = SearchConfig(method="basic", top_k=10, top_n=10, max_queries=1)
    recalls, worst = [], 0.0
    t1 = time.perf_counter()
    routes = [extract_years_from_question(t) for t in questions]
    for i, question in enumerate(questions):
        cands = jax.device_get(eng.search(q[i:i + 1], COMPANY, question,
                                          selected_years=routes[i], cfg=cfg))
        rows, sims = np.asarray(cands.key), np.asarray(cands.base_sim)
        routed = np.isin(year_of_row, routes[i])
        scores = np.where(routed, E64 @ q[i].astype(np.float64), -np.inf)
        ref_rows, ref_sims = numpy_topk(scores, 10)
        recalls.append(recall_at_k(rows[None], ref_rows[None]))
        worst = max(worst, float(np.max(np.abs(np.sort(sims) - np.sort(ref_sims)))))
    dense_s = time.perf_counter() - t1
    check(min(recalls) == 1.0, f"dense recall@10 {min(recalls)} < 1.0")
    check(worst <= 1e-5, f"dense |Δscore| {worst:.3g} > 1e-5")
    log(f"[phase 3] dense: {n_q} routed queries, recall@10 vs float64 oracle "
        f"{np.mean(recalls):.4f} (min {min(recalls):.4f}, need 1.0), max "
        f"|Δscore| {worst:.3g} (tol 1e-5); {dense_s:.1f} s incl. compile")

    # BM25: both scorers vs the numpy oracle
    sp = idx.sparse
    q_terms = encode_queries(questions, max_terms=64, vocab_bits=sp.vocab_bits)
    doc_id, valid = np.asarray(idx.doc_id), np.asarray(idx.valid)
    masks = np.stack([valid & (doc_id == d) for d in range(n_docs)])
    oracle = bm25_oracle(sp.indptr, sp.chunk_ids, sp.tf, sp.df, sp.chunk_len,
                         q_terms, idx.n_pad)
    log(f"[phase 3] BM25, {n_q} queries × {n_docs} docs, window "
        f"{sp.max_postings}: "
        + check_bm25(jax, sp, q_terms, masks, idx.n_pad, sp.max_postings, oracle))

    # fused hybrid_expansion
    cfg_he = SearchConfig(method="hybrid_expansion", top_n=10, use_bm25=True)
    for i in range(4):
        res = eng.materialize(eng.search(q[i:i + 1], COMPANY, questions[i],
                                         selected_years=routes[i], cfg=cfg_he,
                                         query_texts=[questions[i]]), cfg_he)
        check(len(res) == 10 and all(np.isfinite(r["distance"]) for r in res),
              f"hybrid_expansion returned {len(res)} rows")
    log("[phase 3] hybrid_expansion (basic + SSG + triangulation + BM25 + "
        "fusion): 4 questions, 10 finite rows each")

    # micro-batcher: concurrent same-route requests vs unbatched calls
    cfg_mb = SearchConfig(method="basic", top_k=10, top_n=10, use_bm25=True)
    same = [i for i in range(n_q) if q_years[i] == q_years[0]][:n_threads]
    want = {i: jax.device_get(eng.search(
        q[i:i + 1], COMPANY, questions[i], selected_years=routes[i], cfg=cfg_mb,
        query_texts=[questions[i]])) for i in same}
    batcher = MicroBatcher(eng, max_batch=8, window_ms=50.0)
    got, errors = {}, []

    def worker(i):
        try:
            got[i] = jax.device_get(batcher.search(
                q[i:i + 1], COMPANY, questions[i], selected_years=routes[i],
                cfg=cfg_mb, query_texts=[questions[i]]))
        except Exception as e:  # reported below, fails the phase
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in same]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and all(not t.is_alive() for t in threads),
          f"micro-batcher errors {errors}")
    for i in same:
        compare_topk(got[i].key, got[i].score, want[i].key, want[i].score,
                     atol=1e-5)
    st = batcher.stats
    check(st["batched_requests"] == len(same) and st["dispatches"] < len(same),
          f"micro-batcher did not coalesce: {st}")
    log(f"[phase 3] micro-batcher: {len(same)} concurrent requests in "
        f"{st['dispatches']} dispatches, rows equal to unbatched calls "
        f"(tol 1e-5); phase {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------- phase 4: million rows

def phase_million(jax, n_rows: int = 1_000_000, dim: int = 1024,
                  n_lists: int = 4096, n_q: int = 127,
                  bm25_terms_bits: int = 14, bm25_window: int = 1024) -> None:
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.ivf import build_ivf, ivf_search, quantize_ivf
    from rag_challenge_2_tpu.index.schema import SparseIndex
    from rag_challenge_2_tpu.ops.quant import quantize_rows
    from rag_challenge_2_tpu.ops.topk import blocked_topk, dense_topk

    t0 = time.perf_counter()
    kc, ka, kn, kr, kq = jax.random.split(jax.random.PRNGKey(4), 5)
    n_centers = max(8, min(1024, n_rows // 64))

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen(n):
        centers = jax.random.normal(kc, (n_centers, dim), jnp.float32)
        centers /= jnp.linalg.norm(centers, axis=1, keepdims=True)
        a = jax.random.randint(ka, (n,), 0, n_centers)
        e = centers[a] + (0.35 / np.sqrt(dim)) * jax.random.normal(kn, (n, dim))
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    emb = gen(n_rows)
    pick = jax.random.randint(kr, (n_q,), 0, n_rows)
    q = emb[pick] + (0.25 / np.sqrt(dim)) * jax.random.normal(kq, (n_q, dim))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    ivf = build_ivf(emb, n_clusters=n_lists, iters=8,
                    max_list_size=max(2 * n_rows // n_lists, 16))
    jax.block_until_ready(ivf.emb_perm)
    K = ivf.k_clusters
    log(f"[phase 4] corpus {n_rows} × {dim}, IVF K={K} max_list="
        f"{ivf.max_list}, generated + built in {time.perf_counter() - t0:.1f} s")

    x8, sc = quantize_rows(emb)
    exact = {
        "f32": dense_topk(q, emb, 10),
        "bf16": dense_topk(q, emb.astype(jnp.bfloat16).astype(jnp.float32), 10),
        "int8": blocked_topk(q, x8, 10, row_scale=sc),
    }
    stores = {
        "f32": ivf,
        "bf16": dataclasses.replace(ivf, emb_perm=ivf.emb_perm.astype(jnp.bfloat16)),
        "int8": quantize_ivf(ivf),
    }
    f32_rows = np.asarray(exact["f32"][1])
    for name, store in stores.items():
        t1 = time.perf_counter()
        full_v, full_r = map(np.asarray, ivf_search(store, q, 10, nprobe=K))
        ex_v, ex_r = map(np.asarray, exact[name])
        worst, swaps = 0.0, 0
        for i in range(n_q):
            d, s = compare_topk(full_r[i], full_v[i], ex_r[i], ex_v[i], atol=1e-5)
            worst, swaps = max(worst, d), swaps + s
        _, r8 = ivf_search(store, q, 10, nprobe=8)
        rec = recall_at_k(np.asarray(r8), f32_rows)
        log(f"[phase 4] IVF {name} store: nprobe=K={K} equals the exact "
            f"{name} scan (max |Δscore| {worst:.3g}, tol 1e-5, {swaps} tie "
            f"swaps); nprobe=8 recall@10 vs exact f32 {rec:.4f}; "
            f"{time.perf_counter() - t1:.1f} s")

    # int8 exact scan vs an integer-accumulated oracle (float64 BLAS over
    # int8 codes is exact: |Σ| ≤ 1024·127² < 2^53)
    q8, qs = map(np.asarray, quantize_rows(q))
    x8n, scn = np.asarray(x8), np.asarray(sc)
    q8f = q8.astype(np.float64)
    oracle = np.empty((n_q, n_rows), np.float32)
    for s in range(0, n_rows, 131072):
        acc = q8f @ x8n[s:s + 131072].astype(np.float64).T
        oracle[:, s:s + 131072] = (acc.astype(np.float32) * qs[:, None]
                                   * scn[None, s:s + 131072])
    ex_v, ex_r = map(np.asarray, exact["int8"])
    worst, swaps = 0.0, 0
    for i in range(n_q):
        r_rows, r_vals = numpy_topk(oracle[i], 10)
        d, s = compare_topk(ex_r[i], ex_v[i], r_rows, r_vals, atol=1e-6)
        worst, swaps = max(worst, d), swaps + s
    log(f"[phase 4] int8 blocked_topk equals the int32-accumulated oracle: "
        f"max |Δscore| {worst:.3g} (tol 1e-6), {swaps} tie swaps")
    del oracle, emb, x8

    # BM25 with posting windows of bm25_window over n_rows rows
    rng = np.random.default_rng(5)
    V = 1 << bm25_terms_bits
    counts = rng.integers(1, bm25_window + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    ids = rng.integers(0, n_rows, size=nnz).astype(np.int32)
    tfs = rng.integers(1, 5, size=nnz).astype(np.float32)
    clen = rng.integers(50, 400, size=n_rows).astype(np.float32)
    df = counts.astype(np.float32)
    sp = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32), chunk_ids=jnp.asarray(ids),
        tf=jnp.asarray(tfs), df=jnp.asarray(df), chunk_len=jnp.asarray(clen),
        avgdl=jnp.float32(clen.mean()), dl=jnp.asarray(clen[ids]),
        vocab_bits=bm25_terms_bits, max_postings=bm25_window)
    q_terms = rng.integers(0, V, size=(8, 64)).astype(np.int32)
    q_terms[:, 48:] = -1
    n_docs = 6
    doc_of_row = np.minimum(np.arange(n_rows) * n_docs // n_rows, n_docs - 1)
    masks = np.stack([doc_of_row == d for d in range(n_docs)])
    oracle = bm25_oracle(indptr, ids, tfs, df, clen, q_terms, n_rows)
    log(f"[phase 4] BM25 window {bm25_window} over {nnz} postings × {n_rows} "
        f"rows: " + check_bm25(jax, sp, jnp.asarray(q_terms), masks, n_rows,
                              bm25_window, oracle))
    log(f"[phase 4] done in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------- four-card phase

def phase_multi(jax, n_rows: int = 10_000_000, dim: int = 1024,
                n_lists: int = 256, v_bits: int = 18, window: int = 512,
                enc_cfg=None, n_dev: int = 4) -> None:
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_challenge_2_tpu.index.schema import (
        CorpusIndex, CorpusMeta, DocMeta, SparseIndex)
    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu.parallel.mesh import make_mesh
    from rag_challenge_2_tpu.parallel.sharded_ivf import build_sharded_ivf
    from rag_challenge_2_tpu.parallel.sharded_search import (
        hierarchical_dense_topk, sharded_dense_topk)
    from rag_challenge_2_tpu.parallel.sharded_sparse import shard_sparse_index
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

    t0 = time.perf_counter()
    devs = jax.devices()[:n_dev]
    n_docs, n_q = 6, 4
    chunk = min(n_rows, 1_000_000)
    kc, kq, kn = jax.random.split(jax.random.PRNGKey(6), 3)

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen(i, n):
        k = jax.random.fold_in(kc, i)
        e = jax.random.normal(k, (n, dim), jnp.float32)
        return (e / jnp.linalg.norm(e, axis=1, keepdims=True)).astype(jnp.bfloat16)

    with jax.default_device(devs[0]):
        emb0 = jnp.concatenate([gen(i, min(chunk, n_rows - s))
                                for i, s in enumerate(range(0, n_rows, chunk))])
        rows = jnp.arange(n_rows, dtype=jnp.int32)
        doc_id = jnp.minimum(rows * n_docs // n_rows, n_docs - 1)
        rng = np.random.default_rng(6)
        V = 1 << v_bits
        counts = rng.integers(1, window + 1, size=V).astype(np.int64)
        indptr = np.zeros(V + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
        # varied document lengths, so BM25 scores rarely tie exactly
        chunk_len = jax.random.randint(k3, (n_rows,), 50, 400).astype(jnp.float32)
        chunk_ids = jax.random.randint(k1, (nnz,), 0, n_rows, jnp.int32)
        sparse = SparseIndex(
            indptr=jnp.asarray(indptr, jnp.int32), chunk_ids=chunk_ids,
            tf=jax.random.randint(k2, (nnz,), 1, 5, jnp.int32).astype(jnp.float32),
            df=jnp.asarray(counts, jnp.float32), chunk_len=chunk_len,
            avgdl=jnp.mean(chunk_len), dl=chunk_len[chunk_ids],
            vocab_bits=v_bits, max_postings=window)
        idx0 = CorpusIndex(
            emb=emb0, doc_id=doc_id, page=rows % 500 + 1, year=2019 + doc_id,
            company_id=jnp.zeros((n_rows,), jnp.int32),
            kind=jnp.zeros((n_rows,), jnp.int32), page_seg=rows // 4,
            chunk_in_doc=rows - doc_id * (n_rows // n_docs),
            valid=jnp.ones((n_rows,), bool), sparse=sparse, n_chunks=n_rows,
            n_pages=n_rows // 4, n_docs=n_docs, dim=dim)
        pick = jax.random.randint(kq, (n_q,), 0, n_rows)
        q = emb0[pick].astype(jnp.float32) + 0.02 * jax.random.normal(kn, (n_q, dim))
        q = np.asarray(q / jnp.linalg.norm(q, axis=1, keepdims=True))
    per_doc = n_rows // n_docs
    meta = CorpusMeta(
        docs=[DocMeta(f"J{2019 + d}_10m", COMPANY, 2019 + d, per_doc, per_doc // 4)
              for d in range(n_docs)],
        companies=[COMPANY], chunk_texts=[], page_texts={}, page_seg_info=[])
    question = f"{COMPANY}2022年营业收入是多少？"      # routes 2021-2023: 3 docs
    texts = ["营业收入 同比增长", "研发费用 毛利率", "储能系统 订单", "现金流 分红"]
    cfg = SearchConfig(method="basic", top_k=10, top_n=10, use_bm25=True,
                       max_queries=n_q)
    log(f"[multi] corpus {n_rows} × {dim} bf16 ({emb0.nbytes / 1e9:.1f} GB) + "
        f"CSR nnz {nnz} on card 0 in {time.perf_counter() - t0:.1f} s")

    def run(engine, c):
        res = engine.materialize(engine.search(
            q, COMPANY, question, selected_years=[2021, 2022, 2023], cfg=c,
            query_texts=texts), c)
        return res

    base_eng = QueryEngine(idx0, meta)
    base = run(base_eng, cfg)
    mesh = make_mesh({"data": n_dev}, devices=devs)
    sidx = dataclasses.replace(
        idx0,
        emb=jax.device_put(emb0, NamedSharding(mesh, P("data", None))),
        valid=jax.device_put(idx0.valid, NamedSharding(mesh, P("data"))),
        sparse=shard_sparse_index(idx0.sparse, n_dev, mesh=mesh))
    t1 = time.perf_counter()
    got = run(QueryEngine(sidx, meta), cfg)
    d, s = compare_topk([r["rep_row"] for r in got], [r["distance"] for r in got],
                        [r["rep_row"] for r in base], [r["distance"] for r in base],
                        atol=1e-4)
    check([r["method_count"] for r in got] == [r["method_count"] for r in base],
          "sharded hybrid method counts differ")
    log(f"[multi] sharded hybrid (dense + BM25 + fusion) over {n_dev} cards: "
        f"{len(got)} rows equal to card 0 alone, max |Δscore| {d:.3g} "
        f"(tol 1e-4), {s} tie swaps; {time.perf_counter() - t1:.1f} s")

    t1 = time.perf_counter()
    sivf = build_sharded_ivf(emb0, mesh, n_clusters=n_lists, iters=4)
    cfg_ivf = dataclasses.replace(cfg, use_ivf=True, ivf_nprobe=sivf.k_clusters)
    got_ivf = run(QueryEngine(sidx, meta, ivf=sivf), cfg_ivf)
    d, s = compare_topk([r["rep_row"] for r in got_ivf],
                        [r["distance"] for r in got_ivf],
                        [r["rep_row"] for r in base],
                        [r["distance"] for r in base], atol=1e-4)
    log(f"[multi] sharded IVF ({sivf.k_clusters} lists per card, nprobe = K) "
        f"in the hybrid: rows equal to card 0's exact result, max |Δscore| "
        f"{d:.3g} (tol 1e-4), {s} tie swaps; build + search "
        f"{time.perf_counter() - t1:.1f} s")
    del sivf

    t1 = time.perf_counter()
    qd = jnp.asarray(q)
    hier_mesh = make_mesh({"slice": 2, "device": n_dev // 2}, devices=devs)
    hv, hi = map(np.asarray, hierarchical_dense_topk(qd, emb0, 10, hier_mesh))
    fv, fi = map(np.asarray, sharded_dense_topk(qd, emb0, 10, mesh))
    check(np.array_equal(hi, fi) and np.array_equal(hv, fv),
          "two-level merge differs from the flat merge")
    log(f"[multi] two-level merge on a 2 × {n_dev // 2} mesh equals the flat "
        f"{n_dev}-way merge (rows and scores bit-equal); "
        f"{time.perf_counter() - t1:.1f} s")
    del emb0, idx0, sidx, base_eng

    t1 = time.perf_counter()
    enc_cfg = enc_cfg or EncoderConfig()
    tok_rng = np.random.default_rng(8)
    B, L = 32, 128
    qt = tok_rng.integers(0, enc_cfg.vocab_size, size=(2, B, L)).astype(np.int32)
    dt = tok_rng.integers(0, enc_cfg.vocab_size, size=(2, B, L)).astype(np.int32)
    qt[:, :, 96:] = -1
    losses = {}
    for name, m in (("1 card", make_mesh({"data": 1, "model": 1}, devices=devs[:1])),
                    (f"{n_dev} cards", make_mesh({"data": n_dev, "model": 1},
                                                 devices=devs))):
        _, params, opt, step = init_training(enc_cfg, TrainConfig(lr=1e-4), m, seed=0)
        out = []
        for s in range(2):
            params, opt, met = step(params, opt, jnp.asarray(qt[s]), jnp.asarray(dt[s]))
            out.append(float(met["loss"]))
        losses[name] = out
    l1, l4 = np.asarray(losses["1 card"]), np.asarray(losses[f"{n_dev} cards"])
    rel = np.abs(l4 - l1) / np.abs(l1)
    # step 1: same parameters, so the sharded forward + loss must match to
    # 1e-3.  Step 2 runs on parameters after one Adam update, where a
    # gradient reduced in another order can flip near-zero components and
    # move those weights by up to 2·lr: bounded at 1e-2 relative.
    check(rel[0] <= 1e-3, f"data-parallel step loss differs by {rel[0]:.3g}")
    check(rel[1] <= 1e-2, f"loss after the update differs by {rel[1]:.3g}")
    log(f"[multi] data-parallel train step (encoder d{enc_cfg.d_model}, global "
        f"batch {B}×{L}): loss {l1[0]:.6f} on 1 card vs {l4[0]:.6f} on "
        f"{n_dev}, relative Δ {rel[0]:.3g} (tol 1e-3); next step after the "
        f"update {l1[1]:.6f} vs {l4[1]:.6f}, relative Δ {rel[1]:.3g} "
        f"(tol 1e-2); {time.perf_counter() - t1:.1f} s")


# -------------------------------------------------------------------- main

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    if args.multi:
        # card 0 holds the single-card reference copy of the 10M corpus
        # beside its own shard and the IVF build's transients
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

    import jax

    from rag_challenge_2_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    info = phase_device(jax, 4 if args.multi else 1)
    log(f"[phase 0] compile cache: {cache_dir}")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        if args.multi:
            phase_multi(jax)
        else:
            phase_demo(jax, REPO / "data" / "test_set")
            phase_encoder(jax)
            phase_valset(jax)
            phase_million(jax)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s "
        f"on {info['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)

"""Encoder retrieval-quality evaluation (BASELINE.md config 4).

The reference rents embedding quality from the Qwen ``text-embedding-v4``
API (reference src/api_requests.py:55-127); the replacement is the
in-repo encoder (models/encoder.py) trained with ICT (models/pretrain.py)
and, optionally, supervised paraphrase pairs.  This module makes that
replacement *measurable*: it constructs the largest realistic Chinese
financial corpus buildable in-repo (template-generated facts in annual-
report style, plus glossary sentences that state metric synonym pairs the
way real filings do) and scores retrieval hit@10 / MRR of

* a random-init encoder      (the round-1 pipeline default),
* a removal-only ICT encoder (the classic objective — kept because its
  measured collapse on question-style queries motivates the default),
* the default unsupervised encoder (independent-crop + keep-span ICT mix,
  models/pretrain.py),
* an unsupervised + paraphrase-supervised encoder (train facts only), and
* the BM25 sparse path       (the lexical baseline to beat),

on HELD-OUT facts queried through paraphrase templates that avoid the
corpus wording (synonym metric names, different sentence shapes) — the
regime where lexical matching degrades and an embedding model must carry
the quality.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COMPANIES = [
    "金盘科技", "宁德时代", "阳光电源", "隆基绿能", "汇川技术", "国电南瑞",
    "特变电工", "正泰电器", "思源电气", "中国西电", "许继电气", "平高电气",
    "四方股份", "金风科技", "明阳智能", "东方电气", "上海电气", "哈尔滨电气",
    "南都电源", "亿纬锂能", "欣旺达", "国轩高科", "派能科技", "鹏辉能源",
]

YEARS = [2020, 2021, 2022, 2023, 2024, 2025]

# metric → (unit, paraphrase aliases used ONLY by queries)
METRICS: Dict[str, Tuple[str, List[str]]] = {
    "营业收入": ("亿元", ["营收", "销售收入"]),
    "净利润": ("亿元", ["盈利", "净利"]),
    "毛利率": ("%", ["毛利水平", "综合毛利率"]),
    "研发费用": ("亿元", ["研发投入", "研发支出"]),
    "经营活动现金流量净额": ("亿元", ["经营性现金流", "经营现金流净额"]),
    "资产负债率": ("%", ["负债水平", "杠杆率"]),
    "归母净利润": ("亿元", ["归属股东的净利润", "归属于母公司的利润"]),
    "海外收入占比": ("%", ["出口收入比例", "境外营收占比"]),
    "新签订单金额": ("亿元", ["新增订单", "订单签约额"]),
    "存货周转天数": ("天", ["库存周转天数", "存货周转效率"]),
    "应收账款余额": ("亿元", ["应收款项", "应收账款规模"]),
    "每股收益": ("元", ["EPS", "基本每股收益"]),
}

# corpus sentence shapes (annual-report style)
_CHUNK_TEMPLATES = [
    "{c}{y}年年度报告显示，公司{m}为{v}{u}，较上年同期{d}。",
    "报告期内（{y}年），{c}实现{m}{v}{u}，主要受{seg}业务带动。",
    "{y}年度{c}的{m}达到{v}{u}，{seg}板块贡献显著。",
    "根据{c}{y}年财务报表，{m}录得{v}{u}，管理层认为符合预期。",
    "{c}在{y}年的{m}为{v}{u}，同比{d}，详见财务报表附注。",
]

# query shapes — deliberately different wording, metric ALIASES only
_QUERY_TEMPLATES = [
    "{c}{y}年的{a}是多少",
    "请问{y}年{c}{a}达到了什么水平",
    "查询{c}{y}年度{a}数据",
    "{y}年{c}的{a}情况如何",
]

_SEGMENTS = ["干式变压器", "储能系统", "数字化工厂", "海上风电", "充电桩", "光伏逆变器"]
_DIRECTIONS = ["增长12.4%", "增长8.9%", "下降3.2%", "基本持平", "增长21.7%", "下降6.5%"]

# glossary sentences: the only place corpus text links metric ↔ alias —
# real filings routinely define terms this way; gives self-supervised
# training a path to synonym knowledge
_GLOSSARY_TEMPLATE = "注：{m}（亦称{a}）指公司报告期内相关口径下的财务指标。"


@dataclasses.dataclass
class QualityDataset:
    chunk_texts: List[str]       # the corpus (fact chunks + glossary chunks)
    fact_of_chunk: List[int]     # fact id per chunk, -1 for glossary chunks
    train_facts: List[int]
    eval_facts: List[int]
    queries: List[str]           # one per eval fact
    gold_fact: List[int]         # fact id per query
    fact_tuples: List[Tuple[str, int, str]]  # (company, year, metric)

    def gold_rows(self, fact: int) -> List[int]:
        return [i for i, f in enumerate(self.fact_of_chunk) if f == fact]


def build_dataset(
    n_eval: int = 200,
    chunks_per_fact: int = 2,
    seed: int = 0,
) -> QualityDataset:
    """Every (company, year, metric) combination becomes a fact rendered as
    ``chunks_per_fact`` corpus chunks; a held-out slice gets paraphrase
    queries.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    facts = [
        (c, y, m) for c in COMPANIES for y in YEARS for m in METRICS
    ]  # 24 × 6 × 12 = 1728 facts
    chunk_texts: List[str] = []
    fact_of_chunk: List[int] = []
    for fi, (c, y, m) in enumerate(facts):
        unit, _ = METRICS[m]
        v = round(float(rng.uniform(1, 500)), 2)
        for j in range(chunks_per_fact):
            t = _CHUNK_TEMPLATES[int(rng.integers(0, len(_CHUNK_TEMPLATES)))]
            chunk_texts.append(t.format(
                c=c, y=y, m=m, v=v, u=unit,
                seg=_SEGMENTS[int(rng.integers(0, len(_SEGMENTS)))],
                d=_DIRECTIONS[int(rng.integers(0, len(_DIRECTIONS)))],
            ))
            fact_of_chunk.append(fi)
    for m, (unit, aliases) in METRICS.items():
        for a in aliases:
            chunk_texts.append(_GLOSSARY_TEMPLATE.format(m=m, a=a))
            fact_of_chunk.append(-1)

    order = rng.permutation(len(facts))
    eval_facts = sorted(int(f) for f in order[:n_eval])
    train_facts = sorted(int(f) for f in order[n_eval:])
    queries, gold = [], []
    for fi in eval_facts:
        c, y, m = facts[fi]
        aliases = METRICS[m][1]
        a = aliases[int(rng.integers(0, len(aliases)))]
        qt = _QUERY_TEMPLATES[int(rng.integers(0, len(_QUERY_TEMPLATES)))]
        queries.append(qt.format(c=c, y=y, a=a))
        gold.append(fi)
    return QualityDataset(
        chunk_texts=chunk_texts,
        fact_of_chunk=fact_of_chunk,
        train_facts=train_facts,
        eval_facts=eval_facts,
        queries=queries,
        gold_fact=gold,
        fact_tuples=facts,
    )


# --------------------------------------------------------- transfer corpus
#
# A SECOND, independently-shaped synthetic corpus: different industry
# vocabulary, different sentence templates, different query shapes, and a
# different definitional-sentence form.  Purpose: verify the label-free
# alias-distill recipe is not fit to build_dataset's template vocabulary —
# a recipe that only works on corpus #1 is an eval artifact, not a method.

COMPANIES_V2 = [
    "云帆航运", "磐石建材", "瀚海油服", "星桥传媒", "麦田生物", "青石酒业",
    "凌云软件", "北辰物流", "晨曦医疗", "赤金矿业", "白浪渔业", "紫荆教育",
    "远山旅游", "丰年农机", "银杏养老", "红帆化纤", "蓝鲸重工", "绿洲环保",
]

METRICS_V2: Dict[str, Tuple[str, List[str]]] = {
    "总资产": ("亿元", ["资产总额", "资产规模"]),
    "净资产收益率": ("%", ["ROE", "股东回报率"]),
    "员工总数": ("人", ["在册员工数", "职工人数"]),
    "合同负债": ("亿元", ["预收款项规模", "合同预收"]),
    "市场占有率": ("%", ["市占率", "市场份额"]),
    "产能利用率": ("%", ["开工率", "产线负荷率"]),
    "分红总额": ("亿元", ["现金分红规模", "派息总额"]),
    "销售费用率": ("%", ["销售费用占比", "营销开支比例"]),
    "单位能耗": ("吨标煤", ["综合能耗强度", "能耗水平"]),
    "门店数量": ("家", ["网点数量", "营业网点数"]),
}

_CHUNK_TEMPLATES_V2 = [
    "截至{y}年末，{c}的{m}为{v}{u}，与行业平均水平基本相当。",
    "{c}披露的{y}年经营数据显示：{m}{v}{u}，环比保持稳定。",
    "年报附注提到，{c}{y}年{m}录得{v}{u}，审计机构出具标准无保留意见。",
    "在{seg}需求回暖的背景下，{c}{y}年{m}达{v}{u}。",
]

_QUERY_TEMPLATES_V2 = [
    "帮我查一下{c}在{y}年的{a}",
    "{c}{y}年{a}有多少",
    "想知道{y}年{c}的{a}是什么水平",
]

_SEGMENTS_V2 = ["集装箱运输", "基建材料", "海上钻井", "内容电商", "疫苗研发", "高端白酒"]

# a DIFFERENT definitional form (still parenthesized — the shape real
# filings use — but new connective wording and full-width parens only)
_GLOSSARY_TEMPLATE_V2 = "说明：本报告中{m}（或称{a}）按合并报表口径计算。"


def build_dataset_v2(
    n_eval: int = 200, chunks_per_fact: int = 2, seed: int = 7
) -> QualityDataset:
    """The transfer eval: same construction recipe, disjoint vocabulary and
    templates (see the section comment)."""
    rng = np.random.default_rng(seed)
    facts = [
        (c, y, m) for c in COMPANIES_V2 for y in YEARS for m in METRICS_V2
    ]  # 18 × 6 × 10 = 1080 facts
    chunk_texts: List[str] = []
    fact_of_chunk: List[int] = []
    for fi, (c, y, m) in enumerate(facts):
        unit, _ = METRICS_V2[m]
        v = round(float(rng.uniform(1, 900)), 2)
        for _ in range(chunks_per_fact):
            t = _CHUNK_TEMPLATES_V2[int(rng.integers(0, len(_CHUNK_TEMPLATES_V2)))]
            chunk_texts.append(t.format(
                c=c, y=y, m=m, v=v, u=unit,
                seg=_SEGMENTS_V2[int(rng.integers(0, len(_SEGMENTS_V2)))],
            ))
            fact_of_chunk.append(fi)
    for m, (unit, aliases) in METRICS_V2.items():
        for a in aliases:
            chunk_texts.append(_GLOSSARY_TEMPLATE_V2.format(m=m, a=a))
            fact_of_chunk.append(-1)

    order = rng.permutation(len(facts))
    eval_facts = sorted(int(f) for f in order[:n_eval])
    train_facts = sorted(int(f) for f in order[n_eval:])
    queries, gold = [], []
    for fi in eval_facts:
        c, y, m = facts[fi]
        aliases = METRICS_V2[m][1]
        a = aliases[int(rng.integers(0, len(aliases)))]
        qt = _QUERY_TEMPLATES_V2[int(rng.integers(0, len(_QUERY_TEMPLATES_V2)))]
        queries.append(qt.format(c=c, y=y, a=a))
        gold.append(fi)
    return QualityDataset(
        chunk_texts=chunk_texts,
        fact_of_chunk=fact_of_chunk,
        train_facts=train_facts,
        eval_facts=eval_facts,
        queries=queries,
        gold_fact=gold,
        fact_tuples=facts,
    )


def paraphrase_pairs(
    ds: QualityDataset, n: int, rng: np.random.Generator,
    metrics: Optional[Dict] = None,
    templates: Optional[List[str]] = None,
) -> Tuple[List[str], List[str]]:
    """Supervised (paraphrase query, gold chunk) pairs from TRAIN facts only
    — the eval facts stay unseen in both wording and identity.

    ``metrics``/``templates`` default to corpus #1's; pass ``METRICS_V2`` /
    ``_QUERY_TEMPLATES_V2`` to build the corpus-#2 supervised arm."""
    metrics = metrics or METRICS
    templates = templates or _QUERY_TEMPLATES
    by_fact: Dict[int, List[int]] = {}
    for i, f in enumerate(ds.fact_of_chunk):
        if f >= 0:
            by_fact.setdefault(f, []).append(i)
    qs, ps = [], []
    train = ds.train_facts
    for _ in range(n):
        fi = train[int(rng.integers(0, len(train)))]
        c, y, m = ds.fact_tuples[fi]
        aliases = metrics[m][1]
        a = aliases[int(rng.integers(0, len(aliases)))]
        qt = templates[int(rng.integers(0, len(templates)))]
        qs.append(qt.format(c=c, y=y, a=a))
        rows = by_fact[fi]
        ps.append(ds.chunk_texts[rows[int(rng.integers(0, len(rows)))]])
    return qs, ps


def retrieval_metrics(
    scores: np.ndarray, ds: QualityDataset, k: int = 10
) -> Dict[str, float]:
    """hit@k (any gold chunk in the top k) and MRR over the query set.

    ``scores``: [n_queries, n_chunks] — higher is better."""
    hits, rr = 0.0, 0.0
    for qi, fi in enumerate(ds.gold_fact):
        gold = set(ds.gold_rows(fi))
        order = np.argsort(-scores[qi], kind="stable")
        topk = order[:k].tolist()
        if gold & set(topk):
            hits += 1
        for rank, row in enumerate(order.tolist(), start=1):
            if row in gold:
                rr += 1.0 / rank
                break
    n = len(ds.gold_fact)
    return {f"hit@{k}": round(hits / n, 4), "mrr": round(rr / n, 4)}


def eval_dense(embed_fn, ds: QualityDataset, k: int = 10) -> Dict[str, float]:
    """embed_fn: texts → [n, D] unit-norm embeddings (EmbeddingModel.embed)."""
    ce = np.asarray(embed_fn(ds.chunk_texts), np.float32)
    qe = np.asarray(embed_fn(ds.queries), np.float32)
    return retrieval_metrics(qe @ ce.T, ds, k=k)


def eval_bm25(ds: QualityDataset, k: int = 10, vocab_bits: int = 18) -> Dict[str, float]:
    """The sparse-path baseline on identical tokenization."""
    import jax.numpy as jnp

    from ..index.build import _build_sparse
    from ..ops.bm25 import bm25_scores, encode_queries

    n_pad = -(-len(ds.chunk_texts) // 128) * 128
    sp = _build_sparse(ds.chunk_texts, n_pad, vocab_bits=vocab_bits)
    # 64 covers the longest paraphrase query (45 uni+bigram terms) —
    # truncating at 32 cut the discriminative bigrams and handicapped the
    # baseline the dense systems are compared against
    qt = encode_queries(ds.queries, max_terms=64, vocab_bits=vocab_bits)
    scores = np.asarray(bm25_scores(sp, qt, n_pad))[:, : len(ds.chunk_texts)]
    return retrieval_metrics(scores, ds, k=k)


def eval_hybrid(
    embed_fn, ds: QualityDataset, k: int = 10, vocab_bits: int = 18,
    top_n: int = 30, fuse_mode: str = "sum", dense_weight: float = 0.5,
) -> Dict[str, float]:
    """The PRODUCT path: dense + BM25 fused through the real serving graph.

    ``eval_dense`` and ``eval_bm25`` measure each scorer alone on full
    score matrices; what the framework actually serves is their fusion
    (retrieval/engine.search: per-query BM25 max-normalization +
    ``fuse_hits`` method-diversity bonus — reference src/retrieval.py
    :1639-1661).  This builds a one-document CorpusIndex over the quality
    corpus (unrouted, matching the full-matrix evals) and runs every
    held-out paraphrase query through ``QueryEngine.search_many`` with
    ``use_bm25=True``.

    ``fuse_mode``/``dense_weight`` default to the SHIPPED hybrid preset
    (sum-fusion, dense weight 0.5 — the scripts/fusion_sweep.py winner);
    pass ``fuse_mode="max", dense_weight=1.0`` to score the
    reference-parity rule instead.

    MRR is truncated at ``top_n`` (rank > top_n contributes 0) — the
    serving graph only returns the aggregated top-n, so the number is a
    lower bound on the full-ranking MRR the other evals report.
    """
    from ..index.build import build_corpus_index
    from ..retrieval.engine import QueryEngine, SearchConfig

    ce = np.asarray(embed_fn(ds.chunk_texts), np.float32)
    qe = np.asarray(embed_fn(ds.queries), np.float32)
    rep = {
        "metainfo": {"sha1_name": "quality", "company_name": "quality"},
        "content": {
            "pages": [],
            # one page per chunk: parent-page aggregation must not merge
            # distinct facts into one key
            "chunks": [
                {"page": i, "text": t, "id": i, "type": "content"}
                for i, t in enumerate(ds.chunk_texts)
            ],
        },
    }
    index, meta = build_corpus_index([rep], [ce], vocab_bits=vocab_bits)
    eng = QueryEngine(index, meta)
    cfg = SearchConfig(
        method="basic", use_bm25=True, top_n=top_n, top_k=top_n,
        bm25_top_k=top_n, max_queries=1, max_docs=1,
        fuse_mode=fuse_mode, dense_weight=dense_weight,
    )
    cands = eng.search_many(
        [qe[i : i + 1] for i in range(len(ds.queries))],
        company="quality",
        query_texts_list=[[q] for q in ds.queries],
        cfg=cfg,
    )
    hits, rr = 0.0, 0.0
    for qi, c in enumerate(cands):
        gold = set(ds.gold_rows(ds.gold_fact[qi]))
        rows = [int(r) for r in np.asarray(c.key) if r >= 0]
        if gold & set(rows[:k]):
            hits += 1
        for rank, row in enumerate(rows, start=1):
            if row in gold:
                rr += 1.0 / rank
                break
    n = len(ds.queries)
    return {f"hit@{k}": round(hits / n, 4), "mrr": round(rr / n, 4)}


def eval_hybrid_e2e(
    embed_fn, k: int = 10, fuse_mode: str = "sum", dense_weight: float = 0.5,
    use_bm25: bool = True, vocab_bits: int = 16,
) -> Dict[str, float]:
    """The NON-template-shaped quality check: the e2e
    fixture's annual-report prose (eval/e2e.fixture_docs — three invented
    companies, varied section structure, a positioned table page) queried
    with its 17 golden questions through the ROUTED hybrid engine.

    Scores retrieval only (no answering): hit@k = a top-k fused chunk from
    the right company's gold page (year-matched when the question names
    one), MRR truncated at the serving top_n.  Unlike
    :func:`eval_hybrid`'s one-pot corpus, this runs the REAL route
    (company + ±1-year window) — the deployment shape."""
    import re as _re

    from ..index.build import build_corpus_index
    from ..retrieval.engine import QueryEngine, SearchConfig
    from .e2e import GOLDEN_QA, fixture_docs

    reports, chunk_lists = [], []
    for doc in fixture_docs():
        chunks, pages = [], []
        cid = 0
        for pno, page in enumerate(doc["pages"], start=1):
            text = page if isinstance(page, str) else (
                page["text"] + "\n"
                + "\n".join(" ".join(row) for row in page.get("table", []))
            )
            pages.append({"page": pno, "text": text})
            for para in text.split("\n"):
                if para.strip():
                    chunks.append({"page": pno, "text": para.strip(),
                                   "id": cid, "type": "content"})
                    cid += 1
        reports.append({
            "metainfo": {"sha1_name": doc["sha1"],
                         "company_name": doc["company"],
                         "year": doc["year"]},
            "content": {"pages": pages, "chunks": chunks},
        })
        chunk_lists.append([c["text"] for c in chunks])

    embs = [np.asarray(embed_fn(texts), np.float32) for texts in chunk_lists]
    sha_info = {d["sha1"]: (d["company"], d["year"]) for d in fixture_docs()}
    idx, meta = build_corpus_index(reports, embs, vocab_bits=vocab_bits)
    eng = QueryEngine(idx, meta)
    top_n = 30
    cfg = SearchConfig(method="basic", use_bm25=use_bm25, top_n=top_n,
                       top_k=top_n, bm25_top_k=top_n, max_queries=1,
                       fuse_mode=fuse_mode, dense_weight=dense_weight)
    hits, rr = 0.0, 0.0
    for g in GOLDEN_QA:
        q = g["question"]
        ym = _re.search(r"(20\d{2})年", q)
        want_year = int(ym.group(1)) if ym else None
        qe = np.asarray(embed_fn([q]), np.float32)
        res = eng.materialize(
            eng.search(qe, g["company"], question=q, cfg=cfg,
                       query_texts=[q]), cfg)

        def gold(r) -> bool:
            info = sha_info.get(r.get("source_sha1"))
            return (info is not None and info[0] == g["company"]
                    and (want_year is None or info[1] == want_year)
                    and int(r["page"]) == g["gold_page"])

        if any(gold(r) for r in res[:k]):
            hits += 1
        for rank, r in enumerate(res, start=1):
            if gold(r):
                rr += 1.0 / rank
                break
    n = len(GOLDEN_QA)
    return {f"hit@{k}": round(hits / n, 4), "mrr": round(rr / n, 4)}


def run_quality_eval(
    ict_steps: int = 5000,
    supervised_steps: int = 2000,
    batch_size: int = 64,
    seed: int = 0,
    enc_cfg=None,
    log=print,
) -> Dict[str, Dict[str, float]]:
    """The full config-4 experiment.  Returns metrics per system."""
    import jax.numpy as jnp

    from ..models.encoder import EmbeddingModel, EncoderConfig, tokenize_batch
    from ..models.pretrain import PretrainConfig, pretrain_encoder

    ds = build_dataset(seed=seed)
    log(f"corpus: {len(ds.chunk_texts)} chunks, {len(ds.queries)} held-out "
        f"paraphrase queries over {len(ds.eval_facts)} eval facts")
    results: Dict[str, Dict[str, float]] = {}

    results["bm25"] = eval_bm25(ds)
    log(f"bm25 (lexical baseline): {results['bm25']}")

    # production architecture at the corpus's real sequence length (chunks
    # here are single sentences — padding to the serving max_len just
    # multiplies compute without touching the comparison)
    cfg = enc_cfg or EncoderConfig(max_len=96)
    random_model = EmbeddingModel(cfg, seed=seed)
    results["encoder_random_init"] = eval_dense(random_model.embed, ds)
    log(f"random-init encoder: {results['encoder_random_init']}")

    # the served fusion with a useless dense arm: does BM25's quality
    # survive the method-diversity bonus handing noise hits a boost?
    results["hybrid_random_init"] = eval_hybrid(random_model.embed, ds)
    log(f"hybrid (random encoder + bm25, real serving graph): "
        f"{results['hybrid_random_init']}")

    ict_only, info = pretrain_encoder(
        ds.chunk_texts,
        enc_cfg=cfg,
        pre_cfg=PretrainConfig(
            steps=ict_steps, batch_size=batch_size, seed=seed,
            crop_prob=0.0, keep_span_prob=0.0,   # removal-only ICT
            bm25_neighbor_prob=0.0, hard_batch_prob=0.0, alias_swap_prob=0.0,
        ),
    )
    results["encoder_ict"] = eval_dense(ict_only.embed, ds)
    log(f"removal-only ICT {ict_steps} steps (final {info['final']}): "
        f"{results['encoder_ict']}")

    model, info = pretrain_encoder(
        ds.chunk_texts,
        enc_cfg=cfg,
        pre_cfg=PretrainConfig(
            steps=ict_steps, batch_size=batch_size, seed=seed,
            bm25_neighbor_prob=0.0, hard_batch_prob=0.0,  # mining OFF
            alias_swap_prob=0.0,
        ),
    )
    results["encoder_unsupervised"] = eval_dense(model.embed, ds)
    log(f"unsupervised crop+ICT {ict_steps} steps (final {info['final']}): "
        f"{results['encoder_unsupervised']}")

    # BM25 distillation (still label-free): positives mined from the
    # in-repo sparse path + hard in-batch negatives from BM25
    # neighborhoods.  The dense model inherits BM25's lexical graph and —
    # through embedding transitivity across glossary chunks — the
    # alias↔metric links BM25 itself cannot score.  Measured alone here
    # (alias swap off): 0.47 hit@10 vs 0.385 for the earlier 0.5/0.5 mix.
    distill, info = pretrain_encoder(
        ds.chunk_texts,
        enc_cfg=cfg,
        pre_cfg=PretrainConfig(
            steps=ict_steps, batch_size=batch_size, seed=seed,
            alias_swap_prob=0.0,
        ),
    )
    results["encoder_bm25_distill"] = eval_dense(distill.embed, ds)
    log(f"unsupervised + bm25-distill {ict_steps} steps "
        f"(final {info['final']}): {results['encoder_bm25_distill']}")

    # The full PretrainConfig-default recipe: distillation + corpus-mined
    # synonym substitution on the query view (alias_swap_prob 0.8 —
    # mine_alias_pairs over the corpus's own definitional sentences, no
    # labels).  The measured-best label-free system: 0.73 hit@10, 2.4x
    # random init (encoder-quality run encoder_alias_distill).
    alias_distill, info = pretrain_encoder(
        ds.chunk_texts,
        enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=ict_steps, batch_size=batch_size, seed=seed),
    )
    results["encoder_alias_distill"] = eval_dense(alias_distill.embed, ds)
    log(f"unsupervised + bm25-distill + alias swap (the default) "
        f"{ict_steps} steps (final {info['final']}): "
        f"{results['encoder_alias_distill']}")

    # what config 2/4 actually ship: the default label-free encoder fused
    # with BM25 in the one-graph serving path
    results["hybrid_alias_distill"] = eval_hybrid(alias_distill.embed, ds)
    log(f"hybrid (default label-free encoder + bm25, real serving graph): "
        f"{results['hybrid_alias_distill']}")

    # LISTWISE BM25 distillation (models/pretrain.py soft_target_weight):
    # instead of swapping the single positive for BM25's argmax, every
    # step's [B, B] InfoNCE targets carry the teacher's full score
    # distribution over the batch — with hard (lexical-neighborhood)
    # batches, the dense model learns BM25's *ranking* among close
    # candidates, which is exactly what hit@10 measures.
    listwise, info = pretrain_encoder(
        ds.chunk_texts,
        enc_cfg=cfg,
        pre_cfg=PretrainConfig(
            steps=ict_steps, batch_size=batch_size, seed=seed,
            bm25_neighbor_prob=0.0, hard_batch_prob=0.5,
            soft_target_weight=0.8, alias_swap_prob=0.0,
        ),
    )
    results["encoder_bm25_listwise"] = eval_dense(listwise.embed, ds)
    log(f"unsupervised + bm25-listwise {ict_steps} steps "
        f"(final {info['final']}): {results['encoder_bm25_listwise']}")

    unsup = {
        "encoder_unsupervised": model,
        "encoder_bm25_distill": distill,
        "encoder_alias_distill": alias_distill,
        "encoder_bm25_listwise": listwise,
    }
    best = max(unsup, key=lambda k: results[k]["hit@10"])
    model = unsup[best]

    if supervised_steps:
        from ..models.train import TrainConfig, init_training
        from ..parallel.mesh import make_mesh
        import jax

        mesh = make_mesh({"data": len(jax.devices()), "model": 1})
        module, _p0, opt_state, step = init_training(
            cfg, TrainConfig(lr=1e-4), mesh, seed=seed
        )
        params = model.params  # continue from the ICT checkpoint (adamw
        #                        state is zeros_like(params) — reusable)
        rng = np.random.default_rng(seed + 1)
        sup_len = min(64, cfg.max_len)
        for i in range(supervised_steps):
            qs, ps = paraphrase_pairs(ds, batch_size, rng)
            q = jnp.asarray(tokenize_batch(qs, sup_len, cfg.vocab_bits))
            p = jnp.asarray(tokenize_batch(ps, sup_len, cfg.vocab_bits))
            params, opt_state, metrics = step(params, opt_state, q, p)
        tuned = EmbeddingModel(cfg, params=params)
        results["encoder_ict_supervised"] = eval_dense(tuned.embed, ds)
        log(f"+ supervised {supervised_steps} steps "
            f"(loss {float(metrics['loss']):.3f}): {results['encoder_ict_supervised']}")
    return results

"""Label-free encoder recipe ablation (the experiment log behind
the PretrainConfig defaults).

Recorded hit@10 on eval/encoder_quality.build_dataset (200
held-out paraphrase queries; steps=5000 batch=64 seed=0 unless noted):

  base5k          0.385   distill 0.5/0.5
  strong5k        0.47    distill 0.8/1.0
  alias5k_p8      0.73    + alias swap 0.8  <- the winner, now the default
  alias15k_p8     0.765   the winner x3 steps: still improving with steps
  alias5k_p8_s1   0.67    (seed 1: the win is seed-robust)
  alias5k_p10     0.66    alias swap 1.0: loses the literal-word anchor
  alias5k_p8_qw5  0.70    + question wrapping 0.5: no gain
  long15k         -       (0.5/0.5 x3 steps; superseded by strong15k)
  strong15k       0.455   0.8/1.0 x3 steps + warmup-cosine: no gain
  idf5k           0.43    + idf-weighted chunk sampling: dilutes facts
  idf5k_p2        -       (not run; power 1 already regressed)
  selftrain*      0.325   stage-2 dense-teacher re-mining: REGRESSES

Round-4 arms (same eval unless noted):

  alias5k_pswap8  0.685   + passage-side alias swap 0.8: REGRESSES —
                          rewriting the passage breaks the literal-
                          wording anchor the distill teacher scores
  alias5k_pswap5  0.71    passage-side 0.5: still below 0.73
  v2_recipe5k     0.755   TRANSFER: the unchanged default recipe on
                          corpus #2 (build_dataset_v2) — 2.4x random
                          init (0.315) and BEATS BM25-alone (0.67);
                          the recipe is not fit to corpus #1's templates

Arms:

  v2_supervised   1.0     supervised ceiling on the TRANSFER corpus:
                          recipe-5k base + 2k supervised steps → 1.0/1.0
                          (the ceiling is not corpus-#1-specific); the
                          same arm served through sum-fusion: 0.915 — a
                          measured instance of the sum-fusion failure
                          mode (perfect dense partially buried by BM25)
  e2e_fixture     1.0     recipe 5k on the e2e fixture's PROSE corpus,
                          served through the routed graph: hit@10 1.0
                          under both fusion modes; dense-only 0.941
                          with the best MRR (0.40)

Arms run one per process and save params to runs/enc_<arm>.npz;
selftrain_from warm-starts from ENC_BASE (default runs/enc_idf5k.npz),
ENC_STRONG=1 for the 0.8/1.0 mix.

Usage: PYTHONPATH=. python scripts/encoder_ablation.py [arm ...]
Writes incremental results to runs/enc_ablate.json.
"""
import json
import os
import sys

import numpy as np

from rag_challenge_2_tpu.eval.encoder_quality import build_dataset, eval_dense
from rag_challenge_2_tpu.models.encoder import EncoderConfig
from rag_challenge_2_tpu.models.pretrain import PretrainConfig, pretrain_encoder
from rag_challenge_2_tpu.models.train import TrainConfig

ds = build_dataset(seed=0)
cfg = EncoderConfig(max_len=96)
OUT = "runs/enc_ablate.json"
os.makedirs("runs", exist_ok=True)
try:        # arms run one per process — merge results across processes
    results = json.load(open(OUT))
except (OSError, ValueError):
    results = {}

which = set(sys.argv[1:]) or {"strong5k", "long15k", "selftrain"}


def record(name, model, info):
    from rag_challenge_2_tpu.models.pretrain import save_params
    r = eval_dense(model.embed, ds)
    results[name] = {**r, "final": info["final"]}
    print(name, results[name], flush=True)
    json.dump(results, open(OUT, "w"), indent=1)
    save_params(model, f"runs/enc_{name}.npz")   # staged arms warm-start
    return r


base_model = None
if "selftrain" in which or "base5k" in which:
    base_model, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.5, hard_batch_prob=0.5,
                               alias_swap_prob=0.0))
    record("base5k", base_model, info)

if "strong5k" in which:
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.0))
    record("strong5k", m, info)

for arm, p in (("alias5k_p3", 0.3), ("alias5k_p5", 0.5), ("alias5k_p8", 0.8),
               ("alias5k_p10", 1.0)):
    if arm in which:
        # strong distill + corpus-mined synonym substitution on the query
        # view (mine_alias_pairs over the training corpus — label-free)
        m, info = pretrain_encoder(
            ds.chunk_texts, enc_cfg=cfg,
            pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                                   bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                                   alias_swap_prob=p))
        record(arm, m, info)

if "alias5k_p8_s1" in which:
    # seed-robustness check on the p8 winner (0.73 at seed 0)
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=1,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.8))
    record("alias5k_p8_s1", m, info)

if "alias15k_p8" in which:
    # 3x steps on the alias recipe: the earlier "15k = no gain" finding
    # predates alias swap, which adds per-step view diversity
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=15000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.8),
        train_cfg=TrainConfig(lr=3e-4, total_steps=15000))
    record("alias15k_p8", m, info)

if "alias15k_p8_cont" in which:
    # 30k-equivalent budget at 1/2 the cost: continue the saved 15k-arm
    # params (runs/enc_alias15k_p8.npz) for 15k more alias-recipe steps
    # at a lower lr — answers "does the curve keep paying past 15k?"
    import os
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel
    from rag_challenge_2_tpu.models.pretrain import load_params

    base_path = os.environ.get("ENC_BASE", "runs/enc_alias15k_p8.npz")
    base_model = load_params(EmbeddingModel(cfg), base_path)
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=15000, batch_size=64, seed=2,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.8),
        train_cfg=TrainConfig(lr=1e-4, total_steps=15000),
        init_params=base_model.params,
    )
    record("alias15k_p8_cont", m, info)

if "alias30k_p8" in which:
    # 6x steps: 15k measured +0.035 over 5k (0.765) — does the curve
    # keep paying at double the budget, or has it flattened?
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=30000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.8),
        train_cfg=TrainConfig(lr=3e-4, total_steps=30000))
    record("alias30k_p8", m, info)

for arm, qp, ap in (("qw5k_p5", 0.5, 0.0), ("alias5k_p5_qw5", 0.5, 0.5),
                    ("alias5k_p8_qw5", 0.5, 0.8)):
    if arm in which:
        # + doc2query-style question wrapping of the query view (generic
        # interrogative frames, label-free) — alone and on top of the
        # alias-swap winner
        m, info = pretrain_encoder(
            ds.chunk_texts, enc_cfg=cfg,
            pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                                   bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                                   alias_swap_prob=ap, question_wrap_prob=qp))
        record(arm, m, info)

if "long15k" in which:
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=15000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.5, hard_batch_prob=0.5,
                               alias_swap_prob=0.0),
        train_cfg=TrainConfig(lr=3e-4, total_steps=15000))
    record("long15k", m, info)

if "selftrain" in which:
    # teacher scores must align with PairSampler's filtered text list
    min_span = 4
    s_texts = [t for t in ds.chunk_texts if len(t) >= 2 * min_span]
    assert len(s_texts) == len(ds.chunk_texts), "filter dropped chunks"
    corpus_emb = np.asarray(base_model.embed(s_texts), np.float32)

    def teacher(texts):
        qe = np.asarray(base_model.embed(texts), np.float32)
        return qe @ corpus_emb.T

    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=1,
                               bm25_neighbor_prob=0.5, hard_batch_prob=0.5,
                               alias_swap_prob=0.0),
        teacher_score_fn=teacher,
        init_params=base_model.params,
    )
    record("selftrain", m, info)
if "strong15k" in which:
    # strong5k measured 0.47 vs base5k 0.385: heavy mining wins.  3x steps
    # + warmup-cosine on the winning mix.
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=15000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.0),
        train_cfg=TrainConfig(lr=3e-4, total_steps=15000))
    record("strong15k", m, info)
    base_model = m          # selftrain_strong stages on top of this

if "selftrain_strong" in which:
    min_span = 4
    s_texts = [t for t in ds.chunk_texts if len(t) >= 2 * min_span]
    assert len(s_texts) == len(ds.chunk_texts), "filter dropped chunks"
    corpus_emb = np.asarray(base_model.embed(s_texts), np.float32)

    def teacher(texts):
        qe = np.asarray(base_model.embed(texts), np.float32)
        return qe @ corpus_emb.T

    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=1,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.0),
        train_cfg=TrainConfig(lr=1e-4, total_steps=5000),
        teacher_score_fn=teacher,
        init_params=base_model.params,
    )
    record("selftrain_strong", m, info)

if "idf5k" in which:
    # strong5k mix + idf-weighted chunk sampling power 1
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.0, idf_sampling=1.0))
    record("idf5k", m, info)

if "idf5k_p2" in which:
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.0, idf_sampling=2.0))
    record("idf5k_p2", m, info)

if "selftrain_from" in which:
    # stage-2 self-training in a fresh process: warm-start +
    # dense-teacher mining from the params saved by a previous arm
    # (env ENC_BASE=runs/enc_<arm>.npz, ENC_STRONG=1 for the 0.8/1.0 mix).
    import os
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel
    from rag_challenge_2_tpu.models.pretrain import load_params

    base_path = os.environ.get("ENC_BASE", "runs/enc_idf5k.npz")
    strong = os.environ.get("ENC_STRONG", "1") == "1"
    base_model = load_params(EmbeddingModel(cfg), base_path)
    min_span = 4
    s_texts = [t for t in ds.chunk_texts if len(t) >= 2 * min_span]
    assert len(s_texts) == len(ds.chunk_texts)
    corpus_emb = np.asarray(base_model.embed(s_texts), np.float32)

    def teacher(texts):
        qe = np.asarray(base_model.embed(texts), np.float32)
        return qe @ corpus_emb.T

    nbr, hard = (0.8, 1.0) if strong else (0.5, 0.5)
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=1,
                               bm25_neighbor_prob=nbr, hard_batch_prob=hard,
                               alias_swap_prob=0.0),
        train_cfg=TrainConfig(lr=1e-4, total_steps=5000),
        teacher_score_fn=teacher,
        init_params=base_model.params,
    )
    record("selftrain_from", m, info)


# ---------------------------------------------------------- round-4 arms

if "alias5k_pswap5" in which or "alias5k_pswap8" in which:
    # BOTH-sides alias alignment (PretrainConfig.alias_swap_passage_prob):
    # the positive pair spans term/alias wording in both directions —
    # the multi-positive-view form of the query-side winner
    for arm, pp in (("alias5k_pswap5", 0.5), ("alias5k_pswap8", 0.8)):
        if arm in which:
            m, info = pretrain_encoder(
                ds.chunk_texts, enc_cfg=cfg,
                pre_cfg=PretrainConfig(
                    steps=5000, batch_size=64, seed=0,
                    bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                    alias_swap_prob=0.8, alias_swap_passage_prob=pp))
            record(arm, m, info)

if "ensemble5k" in which:
    # stage-2 with the BM25+dense ENSEMBLE teacher (pretrain.py
    # ensemble_teacher): dense-only self-training regressed (0.47->0.325);
    # the ensemble keeps BM25 as the anchor so the dense co-teacher can
    # only promote candidates lexical mining already surfaces.
    # Warm-starts from ENC_BASE (default: the saved alias5k_p8 winner).
    import os
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel
    from rag_challenge_2_tpu.models.pretrain import (
        ensemble_teacher, load_params)

    base_path = os.environ.get("ENC_BASE", "runs/enc_alias5k_p8.npz")
    alpha = float(os.environ.get("ENC_ALPHA", "0.5"))
    base_model = load_params(EmbeddingModel(cfg), base_path)
    teacher = ensemble_teacher(ds.chunk_texts, base_model, alpha=alpha)
    m, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=1,
                               bm25_neighbor_prob=0.8, hard_batch_prob=1.0,
                               alias_swap_prob=0.8),
        train_cfg=TrainConfig(lr=1e-4, total_steps=5000),
        teacher_score_fn=teacher,
        init_params=base_model.params,
    )
    record(f"ensemble5k_a{alpha}", m, info)

if "v2_recipe5k" in which:
    # TRANSFER eval: the default recipe trained and scored on the
    # independently-shaped corpus #2 (eval/encoder_quality.build_dataset_v2
    # — new vocabulary, templates, query shapes, definitional form).  If
    # the alias-distill recipe only worked on corpus #1's templates, this
    # arm exposes it.  Baselines recorded alongside for the ratio.
    from rag_challenge_2_tpu.eval.encoder_quality import (
        build_dataset_v2, eval_bm25)
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel

    ds2 = build_dataset_v2(seed=7)
    results["v2_bm25"] = eval_bm25(ds2)
    print("v2_bm25", results["v2_bm25"], flush=True)
    rand = EmbeddingModel(cfg, seed=0)
    results["v2_random_init"] = eval_dense(rand.embed, ds2)
    print("v2_random_init", results["v2_random_init"], flush=True)
    json.dump(results, open(OUT, "w"), indent=1)
    m, info = pretrain_encoder(
        ds2.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0))
    r = eval_dense(m.embed, ds2)
    results["v2_recipe5k"] = {**r, "final": info["final"]}
    print("v2_recipe5k", results["v2_recipe5k"], flush=True)
    json.dump(results, open(OUT, "w"), indent=1)
    from rag_challenge_2_tpu.models.pretrain import save_params
    save_params(m, "runs/enc_v2_recipe5k.npz")

# ---------------------------------------------------------- round-5 arms

if "v2_supervised" in which:
    # the supervised ceiling arm on TRANSFER corpus #2 —
    # corpus #1's encoder_ict_supervised hit 1.0; if the architecture's
    # supervised ceiling is corpus-#1-specific, this exposes it.  Recipe
    # 5k label-free on ds2, then +2k supervised paraphrase steps from ds2
    # TRAIN facts (v2 metrics/templates; eval facts unseen).
    import jax.numpy as jnp

    from rag_challenge_2_tpu.eval.encoder_quality import (
        METRICS_V2, _QUERY_TEMPLATES_V2, build_dataset_v2, eval_dense,
        eval_hybrid, paraphrase_pairs)
    from rag_challenge_2_tpu.models.encoder import (
        EmbeddingModel, tokenize_batch)
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu.parallel.mesh import make_mesh

    ds2 = build_dataset_v2(seed=7)
    base_path = "runs/enc_v2_recipe5k.npz"
    if os.path.exists(base_path):
        from rag_challenge_2_tpu.models.pretrain import load_params
        base = load_params(EmbeddingModel(cfg), base_path)
    else:
        base, _ = pretrain_encoder(
            ds2.chunk_texts, enc_cfg=cfg,
            pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0))
    import jax as _jax

    mesh = make_mesh({"data": len(_jax.devices()), "model": 1})
    _, _p0, opt_state, step = init_training(cfg, TrainConfig(lr=1e-4), mesh,
                                            seed=0)
    params = base.params
    rng_sup = np.random.default_rng(1)
    # scan-chunked dispatches (models/train.make_chunked_train_step): one
    # dispatch per K steps
    K = 250
    for c in range(2000 // K):
        qts, pts = [], []
        for _ in range(K):
            qs, ps = paraphrase_pairs(ds2, 64, rng_sup, metrics=METRICS_V2,
                                      templates=_QUERY_TEMPLATES_V2)
            qts.append(tokenize_batch(qs, 64, cfg.vocab_bits))
            pts.append(tokenize_batch(ps, 64, cfg.vocab_bits))
        params, opt_state, _m = step.chunked(
            params, opt_state, jnp.asarray(np.stack(qts)),
            jnp.asarray(np.stack(pts)))
    tuned = EmbeddingModel(cfg, params=params)
    results["v2_supervised"] = eval_dense(tuned.embed, ds2)
    print("v2_supervised", results["v2_supervised"], flush=True)
    results["v2_supervised_hybrid"] = eval_hybrid(tuned.embed, ds2)
    print("v2_supervised_hybrid", results["v2_supervised_hybrid"], flush=True)
    json.dump(results, open(OUT, "w"), indent=1)

if "e2e_fixture" in which:
    # the label-free recipe trained on the e2e
    # fixture's PROSE corpus (not a template generator), served through
    # the routed hybrid graph — arms: sum-fusion preset / parity max /
    # dense-only / bm25-weighted-out
    from rag_challenge_2_tpu.eval.e2e import fixture_docs
    from rag_challenge_2_tpu.eval.encoder_quality import eval_hybrid_e2e

    chunks = []
    for doc in fixture_docs():
        for page in doc["pages"]:
            text = page if isinstance(page, str) else (
                page["text"] + "\n"
                + "\n".join(" ".join(r) for r in page.get("table", [])))
            chunks.extend(p.strip() for p in text.split("\n") if p.strip())
    m_fx, info = pretrain_encoder(
        chunks, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=5000, batch_size=64, seed=0))
    results["e2e_fixture_hybrid_sum"] = eval_hybrid_e2e(m_fx.embed)
    results["e2e_fixture_hybrid_max"] = eval_hybrid_e2e(
        m_fx.embed, fuse_mode="max", dense_weight=1.0)
    results["e2e_fixture_dense_only"] = eval_hybrid_e2e(
        m_fx.embed, use_bm25=False)
    for k in ("e2e_fixture_hybrid_sum", "e2e_fixture_hybrid_max",
              "e2e_fixture_dense_only"):
        print(k, results[k], flush=True)
    json.dump(results, open(OUT, "w"), indent=1)

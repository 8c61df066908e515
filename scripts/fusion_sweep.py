"""Offline fusion-variant sweep for the served dense+BM25 graph.

eval_hybrid (the product path) ties BM25-alone at 0.905 hit@10 and beats
it on MRR@30.  This script asks whether any *measured* fusion variant
beats BM25-alone on hit@10 too, WITHOUT touching the serving graph: it
emulates the exact fuse_hits math (per-arm top-30 truncation, per-query
BM25 max-normalization, base = max over arms, x(1 + METHOD_BONUS) when
both arms hit the key - ops/aggregate.py:134-137) on full numpy score
matrices, sanity-checks the emulation against the recorded product
number, then sweeps:

  - dense weight  w_d       (base = max(w_d * dense, bm25))
  - method bonus  mb        (x(1 + mb) for two-arm keys)
  - sum fusion              (base = bm25 + w_d * dense)
  - reciprocal-rank fusion  (score = sum 1/(60 + rank_arm))

Reference semantics being probed: src/retrieval.py:1639-1661 (the
score-union + bonus fusion).  Usage:

  python scripts/fusion_sweep.py [steps]   (default 5000; reuses
      runs/enc_hybrid_arm.npz from scripts/hybrid_quality.py if present)

Writes runs/fusion_sweep.json.
"""
import json
import os
import sys

import numpy as np

from rag_challenge_2_tpu.eval.encoder_quality import build_dataset, eval_hybrid
from rag_challenge_2_tpu.models.encoder import EmbeddingModel, EncoderConfig

os.makedirs("runs", exist_ok=True)  # outputs stay in the checkout

METHOD_BONUS = 0.1  # ops/aggregate.py parity
TOP_ARM = 30        # serving top_k / bm25_top_k
TOP_N = 30          # serving top_n


def arm_matrices(model, ds):
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.build import _build_sparse
    from rag_challenge_2_tpu.ops.bm25 import bm25_scores, encode_queries

    ce = np.asarray(model.embed(ds.chunk_texts), np.float32)
    qe = np.asarray(model.embed(ds.queries), np.float32)
    dense = qe @ ce.T
    n_pad = -(-len(ds.chunk_texts) // 128) * 128
    sp = _build_sparse(ds.chunk_texts, n_pad, vocab_bits=18)
    qt = encode_queries(ds.queries, max_terms=64, vocab_bits=18)
    bm = np.asarray(bm25_scores(sp, qt, n_pad))[:, : len(ds.chunk_texts)]
    return dense, bm


def truncated(scores, k=TOP_ARM):
    """Per-query (rows, sims) of the arm's top-k - the serving truncation."""
    idx = np.argsort(-scores, axis=1)[:, :k]
    return idx, np.take_along_axis(scores, idx, axis=1)


def metrics(ranked_rows, ds, k=10):
    hits, rr = 0.0, 0.0
    for qi, rows in enumerate(ranked_rows):
        gold = set(ds.gold_rows(ds.gold_fact[qi]))
        if gold & set(rows[:k]):
            hits += 1
        for rank, row in enumerate(rows, start=1):
            if row in gold:
                rr += 1.0 / rank
                break
    n = len(ranked_rows)
    return {"hit@10": round(hits / n, 4), "mrr_at_30": round(rr / n, 4)}


def fuse(d_rows, d_sims, b_rows, b_sims, *, w_d=1.0, mb=METHOD_BONUS,
         mode="max"):
    """Emulate fuse_hits per query on the truncated arm lists."""
    ranked = []
    for qi in range(len(d_rows)):
        b_norm = b_sims[qi] / max(float(b_sims[qi].max()), 1e-9)
        cand = {}
        for r, s in zip(d_rows[qi], d_sims[qi]):
            cand[int(r)] = {"d": float(s)}
        for r, s in zip(b_rows[qi], b_norm):
            cand.setdefault(int(r), {})["b"] = float(s)
        scored = []
        for r, arms in cand.items():
            d = arms.get("d")
            b = arms.get("b")
            if mode == "max":
                base = max(w_d * d if d is not None else -1e9,
                           b if b is not None else -1e9)
            elif mode == "sum":
                # clamp each arm to >= 0, matching the shipped fuse_hits
                # sum branch (ops/aggregate.py): negative dense sims from
                # weak/random encoders must not subtract from BM25 mass
                base = max(0.0, b or 0.0) + max(0.0, w_d * (d or 0.0))
            else:
                raise ValueError(mode)
            nm = (d is not None) + (b is not None)
            scored.append((base * (1.0 + mb * (nm - 1)), r))
        scored.sort(key=lambda t: (-t[0], -t[1]))
        ranked.append([r for _, r in scored[:TOP_N]])
    return ranked


def rrf(d_rows, b_rows, k0=60.0):
    ranked = []
    for qi in range(len(d_rows)):
        sc = {}
        for rank, r in enumerate(d_rows[qi], start=1):
            sc[int(r)] = sc.get(int(r), 0.0) + 1.0 / (k0 + rank)
        for rank, r in enumerate(b_rows[qi], start=1):
            sc[int(r)] = sc.get(int(r), 0.0) + 1.0 / (k0 + rank)
        order = sorted(sc.items(), key=lambda t: (-t[1], -t[0]))
        ranked.append([r for r, _ in order[:TOP_N]])
    return ranked


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    ds = build_dataset(seed=0)
    cfg = EncoderConfig(max_len=96)
    cache = f"runs/enc_hybrid_arm_{steps}.npz"
    if os.path.exists(cache):
        from rag_challenge_2_tpu.models.pretrain import load_params

        model = load_params(EmbeddingModel(cfg, seed=0), cache)
        print(f"loaded {cache}", flush=True)
    elif steps == 0:
        model = EmbeddingModel(cfg, seed=0)
    else:
        from rag_challenge_2_tpu.models.pretrain import (
            PretrainConfig, pretrain_encoder, save_params)

        model, _ = pretrain_encoder(
            ds.chunk_texts, enc_cfg=cfg,
            pre_cfg=PretrainConfig(steps=steps, batch_size=64, seed=0),
        )
        save_params(model, cache)

    dense, bm = arm_matrices(model, ds)
    d_rows, d_sims = truncated(dense)
    b_rows, b_sims = truncated(bm)

    out = {}
    out["bm25_alone_top30"] = metrics(list(b_rows), ds)
    out["dense_alone_top30"] = metrics(list(d_rows), ds)
    # sanity: the emulation at parity settings must match the product path
    out["emulated_parity"] = metrics(
        fuse(d_rows, d_sims, b_rows, b_sims), ds)
    out["product_eval_hybrid"] = eval_hybrid(model.embed, ds)
    print("parity check: emulated", out["emulated_parity"],
          "vs product", out["product_eval_hybrid"], flush=True)

    # symmetric per-query max-normalization of the DENSE arm (bm25 already
    # gets one in the engine): calibrates the two score scales regardless
    # of encoder quality / anisotropy
    d_norm = d_sims / np.maximum(d_sims.max(axis=1, keepdims=True), 1e-9)
    for w_d in (0.6, 0.8, 1.0):
        out[f"dnorm_max_wd{w_d}"] = metrics(
            fuse(d_rows, d_norm, b_rows, b_sims, w_d=w_d), ds)
        out[f"dnorm_sum_wd{w_d}"] = metrics(
            fuse(d_rows, d_norm, b_rows, b_sims, w_d=w_d, mode="sum"), ds)

    for w_d in (0.6, 0.8, 0.9, 1.1, 1.25):
        out[f"max_wd{w_d}"] = metrics(
            fuse(d_rows, d_sims, b_rows, b_sims, w_d=w_d), ds)
    for mb in (0.2, 0.3, 0.5):
        out[f"max_mb{mb}"] = metrics(
            fuse(d_rows, d_sims, b_rows, b_sims, mb=mb), ds)
    for w_d in (0.25, 0.5, 0.75, 1.0):
        out[f"sum_wd{w_d}"] = metrics(
            fuse(d_rows, d_sims, b_rows, b_sims, w_d=w_d, mode="sum"), ds)
    for k0 in (20.0, 60.0):
        out[f"rrf_k{int(k0)}"] = metrics(rrf(d_rows, b_rows, k0=k0), ds)

    for name, m in out.items():
        print(f"{name:24s} {m}", flush=True)
    json.dump(out, open(f"runs/fusion_sweep_{steps}.json", "w"), indent=1)


if __name__ == "__main__":
    main()

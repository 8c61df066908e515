"""Measure the SERVED fusion quality (eval/encoder_quality.eval_hybrid).

eval_dense/eval_bm25 score each arm alone on full score matrices; the
framework ships their fusion (one-graph dense + BM25 + fuse_hits).  This
arm-runner trains the default label-free recipe (or loads saved params)
and reports bm25 / dense / hybrid side by side — the config-2/4 product
quality number.

Usage: python scripts/hybrid_quality.py [steps]   (default 5000;
       0 = random-init encoder only, no training)
Writes runs/hybrid_quality.json; params to runs/enc_hybrid_arm.npz.
"""
import json
import os
import sys

from rag_challenge_2_tpu.eval.encoder_quality import (
    build_dataset, eval_bm25, eval_dense, eval_hybrid)
from rag_challenge_2_tpu.models.encoder import EmbeddingModel, EncoderConfig

os.makedirs("runs", exist_ok=True)  # outputs stay in the checkout

steps = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
ds = build_dataset(seed=0)
cfg = EncoderConfig(max_len=96)
out = {"steps": steps}

out["bm25"] = eval_bm25(ds)
print("bm25 ", out["bm25"], flush=True)

if steps == 0:
    model = EmbeddingModel(cfg, seed=0)
else:
    from rag_challenge_2_tpu.models.pretrain import (
        PretrainConfig, pretrain_encoder, save_params)

    # PretrainConfig defaults = the measured-best label-free recipe
    # (bm25-distill 0.8/1.0 + alias swap 0.8).  The default constant-lr
    # train_cfg is the EXACT recipe behind the recorded quality number's
    # encoder_alias_distill numbers — do not add a schedule here.
    model, info = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=steps, batch_size=64, seed=0),
    )
    out["final"] = info["final"]
    save_params(model, "runs/enc_hybrid_arm.npz")

out["dense"] = eval_dense(model.embed, ds)
print("dense", out["dense"], flush=True)
hyb = eval_hybrid(model.embed, ds)
# the serving graph only returns top_n=30 rows, so this MRR is a lower
# bound truncated at rank 30 — NOT comparable to the full-ranking MRR of
# the dense/bm25 arms above; the key name carries the caveat
out["hybrid"] = {"hit@10": hyb["hit@10"], "mrr_at_30": hyb["mrr"],
                 "note": "mrr truncated at the serving top_n=30 "
                         "(lower bound); compare hit@10 across arms"}
print("hyb  ", out["hybrid"], flush=True)
json.dump(out, open("runs/hybrid_quality.json", "w"), indent=1)

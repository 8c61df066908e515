"""CLI for the on-device RAG pipeline.

Command set mirrors the reference's click CLI (reference main.py:6-64):
``parse-pdfs``, ``serialize-tables``, ``process-reports``,
``process-questions`` — plus ``bench`` (the benchmark) and ``query``
(one-shot retrieval inspection).  ``download-models`` exists for contract
parity; model weights here are the local encoder, nothing to download.
Built on the standard library's ``argparse``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path


def _pipeline(root: str, config: str, **overrides):
    from rag_challenge_2_tpu.pipeline import Pipeline, configs

    # copy the preset: overrides must not mutate the shared registry entry
    run_config = dataclasses.replace(
        configs[config], **{k: v for k, v in overrides.items() if v is not None}
    )
    return Pipeline(Path(root), run_config)


def download_models(args):
    """Warm local models (encoder init + compile-cache prime)."""
    from rag_challenge_2_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel

    model = EmbeddingModel()
    emb = model.embed(["warmup 预热"])
    print(f"encoder ready: dim={emb.shape[1]}")


def parse_pdfs(args):
    """PDF/TXT reports → parsed-report JSONs."""
    _pipeline(args.root, args.config).parse_pdf_reports(
        parallel=args.parallel, chunk_size=args.chunk_size,
        max_workers=args.max_workers, parser=args.parser,
    )
    print("parsed")


def serialize_tables(args):
    """LLM table serialization over parsed reports."""
    _pipeline(args.root, args.config).serialize_tables(max_workers=args.max_workers)
    print("serialized")


def process_reports(args):
    """Merge → markdown → chunk → build the on-device corpus index."""
    _pipeline(args.root, args.config).process_parsed_reports()
    print("index built")


def process_questions(args):
    """Answer questions.json against the built index."""
    p = _pipeline(args.root, args.config, use_hyde=args.use_hyde,
                  use_multi_query=args.use_multi_query)
    result = p.process_questions()
    print(json.dumps(result["statistics"], ensure_ascii=False))


def query(args):
    """One-shot retrieval: show top chunks with scores (no answer LLM)."""
    from rag_challenge_2_tpu.index import load_index
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

    p = _pipeline(args.root, args.config)
    idx, meta = load_index(p.paths.index_path)
    eng = QueryEngine(idx, meta)
    q_emb = p.embedder([args.question])
    cfg = SearchConfig(method=args.method, top_n=args.top_n, top_k=args.top_n,
                       use_bm25=args.use_bm25)
    results = eng.materialize(
        eng.search(q_emb, args.company, args.question, cfg=cfg,
                   query_texts=[args.question]), cfg
    )
    for r in results:
        print(
            f"[{r['distance']:.4f}] {r['source_sha1']} p{r['page']} "
            f"hits={r['hit_count']} methods={r['method_count']}: {r['text'][:80]}"
        )


def bench(args):
    """Run the benchmark (prints one JSON line)."""
    import bench as bench_mod

    bench_mod.main()


def serve_cmd(args):
    """Launch the web QA frontend over the built index."""
    from rag_challenge_2_tpu.serving.webapp import serve

    p = _pipeline(args.root, args.config)
    if args.micro_batch:
        p.run_config = dataclasses.replace(p.run_config, micro_batch=args.micro_batch)
    serve(p.build_processor(), host=args.host, port=args.port,
          default_company=args.company, pdf_dir=p.paths.pdf_reports_dir)


def train_encoder(args):
    """Self-supervised (ICT) encoder pretraining on the chunked corpus."""
    from rag_challenge_2_tpu.index.build import load_chunked_reports
    from rag_challenge_2_tpu.models.pretrain import (
        PretrainConfig, pretrain_encoder, save_params,
    )
    from rag_challenge_2_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    p = _pipeline(args.root, args.config)
    reports = load_chunked_reports(p.paths.documents_dir)
    texts = [c["text"] for r in reports for c in r["content"]["chunks"]]
    model, stats = pretrain_encoder(
        texts, pre_cfg=PretrainConfig(steps=args.steps, batch_size=args.batch_size)
    )
    out = args.out or (p.paths.databases_path / "encoder_params.npz")
    save_params(model, out)
    print(json.dumps({"params": str(out), **stats["final"]}, ensure_ascii=False))


def eval_encoder(args):
    """Encoder retrieval-quality experiment (BASELINE config 4): synthetic
    Chinese financial corpus, held-out paraphrase queries, hit@10/MRR of
    random-init vs ICT vs ICT+supervised vs the BM25 baseline."""
    from rag_challenge_2_tpu.eval.encoder_quality import run_quality_eval
    from rag_challenge_2_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    res = run_quality_eval(
        ict_steps=args.ict_steps, supervised_steps=args.supervised_steps,
        batch_size=args.batch_size, log=print,
    )
    line = json.dumps(res, ensure_ascii=False)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line)


def analyze_similarity(args):
    """Chunk-to-chunk cosine matrix + stats for one document
    (the reference's semantic_similarity_analysis)."""
    from rag_challenge_2_tpu.eval.similarity import analyze_document
    from rag_challenge_2_tpu.index import load_index

    p = _pipeline(args.root, args.config)
    idx, meta = load_index(p.paths.index_path)
    out = args.out or (p.paths.databases_path / "similarity")
    stats = analyze_document(idx, meta, args.doc, output_dir=out)
    print(json.dumps(stats, ensure_ascii=False))


def rank(args):
    """Score submissions against canonical answers (the reference's rank.py)."""
    from rag_challenge_2_tpu.eval import rank_submissions

    scores = rank_submissions(
        Path(args.submissions_dir), Path(args.answers),
        max_questions=args.max_questions,
        csv_out=Path(args.csv_out) if args.csv_out else None,
    )
    for i, s in enumerate(scores):
        print(f"{i+1}. {s.submission_name or s.file_name}: "
              f"score={s.score:.2f} (val {s.val_score:.1f} + ref {s.ref_score:.1f}/2)")


def _existing_path(value: str) -> str:
    if not Path(value).exists():
        raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
    return value


def _flag(p, on: str, off: str, default, help: str = "") -> None:
    """A ``--on/--off`` boolean pair writing one destination."""
    dest = on.lstrip("-").replace("-", "_")
    p.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    p.add_argument(off, dest=dest, action="store_false")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ragtpu", description="On-device RAG pipeline (rag_challenge_2_tpu).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    def cmd(name, fn, root_config=None):
        p = sub.add_parser(name, help=fn.__doc__.splitlines()[0],
                           description=fn.__doc__,
                           formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        p.set_defaults(func=fn)
        if root_config is not None:
            p.add_argument("--root", default="data/test_set")
            p.add_argument("--config", default=root_config)
        return p

    cmd("download-models", download_models)

    p = cmd("parse-pdfs", parse_pdfs, "base")
    _flag(p, "--parallel", "--sequential", False)
    p.add_argument("--chunk-size", type=int, default=2)
    p.add_argument("--max-workers", type=int, default=10)
    p.add_argument("--parser", default="auto", choices=["auto", "docling", "builtin"],
                   help="auto = docling when installed, else the built-in "
                        "parser (.txt + digital-text .pdf via minipdf)")

    p = cmd("serialize-tables", serialize_tables, "base")
    p.add_argument("--max-workers", type=int, default=5)

    cmd("process-reports", process_reports, "base")

    p = cmd("process-questions", process_questions, "qwen")
    _flag(p, "--use-hyde", "--no-hyde", None)
    _flag(p, "--use-multi-query", "--no-multi-query", None)

    p = cmd("query", query, "base")
    p.add_argument("--company", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--top-n", type=int, default=5)
    p.add_argument("--method", default="basic",
                   choices=["basic", "ssg", "triangulation", "hybrid_expansion"])
    _flag(p, "--use-bm25", "--no-bm25", False,
          help="fuse sparse BM25 hits into the dense results")

    cmd("bench", bench)

    p = cmd("serve", serve_cmd, "qwen")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8899)
    p.add_argument("--company", default="金盘科技")
    p.add_argument("--micro-batch", type=int, default=0,
                   help="coalesce concurrent same-route searches into one "
                        "vmapped device dispatch (0 = off)")

    p = cmd("train-encoder", train_encoder, "base")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None,
                   help="params npz (default <databases>/encoder_params.npz)")

    p = cmd("eval-encoder", eval_encoder)
    p.add_argument("--ict-steps", type=int, default=5000)
    p.add_argument("--supervised-steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None, help="write results json here")

    p = cmd("analyze-similarity", analyze_similarity, "base")
    p.add_argument("--doc", type=int, default=0, help="document id")
    p.add_argument("--out", default=None,
                   help="output dir (default <databases>/similarity)")

    p = cmd("rank", rank)
    p.add_argument("--submissions-dir", required=True, type=_existing_path)
    p.add_argument("--answers", required=True, type=_existing_path,
                   help="canonical answers JSON (question -> {kind, answers, "
                        "reference_pools})")
    p.add_argument("--max-questions", type=int, default=60)
    p.add_argument("--csv-out", default=None)
    return ap


def cli(argv=None) -> None:
    """Entry point (``ragtpu`` console script)."""
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    cli()

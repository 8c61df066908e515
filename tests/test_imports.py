"""The indexing and search path imports and runs with only the core
dependencies (jax, numpy, scipy, optax, chex, einops, ml_dtypes)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BLOCKED = ("flax", "pydantic", "requests", "pandas", "click", "aiohttp",
           "tabulate", "tiktoken")

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, sys

    BLOCKED = set(sys.argv[1].split(","))

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked optional package {name}")

    sys.meta_path.insert(0, Block())
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax._src.xla_bridge as xb

    for mod in ("models", "index", "ops", "retrieval.engine",
                "serving.batcher", "parallel", "pipeline.run", "ingestion"):
        importlib.import_module("rag_challenge_2_tpu." + mod)
    import main  # the CLI parses arguments with the standard library
    main.build_parser()
    # importing must not open a device: spawned workers import these too
    assert not xb.backends_are_initialized(), "an import created a device array"

    import numpy as np
    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

    rng = np.random.default_rng(0)
    reports, embs = [], []
    for d, year in enumerate((2023, 2024)):
        chunks = [{"page": 1, "text": f"金盘科技 {year}年 营业收入 第{i}段",
                   "id": i, "type": "content"} for i in range(6)]
        reports.append({"metainfo": {"sha1_name": f"J{year}_d{d}", "year": year,
                                     "company_name": "金盘科技"},
                        "content": {"pages": [{"page": 1, "text": "p"}],
                                    "chunks": chunks}})
        e = rng.normal(size=(6, 16)).astype(np.float32)
        embs.append(e / np.linalg.norm(e, axis=1, keepdims=True))
    idx, meta = build_corpus_index(reports, embs, vocab_bits=12)
    eng = QueryEngine(idx, meta)
    cfg = SearchConfig(method="basic", top_k=3, top_n=3, use_bm25=True)
    res = eng.materialize(eng.search(embs[1][:1], "金盘科技", "营业收入",
                                     cfg=cfg, query_texts=["营业收入"]), cfg)
    assert res and res[0]["rep_row"] == 6, res
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK")
""")


def test_main_path_runs_without_optional_packages():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(BLOCKED)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), (
        out.stdout[-2000:] + out.stderr[-4000:])

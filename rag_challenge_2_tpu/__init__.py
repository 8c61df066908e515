"""rag_challenge_2_tpu — an on-device retrieval / RAG framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
HEIcby/RAG-Challenge-2 (RAG-Challenge winning solution extended for Chinese
financial-report QA), run on an NVIDIA GPU.  The retrieval layer —
per-document FAISS flat inner-product search, BM25 sparse scoring, hybrid
fusion with multi-query/HyDE hit bonuses, year routing, and
SSG/Triangulation graph-traversal expansion — becomes a single on-device
index-and-query engine: embeddings live in device memory as (optionally
sharded) arrays, scoring is matmul + top-k, sparse scoring is a batched
CSR gather, and the whole hybrid query pipeline is one jitted graph over
a `jax.sharding.Mesh`.

Layout (bottom-up):
    utils/      tokenisation, timing, io helpers
    ops/        device ops: dense top-k, BM25 CSR scoring, segment
                aggregation, k-means (plain JAX, compiled by XLA)
    index/      on-device index format, host-side builders, persistence
    retrieval/  routing, dense/sparse/traversal retrievers, fusion,
                the jitted query pipeline
    models/     on-device embedding encoder (plain JAX) + contrastive training
    parallel/   mesh construction, sharded search, distributed top-k merge
    ingestion/  PDF→pages→chunks contract (docling optional, host-side)
    llm/        provider-agnostic LLM clients, prompts, reranker, glossary
    qa/         question-answering orchestration
    eval/       competition scorer, LLM-judge harness, recall/QPS bench
"""

__version__ = "0.1.0"

"""Benchmark: exact retrieval QPS + recall on the val-set-shaped workload.

BASELINE.json metric: "recall@10 vs FAISS-exact + query QPS at equal memory
(val_set, 127 queries)".  The val-set corpus (6 annual-report FAISS DBs,
~10k chunks × 1024-d Qwen embeddings — reference README.md:313-316) is not
shipped in the reference repo, so the bench reproduces its exact shape
synthetically: 6 per-year documents, ~10k unit-norm 1024-d vectors, 127
routed queries.

Baseline = the reference's compute: FAISS IndexFlatIP exact search on CPU
(= BLAS sgemm + partial sort; measured here as the numpy equivalent over
identical data).  Ours = the on-device engine path (routed masked matmul +
fused top-k on the accelerator).  recall@10 vs the CPU oracle must be 1.0 — exact is
exact — so the headline is QPS at equal recall and equal memory (same f32
matrix, no compression).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr)


def sync(x):
    """Wait until every array in ``x`` has been computed."""
    import jax

    return jax.block_until_ready(x)


def median_qps(fn, n_queries: int, reps: int, windows: int = 3) -> float:
    """Median queries/s over ``windows`` timing windows of ``reps`` calls."""
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn()
        sync(out)
        rates.append(n_queries * reps / (time.perf_counter() - t0))
    return float(np.median(rates))


def bench_ivf_1m(extras, N=1_000_000, D=1024, K_CLUSTERS=4096):
    """BASELINE config 3: IVF-Flat at 1M×1024, k-means built on the device,
    recall@10/@30 vs exact at equal memory (same f32 rows; the permuted
    copy replaces the flat matrix in production) + probe QPS."""
    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.ivf import build_ivf, ivf_search
    from rag_challenge_2_tpu.ops.topk import dense_topk

    NQ = 127
    # Real text embeddings are strongly clustered (documents, topics);
    # isotropic random vectors have no cluster structure and make every IVF
    # look broken.  Model the workload as a mixture of Gaussians with
    # queries perturbed from corpus points — the regime FAISS-IVF recall
    # numbers are quoted in.
    N_CENTERS = 1024
    key = jax.random.PRNGKey(0)
    kc_, ka_, kn_, kr_, kqn_ = jax.random.split(key, 5)

    import functools

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen_corpus(n):
        centers = jax.random.normal(kc_, (N_CENTERS, D), jnp.float32)
        centers /= jnp.linalg.norm(centers, axis=1, keepdims=True)
        a = jax.random.randint(ka_, (n,), 0, N_CENTERS)
        e = centers[a] + (0.35 / jnp.sqrt(D)) * jax.random.normal(kn_, (n, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    @jax.jit
    def gen_queries(emb):
        r = jax.random.randint(kr_, (NQ,), 0, emb.shape[0])
        qq = emb[r] + (0.25 / jnp.sqrt(D)) * jax.random.normal(kqn_, (NQ, D), jnp.float32)
        return qq / jnp.linalg.norm(qq, axis=1, keepdims=True)

    emb = gen_corpus(N)
    q = gen_queries(emb)
    sync(emb)

    t0 = time.perf_counter()
    ivf = build_ivf(emb, n_clusters=K_CLUSTERS, iters=8,
                    max_list_size=max(2 * N // K_CLUSTERS, 16))
    sync(ivf.emb_perm)
    build_s = time.perf_counter() - t0
    # Attribution for run-to-run recall deltas: the k-means seed is
    # pinned (build_ivf default seed=0) but device f32 reductions are not
    # bit-deterministic run-to-run, so (K, max_list, nprobe) are recorded
    # with every run.
    extras["ivf_1m_k"] = ivf.k_clusters
    extras["ivf_1m_max_list"] = ivf.max_list
    extras["ivf_1m_seed"] = 0
    log(f"ivf 1M build (on-device kmeans K={K_CLUSTERS}, balanced, seed=0): "
        f"{build_s:.1f}s, max_list={ivf.max_list}")

    # exact oracle (f32 flat) for recall
    oracle_v, oracle_i = dense_topk(q, emb, 30, impl="xla")
    oracle10 = np.asarray(oracle_i)[:, :10]
    oracle30 = np.asarray(oracle_i)

    sweep = []
    for nprobe in (2, 4, 8):
        vals, rows = ivf_search(ivf, q, 30, nprobe=nprobe)
        got = np.asarray(rows)  # also settles the compile
        r10 = float(np.mean([
            len(set(got[i, :10]) & set(oracle10[i])) / 10 for i in range(NQ)
        ]))
        r30 = float(np.mean([
            len(set(got[i]) & set(oracle30[i])) / 30 for i in range(NQ)
        ]))
        qps = median_qps(lambda: ivf_search(ivf, q, 30, nprobe=nprobe), NQ, reps=10)
        sweep.append((nprobe, r10, r30, qps))
        log(f"ivf 1M nprobe={nprobe}: recall@10={r10:.4f} recall@30={r30:.4f} "
            f"{qps:.1f} qps")
        extras[f"ivf_1m_recall@10_np{nprobe}"] = round(r10, 4)
        extras[f"ivf_1m_qps_np{nprobe}"] = round(qps, 1)
    # headline = fastest operating point that keeps recall@10 ≥ 0.9
    good = [s for s in sweep if s[1] >= 0.9] or [max(sweep, key=lambda s: s[1])]
    np_, r10_, r30_, qps_ = max(good, key=lambda s: s[3])
    extras["ivf_1m_nprobe"] = np_
    extras["ivf_1m_recall@10"] = round(r10_, 4)
    extras["ivf_1m_recall@30"] = round(r30_, 4)
    extras["ivf_1m_qps"] = round(qps_, 1)

    # bf16 probe variant: same lists/centroids, rows stored bf16 — HALF the
    # probe bytes AND half the index memory (below the equal-memory bar);
    # recall is re-measured because scores quantize
    import dataclasses as _dc

    ivf16 = _dc.replace(ivf, emb_perm=ivf.emb_perm.astype(jnp.bfloat16))
    v16, r16 = ivf_search(ivf16, q, 30, nprobe=extras["ivf_1m_nprobe"])
    got16 = np.asarray(r16)
    extras["ivf_1m_bf16_recall@10"] = round(float(np.mean([
        len(set(got16[i, :10]) & set(oracle10[i])) / 10 for i in range(NQ)
    ])), 4)
    extras["ivf_1m_bf16_qps"] = round(median_qps(
        lambda: ivf_search(ivf16, q, 30, nprobe=extras["ivf_1m_nprobe"]),
        NQ, reps=10), 1)
    log(f"ivf 1M bf16 nprobe={extras['ivf_1m_nprobe']}: "
        f"recall@10={extras['ivf_1m_bf16_recall@10']} {extras['ivf_1m_bf16_qps']} qps")

    # exact-flat QPS at 1M for the speedup-vs-exact context
    ev, _ = dense_topk(q, emb, 30, impl="xla")
    sync(ev)
    extras["exact_1m_qps"] = round(
        median_qps(lambda: dense_topk(q, emb, 30, impl="xla"), NQ, reps=5), 1)
    extras["ivf_1m_build_s"] = round(build_s, 1)
    log(f"exact flat 1M: {extras['exact_1m_qps']} qps")


def bench_hybrid_at_scale(extras, N=1_500_000, D=1024, V_BITS=18, W=512):
    """BASELINE config 5 (single-chip witness): dense+BM25+routing+fusion in
    ONE jitted graph at the largest corpus one chip holds comfortably
    (1.5M×1024 bf16 rows + a synthetic capped CSR).  The multi-chip sharded
    variant of the same graph is validated by dryrun_multichip."""
    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu.ops.topk import dense_topk
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig, search_device

    N_DOCS, Q_BATCH, NQ, T = 6, 8, 127, 64
    key = jax.random.PRNGKey(1)
    kq, ke, kc, kt, kqt = jax.random.split(key, 5)

    import functools

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen(k, n):
        e = jax.random.normal(k, (n, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    emb32 = gen(ke, N)
    q32 = gen(kq, NQ)
    # f32 oracle BEFORE casting down (transient peak; freed below)
    _, oracle_i = dense_topk(q32, emb32, 10, impl="xla")
    oracle10 = np.asarray(oracle_i)
    emb = emb32.astype(jnp.bfloat16)
    del emb32
    q = q32.astype(jnp.bfloat16)
    sync(emb)

    # synthetic capped CSR generated on device (a real build tokenizes text
    # host-side; the scorer's cost depends only on these shapes)

    V = 1 << V_BITS
    rng = np.random.default_rng(3)
    counts = rng.integers(1, W + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    chunk_ids = jax.random.randint(kc, (nnz,), 0, N, jnp.int32)
    tf = jax.random.randint(kt, (nnz,), 1, 5, jnp.int32).astype(jnp.float32)
    sparse = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=chunk_ids,
        tf=tf,
        df=jnp.asarray(counts, jnp.float32),
        chunk_len=jnp.full((N,), 300.0, jnp.float32),
        avgdl=jnp.float32(300.0),
        dl=jnp.full((nnz,), 300.0, jnp.float32),
        vocab_bits=V_BITS,
        max_postings=W,
    )

    rows = jnp.arange(N, dtype=jnp.int32)
    per_doc = N // N_DOCS
    doc_id = rows // per_doc
    idx = CorpusIndex(
        emb=emb, doc_id=doc_id, page=rows % 500 + 1,
        year=2020 + doc_id, company_id=jnp.zeros((N,), jnp.int32),
        kind=jnp.zeros((N,), jnp.int32), page_seg=rows // 4,
        chunk_in_doc=rows % per_doc, valid=jnp.ones((N,), bool),
        sparse=sparse, n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    # year-routed doc masks (3-doc window, as extract_years does) + the
    # slot-per-row map the single-sort BM25 top-k uses
    doc_masks = jnp.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = jnp.asarray([True, True, True, False, False, False])
    row_slot = jnp.where(doc_id < 3, doc_id, N_DOCS).astype(jnp.int32)

    cfg = SearchConfig(
        method="basic", top_k=30, max_queries=Q_BATCH, max_docs=N_DOCS,
        top_n=30, use_bm25=True, bm25_top_k=30,
    )
    q_valid = jnp.ones((Q_BATCH,), bool)
    q_terms = jax.random.randint(kqt, (Q_BATCH, T), 0, V, jnp.int32)

    ws = jnp.arange(N_DOCS, dtype=jnp.int32) * per_doc
    wl = jnp.full((N_DOCS,), per_doc, jnp.int32)

    def one_call(qs):
        return search_device(
            idx, qs, q_valid, doc_masks, doc_valid, cfg, q_terms, None, row_slot,
            ws, wl, window=per_doc,
        )

    reps = 16  # 16 calls × 8 queries = 128 ≈ the 127-question val set
    # pre-slice on device: a per-call eager slice costs one extra
    # dispatch each and inflates the measured latency
    q_batches = [
        q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH] for r in range(reps)
    ]
    sync(q_batches[-1])
    fused, _ = one_call(q_batches[0])
    sync(fused.score)  # compile + settle

    def window():
        out = None
        for r in range(reps):
            out = one_call(q_batches[r])
        return out[0].score

    hybrid_qps = median_qps(lambda: window(), Q_BATCH * reps, reps=1)

    # dense recall@10 of the served bf16 path vs the f32 oracle (routing off
    # for comparability with the oracle)
    _, got_i = dense_topk(q, emb, 10, impl="xla")
    got = np.asarray(got_i)
    r10 = float(np.mean([
        len(set(got[i]) & set(oracle10[i])) / 10 for i in range(NQ)
    ]))
    extras["hybrid_qps"] = round(hybrid_qps, 1)
    extras["hybrid_corpus_rows"] = N
    extras["hybrid_bf16_recall@10"] = round(r10, 4)
    log(f"hybrid {N/1e6:g}M bf16 (dense+bm25+fusion, one graph): {hybrid_qps:.1f} qps, "
        f"dense bf16 recall@10 vs f32 exact = {r10:.4f}")

    # cross-request micro-batching (serving/batcher.py): R same-route
    # requests ride ONE vmapped dispatch (engine.search_many_device), so
    # the corpus rows are read from HBM once per micro-batch instead of
    # once per question — the concurrent-QA serving configuration
    from rag_challenge_2_tpu.retrieval.engine import search_many_device

    R = 4
    q_many = jnp.stack(q_batches[:R])                       # [R, Q, D]
    qv_many = jnp.broadcast_to(q_valid, (R, Q_BATCH))
    qt_many = jnp.broadcast_to(q_terms, (R, Q_BATCH, T))
    sync(q_many)

    def many_call():
        return search_many_device(
            idx, q_many, qv_many, doc_masks, doc_valid, cfg, qt_many, None,
            row_slot, ws, wl, window=per_doc, with_terms=True,
        )

    sync(many_call().score)  # compile + settle
    reps_m = max(reps // R, 1)

    def window_m():
        out = None
        for _ in range(reps_m):
            out = many_call()
        return out.score

    mb_qps = median_qps(lambda: window_m(), R * Q_BATCH * reps_m, reps=1)
    extras["hybrid_microbatch_qps"] = round(mb_qps, 1)
    extras["hybrid_microbatch_r"] = R
    log(f"hybrid micro-batch R={R} (one vmapped dispatch per {R} requests): "
        f"{mb_qps:.1f} qps ({mb_qps / hybrid_qps:.2f}x unbatched)")


def bench_int8_10m(extras, N=10_000_000, D=1024, C=500_000):
    """BASELINE config 5 at its FULL 10M-row target on ONE chip: the int8
    row store (ops/quant.py) holds 10M×1024 in 10.2 GB — a corpus the
    reference's 8 GB server cannot even load as f32.  Generated on device
    in chunks straight into a donated int8 buffer (no host transfer, no
    f32 10M matrix ever exists); the exact f32 oracle for recall is
    accumulated per chunk BEFORE quantization."""
    import functools

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.ops.quant import int8_topk, quantize_rows

    NQ, N_CENTERS = 127, 4096
    key = jax.random.PRNGKey(0)
    kc_, kq_ = jax.random.split(key, 2)
    centers = jax.random.normal(kc_, (N_CENTERS, D), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def gen_chunk(buf, scales, centers, i):
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ka, kn = jax.random.split(k)
        a = jax.random.randint(ka, (C,), 0, N_CENTERS)
        e = centers[a] + (0.35 / jnp.sqrt(D)) * jax.random.normal(kn, (C, D), jnp.float32)
        e = e / jnp.linalg.norm(e, axis=1, keepdims=True)
        q8, sc = quantize_rows(e)
        buf = jax.lax.dynamic_update_slice(buf, q8, (i * C, jnp.int32(0)))
        scales = jax.lax.dynamic_update_slice(scales, sc, (i * C,))
        return buf, scales, e

    @jax.jit
    def oracle_merge(top_v, top_i, q, chunk_f32, base):
        s = jnp.dot(q, chunk_f32.T, preferred_element_type=jnp.float32)
        v, j = jax.lax.top_k(s, 10)
        cv = jnp.concatenate([top_v, v], axis=1)
        ci = jnp.concatenate([top_i, j + base], axis=1)
        nv, nj = jax.lax.top_k(cv, 10)
        return nv, jnp.take_along_axis(ci, nj, axis=1)

    buf = jnp.zeros((N, D), jnp.int8)
    scales = jnp.zeros((N,), jnp.float32)
    top_v = jnp.full((NQ, 10), NEG_INF_F, jnp.float32)
    top_i = jnp.full((NQ, 10), -1, jnp.int32)
    q = None
    t0 = time.perf_counter()
    for i in range(N // C):
        buf, scales, e = gen_chunk(buf, scales, centers, jnp.int32(i))
        if i == 0:
            kr, kn2 = jax.random.split(kq_)
            r = jax.random.randint(kr, (NQ,), 0, C)
            q = e[r] + (0.25 / jnp.sqrt(D)) * jax.random.normal(kn2, (NQ, D), jnp.float32)
            q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
        top_v, top_i = oracle_merge(top_v, top_i, q, e, jnp.int32(i * C))
        del e
    sync(buf)
    sync(top_v)
    build_s = time.perf_counter() - t0
    oracle = np.asarray(top_i)
    _SHARED_10M["q"] = np.asarray(q)
    _SHARED_10M["oracle"] = oracle
    log(f"int8 10M gen+oracle: {build_s:.1f}s")

    v8, i8 = int8_topk(q, buf, scales, 10)
    sync(v8)
    got = np.asarray(i8)
    r10 = float(np.mean([
        len(set(got[i]) & set(oracle[i])) / 10 for i in range(NQ)
    ]))
    qps = median_qps(lambda: int8_topk(q, buf, scales, 10), NQ, reps=3)
    extras["int8_10m_qps"] = round(qps, 1)
    extras["int8_10m_recall@10"] = round(r10, 4)
    extras["int8_10m_build_s"] = round(build_s, 1)
    log(f"int8 exact scan 10M (one chip, 10.2 GB): {qps:.1f} qps, "
        f"recall@10 vs f32 oracle = {r10:.4f}")

    # the FAST tier: fused PartialReduce scan (ops/topk.py approx_topk) —
    # the one top-k XLA fuses into the matmul epilogue, so the scan runs
    # at the corpus-read roofline instead of materializing+sorting a
    # [127, 10M] score matrix.  Approximate by construction; recall is
    # MEASURED here against the same f32 oracle (the honesty contract in
    # DESIGN.md "PartialReduce").
    from rag_challenge_2_tpu.ops.topk import approx_topk

    va, ia = approx_topk(q, buf, 10, recall_target=0.95, row_scale=scales)
    sync(va)
    got_a = np.asarray(ia)
    r10_a = float(np.mean([
        len(set(got_a[i]) & set(oracle[i])) / 10 for i in range(NQ)
    ]))
    qps_a = median_qps(
        lambda: approx_topk(q, buf, 10, recall_target=0.95, row_scale=scales),
        NQ, reps=3)
    extras["int8_10m_approx_qps"] = round(qps_a, 1)
    extras["int8_10m_approx_recall@10"] = round(r10_a, 4)
    log(f"int8 approx scan 10M (fused PartialReduce, rt=0.95): "
        f"{qps_a:.1f} qps, recall@10 vs f32 oracle = {r10_a:.4f}")

    # the one-graph hybrid (dense int8 + capped-CSR BM25 + routing +
    # fusion) at the full 10M target — the engine dispatches on emb.dtype
    import jax.numpy as jnp  # noqa: F811  (section style)

    from rag_challenge_2_tpu.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig, search_device

    N_DOCS, Q_BATCH, T, V_BITS, W = 6, 4, 64, 18, 512
    kc2, kt2, kqt2 = jax.random.split(jax.random.PRNGKey(3), 3)
    V = 1 << V_BITS
    rng = np.random.default_rng(3)
    counts = rng.integers(1, W + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    sparse = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=jax.random.randint(kc2, (nnz,), 0, N, jnp.int32),
        tf=jax.random.randint(kt2, (nnz,), 1, 5, jnp.int32).astype(jnp.float32),
        df=jnp.asarray(counts, jnp.float32),
        chunk_len=jnp.full((N,), 300.0, jnp.float32),
        avgdl=jnp.float32(300.0),
        dl=jnp.full((nnz,), 300.0, jnp.float32),
        vocab_bits=V_BITS, max_postings=W,
    )
    rows = jnp.arange(N, dtype=jnp.int32)
    per_doc = N // N_DOCS
    # clamp: when N_DOCS doesn't divide N the last few rows would get doc
    # id N_DOCS (routed nowhere on device, and an out-of-range id host-side)
    doc_id = jnp.minimum(rows // per_doc, N_DOCS - 1).astype(jnp.int32)
    idx = CorpusIndex(
        emb=buf, doc_id=doc_id, page=rows % 500 + 1, year=2020 + doc_id,
        company_id=jnp.zeros((N,), jnp.int32), kind=jnp.zeros((N,), jnp.int32),
        page_seg=rows // 4, chunk_in_doc=rows % per_doc,
        valid=jnp.ones((N,), bool), sparse=sparse, emb_scale=scales,
        n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    doc_masks = jnp.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = jnp.asarray([True, True, True, False, False, False])
    row_slot = jnp.where(doc_id < 3, doc_id, N_DOCS).astype(jnp.int32)
    cfg = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                       max_docs=N_DOCS, top_n=30, use_bm25=True, bm25_top_k=30)
    q_valid = jnp.ones((Q_BATCH,), bool)
    q_terms = jax.random.randint(kqt2, (Q_BATCH, T), 0, V, jnp.int32)

    ws = jnp.arange(N_DOCS, dtype=jnp.int32) * per_doc
    wl = jnp.full((N_DOCS,), per_doc, jnp.int32)

    def one_call(qs):
        return search_device(idx, qs, q_valid, doc_masks, doc_valid, cfg,
                             q_terms, None, row_slot, ws, wl, window=per_doc)

    reps = 16
    q_batches = [q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH] for r in range(reps)]
    sync(q_batches[-1])
    fused, _ = one_call(q_batches[0])
    sync(fused.score)

    def window():
        out = None
        for r in range(reps):
            out = one_call(q_batches[r])
        return out[0].score

    extras["hybrid_10m_int8_qps"] = round(
        median_qps(lambda: window(), Q_BATCH * reps, reps=1), 1)
    log(f"hybrid 10m int8 (dense+bm25+fusion, one graph, routed): "
        f"{extras['hybrid_10m_int8_qps']} qps")

    # hybrid FAST tier: SearchConfig.scan_rt routes the huge-window
    # pair_topk (W = 1.67M columns/doc here) through the fused
    # PartialReduce instead of an exact [M·Q, W] sort.  Agreement is
    # measured as top-n candidate overlap vs the exact graph on the same
    # query batch.
    import dataclasses

    cfg_rt = dataclasses.replace(cfg, scan_rt=0.95)

    def one_call_rt(qs):
        return search_device(idx, qs, q_valid, doc_masks, doc_valid, cfg_rt,
                             q_terms, None, row_slot, ws, wl, window=per_doc)

    fused_rt, _ = one_call_rt(q_batches[0])
    sync(fused_rt.score)
    exact_keys = set(np.asarray(fused.key).tolist()) - {-1}
    rt_keys = set(np.asarray(fused_rt.key).tolist()) - {-1}
    overlap = len(exact_keys & rt_keys) / max(1, len(exact_keys))

    def window_rt():
        out = None
        for r in range(reps):
            out = one_call_rt(q_batches[r])
        return out[0].score

    extras["hybrid_10m_int8_approx_qps"] = round(
        median_qps(lambda: window_rt(), Q_BATCH * reps, reps=1), 1)
    extras["hybrid_10m_int8_approx_overlap"] = round(overlap, 4)
    log(f"hybrid 10m int8 approx (scan_rt=0.95): "
        f"{extras['hybrid_10m_int8_approx_qps']} qps, "
        f"top-n overlap vs exact = {overlap:.4f}")

    # SERVING throughput: two dispatch threads (a server handling
    # concurrent questions) — host-side dispatch overlaps with device
    # execution, exposing the graph's device-time ceiling.  The device
    # still executes one program at a time; this changes nothing there.
    import threading

    def dispatch_half(out_box, i):
        o = None
        for r in range(i, reps, 2):
            o = one_call_rt(q_batches[r])
        out_box[i] = o[0].score

    def window_conc():
        box = {}
        t = threading.Thread(target=dispatch_half, args=(box, 1))
        t.start()
        dispatch_half(box, 0)
        t.join()
        sync(box[0])
        sync(box[1])
        return box[0]

    extras["hybrid_10m_int8_serving_qps"] = round(
        median_qps(lambda: window_conc(), Q_BATCH * reps, reps=1), 1)
    log(f"hybrid 10m int8 serving (2 dispatch threads, scan_rt=0.95): "
        f"{extras['hybrid_10m_int8_serving_qps']} qps")


def bench_int8_residual_10m(extras, N=10_000_000, D=1024, C=500_000,
                            K_CODE=16384):
    """The r5 recall lever: centroid-residual int8 at the
    full 10M target — same stored bytes as bench_int8_10m's plain store
    (+0.4% for the i32 assignment ids), recall@10 0.9197 → 0.96+ via
    residual coding + 2-pass query quantization + the two-stage rescore
    (ops/quant.py; design + full arm table in DESIGN.md
    "Centroid-residual int8").  Codebook k-means is LEARNED on a 250k
    on-device sample — never the generator's centers."""
    import functools

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.ops.kmeans import kmeans
    from rag_challenge_2_tpu.ops.quant import (
        int8_residual_approx_topk, int8_residual_topk,
        int8_residual_topk_rescored, quantize_rows_residual)

    NQ, N_CENTERS = 127, 4096
    key = jax.random.PRNGKey(0)
    kc_, kq_ = jax.random.split(key, 2)
    centers = jax.random.normal(kc_, (N_CENTERS, D), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @jax.jit
    def gen_f32(centers, i):
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ka, kn = jax.random.split(k)
        a = jax.random.randint(ka, (C,), 0, N_CENTERS)
        e = centers[a] + (0.35 / jnp.sqrt(D)) * jax.random.normal(
            kn, (C, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2))
    def gen_write(buf, scales, assigns, code, centers, i):
        # gen + assign + residual-quantize + write in ONE jit — the
        # 10.2 GB destination leaves no room for host-visible f32 copies
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ka, kn = jax.random.split(k)
        a_ = jax.random.randint(ka, (C,), 0, N_CENTERS)
        e = centers[a_] + (0.35 / jnp.sqrt(D)) * jax.random.normal(
            kn, (C, D), jnp.float32)
        e = e / jnp.linalg.norm(e, axis=1, keepdims=True)
        q8, sc, a = quantize_rows_residual(e, code)
        buf = jax.lax.dynamic_update_slice(buf, q8, (i * C, jnp.int32(0)))
        scales = jax.lax.dynamic_update_slice(scales, sc, (i * C,))
        assigns = jax.lax.dynamic_update_slice(assigns, a, (i * C,))
        return buf, scales, assigns, e

    @jax.jit
    def oracle_merge(top_v, top_i, q, chunk_f32, base):
        s = jnp.dot(q, chunk_f32.T, preferred_element_type=jnp.float32)
        v, j = jax.lax.top_k(s, 10)
        cv = jnp.concatenate([top_v, v], axis=1)
        ci = jnp.concatenate([top_i, j + base], axis=1)
        nv, nj = jax.lax.top_k(cv, 10)
        return nv, jnp.take_along_axis(ci, nj, axis=1)

    t0 = time.perf_counter()
    e0 = gen_f32(centers, jnp.int32(0))
    code, _ = kmeans(e0[:250_000], K_CODE, iters=6, seed=0)
    sync(code)
    have_oracle = "oracle" in _SHARED_10M
    if have_oracle:
        q = jnp.asarray(_SHARED_10M["q"])
    else:
        kr, kn2 = jax.random.split(kq_)
        r = jax.random.randint(kr, (NQ,), 0, C)
        q = e0[r] + (0.25 / jnp.sqrt(D)) * jax.random.normal(
            kn2, (NQ, D), jnp.float32)
        q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
        sync(q)
    del e0
    buf = jnp.zeros((N, D), jnp.int8)
    scales = jnp.zeros((N,), jnp.float32)
    assigns = jnp.zeros((N,), jnp.int32)
    top_v = jnp.full((NQ, 10), NEG_INF_F, jnp.float32)
    top_i = jnp.full((NQ, 10), -1, jnp.int32)
    for i in range(N // C):
        buf, scales, assigns, e = gen_write(buf, scales, assigns, code,
                                            centers, jnp.int32(i))
        if not have_oracle:
            top_v, top_i = oracle_merge(top_v, top_i, q, e, jnp.int32(i * C))
        del e
    sync(buf)
    if have_oracle:
        oracle = _SHARED_10M["oracle"]
    else:
        sync(top_v)
        oracle = np.asarray(top_i)
        _SHARED_10M["q"] = np.asarray(q)
        _SHARED_10M["oracle"] = oracle
    build_s = time.perf_counter() - t0
    extras["int8r_10m_build_s"] = round(build_s, 1)
    extras["int8r_10m_codebook_k"] = K_CODE
    log(f"residual int8 10M build (kmeans K={K_CODE} + streamed "
        f"residual quantize): {build_s:.1f}s")

    def arm(fn, name, label):
        v, i = fn()
        sync(v)
        got = np.asarray(i)
        r10 = float(np.mean([
            len(set(got[j]) & set(oracle[j])) / 10 for j in range(NQ)]))
        qps = median_qps(fn, NQ, reps=3)
        extras[f"int8r_{name}_qps"] = round(qps, 1)
        extras[f"int8r_{name}_recall@10"] = round(r10, 4)
        log(f"residual int8 10M {label}: {qps:.1f} qps, "
            f"recall@10 vs f32 oracle = {r10:.4f}")

    arm(lambda: int8_residual_topk(q, buf, scales, assigns, code, 10,
                                   query_2pass=True),
        "exact2p", "exact 2-pass query")
    arm(lambda: int8_residual_approx_topk(q, buf, scales, assigns, code,
                                          10, recall_target=0.95),
        "approx2p", "approx 2-pass (rt=0.95)")
    arm(lambda: int8_residual_approx_topk(q, buf, scales, assigns, code,
                                          10, recall_target=0.95,
                                          query_2pass=False),
        "approx1p", "approx 1-pass (rt=0.95)")
    arm(lambda: int8_residual_topk_rescored(q, buf, scales, assigns, code,
                                            10, k_cand=48,
                                            recall_target=0.95),
        "rescored", "two-stage rescored (k_cand=48)")


NEG_INF_F = -3.0e38

T_MAIN_START = 0.0

# Cross-section cache: bench_int8_10m and bench_ivf_10m use the SAME
# clustered generator (PRNGKey(1) chunk folds) and query set, so the
# f32 oracle pass (~30 s of matmuls over 10M rows) runs once and is
# reused (stop regenerating the 10M corpus per section).
_SHARED_10M: dict = {}


def bench_ivf_10m(extras, N=10_000_000, D=1024, C=500_000, N_CENTERS=4096):
    """BASELINE config 5 with PROBES instead of the exact scan: a balanced
    int8 IVF over the full 10M rows on one chip, built STREAMING
    (index/ivf.build_ivf_streaming — the flat+permuted pair of copies the
    in-memory builder holds is 20.5 GB, more than the chip; the streamed
    build holds one f32 chunk beside the destination).  Same clustered
    generator and f32 oracle as bench_int8_10m."""
    import functools

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.ivf import build_ivf_streaming, ivf_search

    NQ = 127
    key = jax.random.PRNGKey(0)
    kc_, kq_ = jax.random.split(key, 2)
    centers = jax.random.normal(kc_, (N_CENTERS, D), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @jax.jit
    def gen_chunk(centers, i):
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ka, kn = jax.random.split(k)
        a = jax.random.randint(ka, (C,), 0, N_CENTERS)
        e = centers[a] + (0.35 / jnp.sqrt(D)) * jax.random.normal(kn, (C, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    @jax.jit
    def oracle_merge(top_v, top_i, q, chunk_f32, base):
        s = jnp.dot(q, chunk_f32.T, preferred_element_type=jnp.float32)
        v, j = jax.lax.top_k(s, 10)
        cv = jnp.concatenate([top_v, v], axis=1)
        ci = jnp.concatenate([top_i, j + base], axis=1)
        nv, nj = jax.lax.top_k(cv, 10)
        return nv, jnp.take_along_axis(ci, nj, axis=1)

    # exact f32 oracle + queries, one generation pass (no corpus kept) —
    # or reused from bench_int8_10m, which generates the IDENTICAL
    # corpus/query draw (same keys) and already paid for this pass
    if "oracle" in _SHARED_10M:
        q = jnp.asarray(_SHARED_10M["q"])
        oracle = _SHARED_10M["oracle"]
        log("ivf 10M: reusing int8-section queries + f32 oracle")
    else:
        top_v = jnp.full((NQ, 10), NEG_INF_F, jnp.float32)
        top_i = jnp.full((NQ, 10), -1, jnp.int32)
        q = None
        for i in range(N // C):
            e = gen_chunk(centers, jnp.int32(i))
            if i == 0:
                kr, kn2 = jax.random.split(kq_)
                r = jax.random.randint(kr, (NQ,), 0, C)
                q = e[r] + (0.25 / jnp.sqrt(D)) * jax.random.normal(
                    kn2, (NQ, D), jnp.float32)
                q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
            top_v, top_i = oracle_merge(top_v, top_i, q, e, jnp.int32(i * C))
            del e
        sync(top_v)
        oracle = np.asarray(top_i)

    t0 = time.perf_counter()
    ivf = build_ivf_streaming(
        functools.partial(gen_chunk, centers), N // C,
        iters=8, sample_rows=C, max_list_size=2048, quantize=True,
    )
    sync(ivf.emb_perm)
    build_s = time.perf_counter() - t0
    extras["ivf_10m_int8_build_s"] = round(build_s, 1)
    extras["ivf_10m_int8_k"] = ivf.k_clusters
    extras["ivf_10m_int8_max_list"] = ivf.max_list
    log(f"ivf 10M int8 streamed build: {build_s:.1f}s "
        f"(K={ivf.k_clusters}, max_list={ivf.max_list})")

    best = None
    for nprobe in (4, 8, 16):
        v, rows = ivf_search(ivf, q, 10, nprobe=nprobe)
        sync(v)
        got = np.asarray(rows)
        r10 = float(np.mean([
            len(set(got[i]) & set(oracle[i])) / 10 for i in range(NQ)
        ]))
        qps = median_qps(lambda: ivf_search(ivf, q, 10, nprobe=nprobe), NQ, reps=3)
        extras[f"ivf_10m_int8_recall@10_np{nprobe}"] = round(r10, 4)
        extras[f"ivf_10m_int8_qps_np{nprobe}"] = round(qps, 1)
        log(f"ivf 10M int8 nprobe={nprobe}: recall@10={r10:.4f} {qps:.1f} qps")
        if best is None or (r10 >= 0.9 and best[1] < 0.9) or (
            (r10 >= 0.9) == (best[1] >= 0.9) and qps > best[2]
        ):
            best = (nprobe, r10, qps)
    extras["ivf_10m_int8_nprobe"] = best[0]
    extras["ivf_10m_int8_recall@10"] = round(best[1], 4)
    extras["ivf_10m_int8_qps"] = round(best[2], 1)

    # ---- the PROBE-SERVED hybrid at 10M: cluster-ordered store ---------
    # index/ivf.cluster_order_index makes ivf.emb_perm THE corpus (one
    # 10.2 GB buffer for probes + flat paths — flat+IVF side by side would
    # need 20.4 GB and cannot fit the chip), so the full routed
    # dense+BM25+fusion graph can run its dense stage through probes
    # instead of the exact scan (reference: FAISS serves IVF lists only,
    # src/ingestion.py:79-102).
    from rag_challenge_2_tpu.index.ivf import cluster_order_index
    from rag_challenge_2_tpu.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig, search_device

    # Q_BATCH=8 matches bench_hybrid_at_scale's query batch: the probe
    # path never scans the corpus, so unlike the exact-scan hybrid
    # (Q_BATCH=4 to bound its [M·Q, W] windows) a bigger batch just
    # amortizes the fixed per-dispatch cost
    N_DOCS, Q_BATCH, T, V_BITS, W_P = 6, 8, 64, 18, 512
    V = 1 << V_BITS
    rng = np.random.default_rng(3)
    counts = rng.integers(1, W_P + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    kc2, kt2, kqt2 = jax.random.split(jax.random.PRNGKey(3), 3)
    sparse = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=jax.random.randint(kc2, (nnz,), 0, N, jnp.int32),
        tf=jax.random.randint(kt2, (nnz,), 1, 5, jnp.int32).astype(jnp.float32),
        df=jnp.asarray(counts, jnp.float32),
        chunk_len=jnp.full((N,), 300.0, jnp.float32),
        avgdl=jnp.float32(300.0),
        dl=jnp.full((nnz,), 300.0, jnp.float32),
        vocab_bits=V_BITS, max_postings=W_P,
    )
    rows = jnp.arange(N, dtype=jnp.int32)
    per_doc = N // N_DOCS
    doc_id = jnp.minimum(rows // per_doc, N_DOCS - 1).astype(jnp.int32)
    # flat-layout CorpusIndex carrying METADATA only (emb is a 1-row
    # placeholder — cluster_order_index replaces it with ivf.emb_perm, and
    # the flat 10M store never exists in this section)
    idx_flat = CorpusIndex(
        emb=jnp.zeros((N, 1), jnp.int8), doc_id=doc_id, page=rows % 500 + 1,
        year=2020 + doc_id, company_id=jnp.zeros((N,), jnp.int32),
        kind=jnp.zeros((N,), jnp.int32), page_seg=rows // 4,
        chunk_in_doc=rows % per_doc, valid=jnp.ones((N,), bool),
        sparse=sparse, n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    idx_co, _, ivf_co = cluster_order_index(idx_flat, None, ivf)
    del idx_flat
    doc_masks = jnp.stack([idx_co.doc_id == d for d in range(N_DOCS)])
    doc_valid = jnp.asarray([True, True, True, False, False, False])
    row_slot = jnp.where(
        idx_co.doc_id < 3, idx_co.doc_id, N_DOCS).astype(jnp.int32)
    cfg = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                       max_docs=N_DOCS, top_n=30, use_bm25=True,
                       bm25_top_k=30, use_ivf=True,
                       ivf_nprobe=int(extras["ivf_10m_int8_nprobe"]))
    q_valid = jnp.ones((Q_BATCH,), bool)
    q_terms = jax.random.randint(kqt2, (Q_BATCH, T), 0, V, jnp.int32)

    def one_call(qs):
        return search_device(
            idx_co, qs, q_valid, doc_masks, doc_valid, cfg, q_terms,
            ivf_co, row_slot,
            # doc-equality probe routing (ivf_search pair_doc mode):
            # routed doc ids per slot, -1 for the unrouted slots
            slot_doc=jnp.asarray([0, 1, 2, -1, -1, -1], jnp.int32),
        )

    reps = 16
    q_batches = [
        q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH] for r in range(reps)
    ]
    sync(q_batches[-1])
    fused, _ = one_call(q_batches[0])
    sync(fused.score)

    def window_calls():
        out = None
        for r in range(reps):
            out = one_call(q_batches[r])
        return out[0].score

    qps = median_qps(lambda: window_calls(), Q_BATCH * reps, reps=1)
    extras["hybrid_10m_ivf_qps"] = round(qps, 1)
    log(f"hybrid 10M int8 IVF-served (cluster-ordered store, "
        f"nprobe={cfg.ivf_nprobe}): {qps:.1f} qps")


def bench_microbatch_val(extras, N=10_200, D=1024, V_BITS=16, W=256, R=4):
    """Cross-request micro-batching at its WIN shape (the val-set-size
    corpus the reference deployment serves): R concurrent same-route
    hybrid requests in one vmapped search_many_device dispatch vs R
    sequential search_device calls.  The 1.5M hybrid section measures
    the same ratio at scale, where batching loses (one request already
    saturates HBM) — serving/batcher.py gates on the measured break-even
    (~100k rows, DESIGN.md)."""
    import functools

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.schema import CorpusIndex, SparseIndex
    from rag_challenge_2_tpu.retrieval.engine import (
        SearchConfig, search_device, search_many_device,
    )

    N_DOCS, Q_BATCH, T = 6, 8, 64
    key = jax.random.PRNGKey(1)
    kq, ke, kc, kt, kqt = jax.random.split(key, 5)

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen(k, n):
        e = jax.random.normal(k, (n, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    emb = gen(ke, N).astype(jnp.bfloat16)
    V = 1 << V_BITS
    rng = np.random.default_rng(3)
    counts = rng.integers(1, W + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    sparse = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=jax.random.randint(kc, (nnz,), 0, N, jnp.int32),
        tf=jax.random.randint(kt, (nnz,), 1, 5, jnp.int32).astype(jnp.float32),
        df=jnp.asarray(counts, jnp.float32),
        chunk_len=jnp.full((N,), 300.0, jnp.float32),
        avgdl=jnp.float32(300.0),
        dl=jnp.full((nnz,), 300.0, jnp.float32),
        vocab_bits=V_BITS, max_postings=W,
    )
    rows = jnp.arange(N, dtype=jnp.int32)
    per_doc = N // N_DOCS
    doc_id = rows // per_doc
    idx = CorpusIndex(
        emb=emb, doc_id=doc_id, page=rows % 500 + 1,
        year=2020 + doc_id, company_id=jnp.zeros((N,), jnp.int32),
        kind=jnp.zeros((N,), jnp.int32), page_seg=rows // 4,
        chunk_in_doc=rows % per_doc, valid=jnp.ones((N,), bool),
        sparse=sparse, n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    doc_masks = jnp.stack([doc_id == d for d in range(N_DOCS)])
    doc_valid = jnp.asarray([True, True, True, False, False, False])
    row_slot = jnp.where(doc_id < 3, doc_id, N_DOCS).astype(jnp.int32)
    ws = jnp.arange(N_DOCS, dtype=jnp.int32) * per_doc
    wl = jnp.full((N_DOCS,), per_doc, jnp.int32)
    q = gen(kq, Q_BATCH).astype(jnp.bfloat16)
    qv = jnp.ones((Q_BATCH,), bool)
    qt = jax.random.randint(kqt, (Q_BATCH, T), 0, V, jnp.int32)
    cfg = SearchConfig(method="basic", top_k=30, max_queries=Q_BATCH,
                       max_docs=N_DOCS, top_n=30, use_bm25=True, bm25_top_k=30)

    def one():
        c, _ = search_device(idx, q, qv, doc_masks, doc_valid, cfg, qt,
                             None, row_slot, ws, wl, window=per_doc)
        return c

    qm = jnp.broadcast_to(q, (R,) + q.shape)
    qvm = jnp.broadcast_to(qv, (R,) + qv.shape)
    qtm = jnp.broadcast_to(qt, (R,) + qt.shape)

    def many():
        return search_many_device(idx, qm, qvm, doc_masks, doc_valid, cfg,
                                  qtm, None, row_slot, ws, wl,
                                  window=per_doc, with_terms=True)

    sync(one().score)
    sync(many().score)
    reps = 40
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(R):
            out = one()
    sync(out.score)
    seq_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        outm = many()
    sync(outm.score)
    mb_s = (time.perf_counter() - t0) / reps
    extras["microbatch_val_speedup"] = round(seq_s / mb_s, 2)
    extras["microbatch_val_qps"] = round(R * Q_BATCH / mb_s, 1)
    log(f"micro-batch at val shape ({N} rows, R={R}): sequential "
        f"{seq_s * 1e3:.1f} ms vs batched {mb_s * 1e3:.1f} ms -> "
        f"{seq_s / mb_s:.2f}x")


def bench_traversal(extras):
    """Graph-traversal methods at the val-set shape: batched on-device hop
    loops (retrieval/traversal.py) vs the reference's sequential per-hop
    faiss search+reconstruct (reference src/retrieval.py:585-806),
    reproduced faithfully as a numpy loop."""
    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.schema import CorpusIndex
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig, search_device

    rng = np.random.default_rng(0)
    N_DOCS, CPD, D, NQ = 6, 1700, 1024, 127
    N = N_DOCS * CPD
    MAX_HOPS, NEIGHBOR_K = 4, 30
    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    doc_of_row = np.repeat(np.arange(N_DOCS), CPD)
    q = rng.normal(size=(NQ, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_year = rng.integers(0, N_DOCS, size=NQ)

    def cpu_ssg_one(qv, rows):
        sub = emb[rows]
        path = [int(np.argmax(sub @ qv))]
        # first hop exempt from the early-stop bar, matching the engine's
        # documented deviation from the reference (traversal.py)
        cur, prev = path[0], -np.inf
        for _ in range(MAX_HOPS):
            s = sub @ sub[cur]                      # reconstruct + search
            cand = [c for c in np.argsort(-s)[: NEIGHBOR_K + 1] if c not in path]
            if not cand:
                break
            best = max(cand, key=lambda c: s[c])
            if s[best] <= prev:
                break
            prev, cur = float(s[best]), int(best)
            path.append(cur)
        return path

    t0 = time.perf_counter()
    for i in range(NQ):
        for d in (q_year[i] - 1, q_year[i], q_year[i] + 1):
            if 0 <= d < N_DOCS:
                cpu_ssg_one(q[i], np.nonzero(doc_of_row == d)[0])
    cpu_qps = NQ / (time.perf_counter() - t0)
    extras["traversal_cpu_ssg_qps"] = round(cpu_qps, 1)
    log(f"cpu sequential ssg: {cpu_qps:.1f} qps")

    rows_j = jnp.arange(N, dtype=jnp.int32)
    doc_id = jnp.asarray(doc_of_row.astype(np.int32))
    idx = CorpusIndex(
        emb=jnp.asarray(emb), doc_id=doc_id, page=rows_j % 100 + 1,
        year=2020 + doc_id, company_id=jnp.zeros((N,), jnp.int32),
        kind=jnp.zeros((N,), jnp.int32), page_seg=rows_j // 4,
        chunk_in_doc=rows_j % CPD, valid=jnp.ones((N,), bool),
        sparse=None, n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    Q_BATCH, M = 8, 6
    dm = jnp.asarray(np.stack([doc_of_row == d for d in range(N_DOCS)]))
    qv_valid = jnp.ones((Q_BATCH,), bool)
    dv = jnp.ones((M,), bool)
    # doc-windowed traversal (docs are contiguous row ranges here, as in
    # every index/build corpus): hops scan ~CPD rows instead of N
    ws = jnp.arange(N_DOCS, dtype=jnp.int32) * CPD
    wl = jnp.full((N_DOCS,), CPD, jnp.int32)
    window = -(-CPD // 128) * 128
    reps = 16
    batches = [
        jnp.asarray(q[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH])
        for r in range(reps)
    ]
    sync(batches[-1])
    for method in ("ssg", "hybrid_expansion"):
        cfg = SearchConfig(
            method=method, top_k=50 if method == "hybrid_expansion" else 30,
            max_queries=Q_BATCH, max_docs=M, top_n=30,
            max_hops=MAX_HOPS, neighbor_k=NEIGHBOR_K,
        )
        out, _ = search_device(idx, batches[0], qv_valid, dm, dv, cfg,
                               win_start=ws, win_len=wl, window=window)
        sync(out.score)

        def run_window():
            o = None
            for r in range(reps):
                o, _ = search_device(idx, batches[r], qv_valid, dm, dv, cfg,
                                     win_start=ws, win_len=wl, window=window)
            return o.score

        qps = median_qps(lambda: run_window(), Q_BATCH * reps, reps=1)
        extras[f"traversal_{method}_qps"] = round(qps, 1)
        log(f"device {method}: {qps:.1f} qps ({qps / cpu_qps:.0f}x cpu ssg; "
            f"hybrid runs 30 traversals per (q,doc) pair — the cpu loop "
            f"equivalent is ~{cpu_qps / 30:.0f} qps)")


def bench_traversal_1m(extras, N_DOCS=6, CPD=170_000, D=1024):
    """Graph traversal at 1M+ rows (config-3/5 scale): the doc-windowed
    hop path's [M, W, D] slices approach the TRAVERSAL_WINDOW_COPY_CAP
    budget here — above it the engine falls back to the masked
    full-corpus traverse (engine.search_device), so this line witnesses
    traversal at scale WITHOUT corpus duplication in HBM."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.schema import CorpusIndex
    from rag_challenge_2_tpu.retrieval.engine import (
        TRAVERSAL_WINDOW_COPY_CAP, SearchConfig, search_device,
    )

    N = N_DOCS * CPD
    Q_BATCH, M, NQ = 8, 3, 127
    key = jax.random.PRNGKey(11)

    @jax.jit
    def gen(key):
        e = jax.random.normal(key, (N, D), jnp.float32)
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    emb = gen(key)
    rows = jnp.arange(N, dtype=jnp.int32)
    doc_id = (rows // CPD).astype(jnp.int32)
    idx = CorpusIndex(
        emb=emb, doc_id=doc_id, page=rows % 500 + 1, year=2020 + doc_id,
        company_id=jnp.zeros((N,), jnp.int32), kind=jnp.zeros((N,), jnp.int32),
        page_seg=rows // 4, chunk_in_doc=rows % CPD,
        valid=jnp.ones((N,), bool), sparse=None,
        n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    dm = jnp.stack([doc_id == d for d in range(M)])
    dv = jnp.ones((M,), bool)
    qk = jax.random.fold_in(key, 1)
    q_all = jax.random.normal(qk, (NQ, D), jnp.float32)
    q_all = q_all / jnp.linalg.norm(q_all, axis=1, keepdims=True)
    q_valid = jnp.ones((Q_BATCH,), bool)
    ws = jnp.arange(M, dtype=jnp.int32) * CPD
    wl = jnp.full((M,), CPD, jnp.int32)
    window = -(-CPD // 128) * 128
    windowed = M * window * D * 4 <= TRAVERSAL_WINDOW_COPY_CAP
    reps = 8
    batches = [q_all[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH] for r in range(reps)]
    sync(batches[-1])
    for method in ("ssg", "hybrid_expansion"):
        cfg = SearchConfig(
            method=method, top_k=50 if method == "hybrid_expansion" else 30,
            max_queries=Q_BATCH, max_docs=M, top_n=30,
            max_hops=4, neighbor_k=30,
        )
        # two tiers, same honesty contract as the 10M scan ladder: exact
        # hops (the parity-tested path — the per-hop W-wide sort caps it),
        # and the rt=0.95 served tier (hop candidates via the fused
        # PartialReduce, traversal.HOP_APPROX_MIN_COLS) with the fused
        # top-30 overlap vs exact recorded alongside
        exact_keys = None
        for rt, tag in ((None, "_exact"), (0.95, "")):
            cfg_t = dataclasses.replace(cfg, scan_rt=rt)
            out, _ = search_device(idx, batches[0], q_valid, dm, dv, cfg_t,
                                   win_start=ws, win_len=wl, window=window)
            sync(out.score)
            keys0 = np.asarray(out.key)
            if rt is None:
                exact_keys = set(keys0[keys0 >= 0].tolist())
            else:
                got = set(keys0[keys0 >= 0].tolist())
                ov = len(got & exact_keys) / max(len(exact_keys), 1)
                extras[f"traversal_1m_{method}_rt95_overlap"] = round(ov, 4)

            def run(cfg_t=cfg_t):
                o = None
                for r in range(reps):
                    o, _ = search_device(idx, batches[r], q_valid, dm, dv,
                                         cfg_t, win_start=ws, win_len=wl,
                                         window=window)
                return o.score

            qps = median_qps(lambda: run(), Q_BATCH * reps, reps=1)
            extras[f"traversal_1m_{method}{tag}_qps"] = round(qps, 1)
            log(f"device {method} at {N} rows "
                f"({'windowed' if windowed else 'masked full-corpus'}, "
                f"{'exact hops' if rt is None else 'rt=0.95 hops'}): "
                f"{qps:.1f} qps"
                + ("" if rt is None else
                   f", fused top-30 overlap vs exact = "
                   f"{extras[f'traversal_1m_{method}_rt95_overlap']:.4f}"))

    # free the 4.2 GB corpus eagerly — the 10M traversal section follows
    # in the same process and needs the HBM headroom
    import gc

    del idx, emb, dm, batches, out
    gc.collect()


def bench_traversal_10m(extras, N_DOCS=5, D=1024, C=500_000):
    """Graph traversal at the FULL 10M-row target (config-5 scale) on one
    chip: int8 row store (10.2 GB — f32 cannot even load), per-slot
    sequential doc windows (engine TRAVERSAL_WINDOW_COPY_CAP: one
    transient [1, W, D] int8 window ≈ 1.7 GB alive at a time), and
    rt=0.95 hop candidates (traversal.HOP_APPROX_MIN_COLS — the W-wide
    per-hop sort is the cost ceiling at this width).  Parity bookkeeping:
    SSG also runs one exact-hop batch and the fused top-30 overlap vs it
    is recorded (hybrid's exact tier at 10M takes minutes per batch; its
    hop-approx recall is witnessed by traversal_1m_*_rt95_overlap)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.schema import CorpusIndex
    from rag_challenge_2_tpu.ops.quant import quantize_rows
    from rag_challenge_2_tpu.retrieval.engine import SearchConfig, search_device

    N = 20 * C                   # 5 docs x 2M rows at the default C=500k
    CPD = N // N_DOCS
    Q_BATCH, M, NQ = 8, 3, 127
    N_CENTERS = 4096
    key = jax.random.PRNGKey(0)
    centers = jax.random.normal(key, (N_CENTERS, D), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def gen_chunk(buf, scales, centers, i):
        k = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ka, kn = jax.random.split(k)
        a = jax.random.randint(ka, (C,), 0, N_CENTERS)
        e = centers[a] + (0.35 / jnp.sqrt(D)) * jax.random.normal(
            kn, (C, D), jnp.float32)
        e = e / jnp.linalg.norm(e, axis=1, keepdims=True)
        q8, sc = quantize_rows(e)
        buf = jax.lax.dynamic_update_slice(buf, q8, (i * C, jnp.int32(0)))
        scales = jax.lax.dynamic_update_slice(scales, sc, (i * C,))
        return buf, scales, e

    buf = jnp.zeros((N, D), jnp.int8)
    scales = jnp.zeros((N,), jnp.float32)
    q_all = None
    t0 = time.perf_counter()
    for i in range(N // C):
        buf, scales, e = gen_chunk(buf, scales, centers, jnp.int32(i))
        if i == 0:
            kr, kn2 = jax.random.split(jax.random.fold_in(key, 9))
            r = jax.random.randint(kr, (NQ,), 0, C)
            q_all = e[r] + (0.25 / jnp.sqrt(D)) * jax.random.normal(
                kn2, (NQ, D), jnp.float32)
            q_all = q_all / jnp.linalg.norm(q_all, axis=1, keepdims=True)
        del e
    sync(buf)
    log(f"traversal 10M int8 gen: {time.perf_counter() - t0:.1f}s")

    rows = jnp.arange(N, dtype=jnp.int32)
    doc_id = (rows // CPD).astype(jnp.int32)
    idx = CorpusIndex(
        emb=buf, emb_scale=scales, doc_id=doc_id, page=rows % 500 + 1,
        year=2020 + doc_id, company_id=jnp.zeros((N,), jnp.int32),
        kind=jnp.zeros((N,), jnp.int32), page_seg=rows // 4,
        chunk_in_doc=rows % CPD, valid=jnp.ones((N,), bool), sparse=None,
        n_chunks=N, n_pages=N // 4, n_docs=N_DOCS, dim=D,
    )
    dm = jnp.stack([doc_id == d for d in range(M)])
    dv = jnp.ones((M,), bool)
    q_valid = jnp.ones((Q_BATCH,), bool)
    ws = jnp.arange(M, dtype=jnp.int32) * CPD
    wl = jnp.full((M,), CPD, jnp.int32)
    window = -(-CPD // 128) * 128
    reps = 4
    batches = [q_all[(r * Q_BATCH) % (NQ - Q_BATCH):][:Q_BATCH]
               for r in range(reps)]
    sync(batches[-1])

    exact_keys = None
    for method, with_exact in (("ssg", True), ("hybrid_expansion", False)):
        cfg = SearchConfig(
            method=method, top_k=50 if method == "hybrid_expansion" else 30,
            max_queries=Q_BATCH, max_docs=M, top_n=30,
            max_hops=4, neighbor_k=30, scan_rt=0.95,
        )
        if with_exact:
            cfg_e = dataclasses.replace(cfg, scan_rt=None)
            out_e, _ = search_device(idx, batches[0], q_valid, dm, dv, cfg_e,
                                     win_start=ws, win_len=wl, window=window)
            sync(out_e.score)
            ke = np.asarray(out_e.key)
            exact_keys = set(ke[ke >= 0].tolist())
        out, _ = search_device(idx, batches[0], q_valid, dm, dv, cfg,
                               win_start=ws, win_len=wl, window=window)
        sync(out.score)
        if with_exact:
            k0 = np.asarray(out.key)
            got = set(k0[k0 >= 0].tolist())
            ov = len(got & exact_keys) / max(len(exact_keys), 1)
            extras[f"traversal_10m_{method}_rt95_overlap"] = round(ov, 4)

        def run(cfg=cfg):
            o = None
            for r in range(reps):
                o, _ = search_device(idx, batches[r], q_valid, dm, dv, cfg,
                                     win_start=ws, win_len=wl, window=window)
            return o.score

        qps = median_qps(lambda: run(), Q_BATCH * reps, reps=1)
        extras[f"traversal_10m_{method}_qps"] = round(qps, 1)
        log(f"device {method} at {N} rows (int8 per-slot windows, rt=0.95 "
            f"hops): {qps:.1f} qps"
            + (f", fused top-30 overlap vs exact hops = "
               f"{extras[f'traversal_10m_{method}_rt95_overlap']:.4f}"
               if with_exact else ""))


def bench_hybrid_quality(extras):
    """Config-2/4 PRODUCT quality: the served dense+BM25 fusion scored on
    the config-4 quality eval (eval/encoder_quality.eval_hybrid — the one
    eval where quality was previously unrecorded).

    Trains the default label-free recipe for RAGTPU_HYBRID_QUALITY_STEPS
    (default 1500; earlier encoder-quality runs recorded the full 5k/15k
    arms) and reports bm25 / dense / hybrid hit@10 side by side —
    ``hybrid_quality_hit10`` is the SHIPPED sum-fusion preset
    (fuse_mode="sum", dense_weight=0.5 — scripts/fusion_sweep.py winner),
    ``hybrid_parity_hit10`` the reference-parity max rule.
    """
    import os

    from rag_challenge_2_tpu.eval.encoder_quality import (
        build_dataset, eval_bm25, eval_dense, eval_hybrid)
    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.pretrain import (
        PretrainConfig, pretrain_encoder)

    steps = int(os.environ.get("RAGTPU_HYBRID_QUALITY_STEPS", "1500"))
    ds = build_dataset(seed=0)
    cfg = EncoderConfig(max_len=96)
    bm = eval_bm25(ds)
    extras["bm25_quality_hit10"] = bm["hit@10"]
    t0 = time.perf_counter()
    model, _ = pretrain_encoder(
        ds.chunk_texts, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=steps, batch_size=64, seed=0),
    )
    extras["hybrid_quality_train_s"] = round(time.perf_counter() - t0, 1)
    dense = eval_dense(model.embed, ds)
    extras["dense_quality_hit10"] = dense["hit@10"]
    hyb = eval_hybrid(model.embed, ds)   # shipped preset: sum + 0.5
    extras["hybrid_quality_hit10"] = hyb["hit@10"]
    extras["hybrid_quality_mrr30"] = hyb["mrr"]
    extras["hybrid_quality_steps"] = steps
    par = eval_hybrid(model.embed, ds, fuse_mode="max", dense_weight=1.0)
    extras["hybrid_parity_hit10"] = par["hit@10"]
    extras["hybrid_parity_mrr30"] = par["mrr"]
    log(f"quality (steps={steps}): bm25 {bm['hit@10']} / dense "
        f"{dense['hit@10']} / SERVED HYBRID (sum-fusion) {hyb['hit@10']} "
        f"hit@10, mrr@30 {hyb['mrr']} / parity-max {par['hit@10']} "
        f"(bm25 full-rank mrr {bm['mrr']})")

    # the NON-template-shaped arm: an encoder pretrained
    # on the e2e fixture's annual-report prose, scored on its 17 golden
    # questions through the ROUTED hybrid graph (eval_hybrid_e2e)
    from rag_challenge_2_tpu.eval.e2e import fixture_docs
    from rag_challenge_2_tpu.eval.encoder_quality import eval_hybrid_e2e

    fixture_chunks = []
    for doc in fixture_docs():
        for page in doc["pages"]:
            text = page if isinstance(page, str) else (
                page["text"] + "\n"
                + "\n".join(" ".join(row) for row in page.get("table", [])))
            fixture_chunks.extend(p.strip() for p in text.split("\n")
                                  if p.strip())
    m_fx, _ = pretrain_encoder(
        fixture_chunks, enc_cfg=cfg,
        pre_cfg=PretrainConfig(steps=min(steps, 1500), batch_size=64,
                               seed=0),
    )
    fx = eval_hybrid_e2e(m_fx.embed)     # shipped sum-fusion preset
    fx_par = eval_hybrid_e2e(m_fx.embed, fuse_mode="max", dense_weight=1.0)
    extras["e2e_fixture_hybrid_hit10"] = fx["hit@10"]
    extras["e2e_fixture_parity_hit10"] = fx_par["hit@10"]
    log(f"e2e-fixture serving quality (routed, prose corpus): "
        f"sum-fusion {fx['hit@10']} / parity-max {fx_par['hit@10']} hit@10")


def bench_e2e(extras):
    """Full-pipeline answer quality over the real-prose PDF fixture
    (eval/e2e.py): parse(minipdf) → merge → chunk → encode → index →
    year-routed hybrid retrieval → two-stage answering (deterministic
    extractive answerer) → competition scorer.  The reference's analogous
    check is its 127-question judged benchmark
    (reference src/api_requests.py:697-750)."""
    import tempfile
    from pathlib import Path

    from rag_challenge_2_tpu.eval.e2e import run_e2e

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = run_e2e(Path(d), pretrain_steps=0)
    extras["e2e_value_accuracy"] = res["value_accuracy"]
    extras["e2e_page_hit"] = res["page_hit"]
    extras["e2e_questions"] = res["n"]
    extras["e2e_run_s"] = round(time.perf_counter() - t0, 1)
    log(f"e2e fixture: value accuracy {res['value_accuracy']} / page hit "
        f"{res['page_hit']} over {res['n']} questions "
        f"({extras['e2e_run_s']}s)")


def bench_qa_warm(extras):
    """Driver-witnessed warm serving latency: the FULL QA path — query
    expansion, hybrid dense+BM25 search, fusion, materialisation, page
    selection, two-stage answering, reference extraction — per question at
    the val-set corpus shape, LLM calls stubbed so the number isolates the
    framework (the reference measures 3-5 s end-to-end on its production
    server, README.md:310-312, most of it API-bound; its non-LLM pipeline
    work is the part this path replaces)."""
    import json as _json

    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.llm.facade import LLMFacade
    from rag_challenge_2_tpu.llm.providers import StubProvider
    from rag_challenge_2_tpu.qa.processor import QAConfig, QuestionsProcessor
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine

    rng = np.random.default_rng(5)
    N_DOCS, CPD, D = 6, 1700, 1024
    reports, embs = [], []
    for d in range(N_DOCS):
        chunks = [
            {"page": c // 20 + 1,
             "text": f"金盘科技{2020 + d}年报 营业收入 毛利率 干式变压器 第{c}段 数据{c % 97}",
             "id": c, "type": "content"}
            for c in range(CPD)
        ]
        pages = [
            {"page": p + 1, "text": f"{2020 + d}年第{p + 1}页"}
            for p in range(CPD // 20 + 1)
        ]
        reports.append({
            "metainfo": {"sha1_name": f"J{2020 + d}_jinpan",
                         "company_name": "金盘科技", "year": 2020 + d},
            "content": {"pages": pages, "chunks": chunks},
        })
        e = rng.normal(size=(CPD, D)).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        embs.append(e)
    idx, meta = build_corpus_index(reports, embs, vocab_bits=18)
    eng = QueryEngine(idx, meta)
    flat = np.concatenate(embs)

    def embedder(texts):
        out = np.zeros((len(texts), D), np.float32)
        for i, t in enumerate(texts):
            out[i] = flat[abs(hash(t)) % flat.shape[0]]
        return out

    script = {
        "候选页面": _json.dumps(
            {"selected_pages": [1, 2], "reasoning": "相关"}, ensure_ascii=False),
        "上下文": _json.dumps({
            "step_by_step_analysis": "步骤" * 20, "reasoning_summary": "总结",
            "relevant_pages": [1], "final_answer": 68.9,
        }, ensure_ascii=False),
    }
    proc = QuestionsProcessor(
        eng, embedder, LLMFacade(StubProvider(script)), None,
        QAConfig(use_bm25=True, return_parent_pages=False),
    )
    questions = [
        f"金盘科技{2020 + (i % 6)}年{t}是多少？"
        for i, t in enumerate(
            ["营业收入", "毛利率", "研发费用", "净利润", "出口占比",
             "新签订单", "资产负债率", "经营现金流"] * 5
        )
    ]
    for q in questions[:3]:  # compile + settle every jit signature
        proc.get_answer_for_company("金盘科技", q, "number")
    lat = []
    for q in questions:
        t0 = time.perf_counter()
        out = proc.get_answer_for_company("金盘科技", q, "number")
        lat.append((time.perf_counter() - t0) * 1000)
        assert out["final_answer"] == 68.9
    lat.sort()
    extras["qa_warm_ms_p50"] = round(lat[len(lat) // 2], 1)
    extras["qa_warm_ms_p95"] = round(lat[int(len(lat) * 0.95)], 1)
    log(f"warm QA end-to-end ({len(lat)} questions, stub LLM, hybrid search): "
        f"p50={extras['qa_warm_ms_p50']} ms p95={extras['qa_warm_ms_p95']} ms "
        f"(reference end-to-end: 3000-5000 ms, API-bound)")


def bench_encoder(extras):
    """BASELINE config 4 witness: on-device corpus-embedding throughput of
    the production-size encoder (the reference rents this from the Qwen
    embedding API, src/api_requests.py:55-127)."""
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel, EncoderConfig

    model = EmbeddingModel(EncoderConfig())
    texts = [
        f"金盘科技2024年第{i}季度营业收入与毛利率分析，干式变压器产品出口占比{i%40}％，"
        f"研发费用同比增长情况及储能业务新签订单金额说明。" for i in range(2048)
    ]
    t0 = time.perf_counter()
    model.embed(texts[:512])  # compile + settle
    log(f"encoder compile+first batch: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out = model.embed(texts)
    dt = time.perf_counter() - t0
    assert out.shape[0] == len(texts)
    extras["encoder_chunks_per_s"] = round(len(texts) / dt, 1)
    log(f"encoder throughput: {extras['encoder_chunks_per_s']} chunks/s")


def main():
    global T_MAIN_START
    T_MAIN_START = time.perf_counter()
    from rag_challenge_2_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from rag_challenge_2_tpu.ops.topk import dense_topk

    rng = np.random.default_rng(0)
    N_DOCS, CHUNKS_PER_DOC, D, NQ, K = 6, 1700, 1024, 127, 10
    N = N_DOCS * CHUNKS_PER_DOC
    years = [2020 + i for i in range(N_DOCS)]

    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    doc_of_row = np.repeat(np.arange(N_DOCS), CHUNKS_PER_DOC)

    # 127 queries; each routed to a year window like the reference's
    # extract_years_from_question (year ±1 → up to 3 docs)
    q = rng.normal(size=(NQ, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_year = rng.integers(0, N_DOCS, size=NQ)
    masks = np.zeros((NQ, N), bool)
    for i in range(NQ):
        sel = np.isin(doc_of_row, [q_year[i] - 1, q_year[i], q_year[i] + 1])
        masks[i] = sel

    # ---- baseline: CPU exact (the reference's FAISS-flat equivalent) ----
    def cpu_exact():
        scores = q @ emb.T
        scores[~masks] = -np.inf
        idx = np.argpartition(-scores, K, axis=1)[:, :K]
        vals = np.take_along_axis(scores, idx, axis=1)
        order = np.argsort(-vals, axis=1)
        return np.take_along_axis(idx, order, axis=1)

    t0 = time.perf_counter()
    oracle_idx = cpu_exact()
    cpu_reps = max(1, int(1.0 / max(time.perf_counter() - t0, 1e-3)))
    t0 = time.perf_counter()
    for _ in range(cpu_reps):
        cpu_exact()
    cpu_qps = NQ * cpu_reps / (time.perf_counter() - t0)
    log(f"baseline cpu exact: {cpu_qps:.1f} qps")

    # ---- ours: on-device masked exact top-k ----
    jq = jnp.asarray(q)
    jemb = jnp.asarray(emb)
    jmask = jnp.asarray(masks)

    def device_exact():
        return dense_topk(jq, jemb, K, mask=jmask, impl="xla")

    vals, idx = device_exact()
    sync(vals)  # compile + settle
    dev_qps = median_qps(device_exact, NQ, reps=50)

    got = np.asarray(idx)
    recall = np.mean([
        len(set(got[i]) & set(oracle_idx[i])) / K for i in range(NQ)
    ])
    log(f"device exact: {dev_qps:.1f} qps, recall@{K} vs oracle = {recall:.4f}")

    # secondary metrics
    extras = {}

    # bf16 fast mode (one bf16 pass): the serving configuration for corpora
    # where exact f32 parity is not required (recall vs exact ≈ 0.99)
    try:
        emb16 = jemb.astype(jnp.bfloat16)
        q16 = jq.astype(jnp.bfloat16)

        def fast():
            return dense_topk(q16, emb16, K, mask=jmask, impl="xla")

        fv, fi = fast()
        sync(fv)
        extras["bf16_fast_qps"] = round(median_qps(fast, NQ, reps=50), 1)
        got16 = np.asarray(fi)
        extras["bf16_recall_at_10"] = round(float(np.mean([
            len(set(got16[i]) & set(oracle_idx[i])) / K for i in range(NQ)
        ])), 4)
        log(f"bf16 fast: {extras['bf16_fast_qps']} qps, recall {extras['bf16_recall_at_10']}")
    except Exception as e:  # pragma: no cover
        log(f"bf16 path skipped: {e}")

    import os

    # (name, fn, estimated wall seconds).  The estimates are a budget
    # guard, not measurements: the check below skips a section when
    # elapsed + estimate would exceed RAGTPU_BENCH_BUDGET_S, so one slow
    # build cannot forfeit every section after it.
    sections = [
        ("hybrid_quality", bench_hybrid_quality, 380),
        ("e2e", bench_e2e, 90),
        ("int8_residual_10m", bench_int8_residual_10m, 260),
        ("microbatch_val", bench_microbatch_val, 30),
        ("qa_warm", bench_qa_warm, 60),
        ("encoder", bench_encoder, 40),
        ("traversal", bench_traversal, 60),
        ("ivf_1m", bench_ivf_1m, 200),
        ("int8_10m", bench_int8_10m, 160),
        ("ivf_10m", bench_ivf_10m, 320),
        ("hybrid", bench_hybrid_at_scale, 90),
        ("traversal_1m", bench_traversal_1m, 130),
        ("traversal_10m", bench_traversal_10m, 130),
    ]
    budget_s = float(os.environ.get("RAGTPU_BENCH_BUDGET_S", "1500"))

    def emit():
        # The headline contract: ONE parseable JSON line.  Printed after
        # the val-shape section and re-printed (enriched) after every
        # completed section, so a driver timeout mid-run still leaves the
        # latest complete snapshot as the last JSON line in the tail.
        print(json.dumps({
            "metric": "exact_flat_query_qps_valset_shape",
            "value": round(dev_qps, 1),
            "unit": "queries/s (6x1700 docs, 1024d, top-10, year-routed, "
                    "recall@10=%.3f)" % recall,
            "vs_baseline": round(dev_qps / cpu_qps, 2),
            "baseline_cpu_qps": round(cpu_qps, 1),
            "recall_at_10": round(float(recall), 4),
            **extras,
        }), flush=True)

    emit()

    for name, fn, est_s in sections:
        if os.environ.get(f"RAGTPU_BENCH_{name.upper()}", "1") == "0":
            log(f"{name} section skipped by env")
            continue
        elapsed = time.perf_counter() - T_MAIN_START
        if elapsed + est_s > budget_s:
            log(f"{name} section skipped: elapsed {elapsed:.0f}s + "
                f"estimate {est_s}s exceeds budget {budget_s:.0f}s "
                f"(raise RAGTPU_BENCH_BUDGET_S to include it)")
            extras[f"skipped_{name}"] = 1
            continue
        try:
            fn(extras)
        except Exception as e:  # pragma: no cover — headline must print
            log(f"{name} section failed: {type(e).__name__}: {e}")
        emit()


if __name__ == "__main__":
    main()

"""Host-side corpus index builder.

Consumes the reference's chunked-report JSON contract (one file per
document, ``{"metainfo": {sha1_name, company_name, year}, "content":
{"pages": [{page, text}], "chunks": [{page, text, id, type}]}}`` — produced
by reference src/text_splitter.py:33-60 and read back by reference
src/retrieval.py:488-541) plus an embedding matrix per document, and emits
one corpus-wide :class:`CorpusIndex`.

Embeddings can come from anywhere — the on-device encoder
(models/encoder.py), a cached .npy, or an external API client.  The builder
is pure numpy until the final device_put.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import tokenize as tok
from .schema import (
    KIND_CONTENT,
    KIND_SERIALIZED_TABLE,
    ROW_PAD,
    CorpusIndex,
    CorpusMeta,
    DocMeta,
    SparseIndex,
    _round_up,
)

_YEAR_IN_SHA1 = re.compile(r"[J]?(20\d{2})")


def infer_doc_year(metainfo: Dict) -> Optional[int]:
    """Year from metainfo, else from the sha1 name ("J2025" → 2025).

    Mirrors the fallback in reference src/retrieval.py:107-123.
    """
    year = metainfo.get("year")
    if year is not None:
        try:
            return int(year)
        except (TypeError, ValueError):
            pass
    m = _YEAR_IN_SHA1.search(metainfo.get("sha1_name", "") or "")
    return int(m.group(1)) if m else None


def load_chunked_reports(reports_dir: Path) -> List[Dict]:
    """Load every chunked-report JSON in a directory, sorted by filename."""
    reports = []
    for p in sorted(Path(reports_dir).glob("*.json")):
        with open(p, "r", encoding="utf-8") as f:
            reports.append(json.load(f))
    return reports


# Default posting-list cap.  The device kernel gathers a static
# [B, T, window] block per query batch with window = longest posting list;
# CJK unigrams ("的", "年") have df approaching the corpus size, so an
# uncapped index at 1M chunks makes that gather ~64×1M rows per batch —
# OOM/stall.  Terms that long carry near-zero idf anyway: capping keeps
# the top-tf postings per term, leaves df (hence idf) exact, and bounds
# kernel memory to B·T·4096.  Measured recall impact
# (tests/test_bm25.py::test_capped_recall_vs_uncapped): even with a cap at
# 16% of the corpus, self-retrieval stays at rank ≤3 and top-10 churn is
# confined to near-zero-idf ties; at 4096 (≫ df of any discriminative
# term) the effect is nil.
DEFAULT_MAX_POSTINGS_PER_TERM = 4096


def _cap_postings(
    indptr: np.ndarray, chunk_ids: np.ndarray, tf: np.ndarray, cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncate every posting list to its ``cap`` highest-tf entries.

    df is computed by the caller BEFORE capping, so idf stays exact — the
    cap only bounds the device gather window.
    """
    counts = np.diff(indptr)
    oversized = np.nonzero(counts > cap)[0]
    if len(oversized) == 0:
        return indptr, chunk_ids, tf
    keep = np.ones(int(indptr[-1]), bool)
    for t in oversized:
        s, e = int(indptr[t]), int(indptr[t + 1])
        seg = tf[s:e]
        drop = np.argpartition(seg, len(seg) - cap)[: len(seg) - cap]
        keep[s + drop] = False
    new_counts = np.minimum(counts, cap)
    new_indptr = np.zeros_like(indptr)
    np.cumsum(new_counts, out=new_indptr[1:])
    return new_indptr, chunk_ids[keep], tf[keep]


def _build_sparse(
    chunk_texts: Sequence[str],
    n_pad: int,
    vocab_bits: int,
    max_postings_per_term: Optional[int] = DEFAULT_MAX_POSTINGS_PER_TERM,
) -> SparseIndex:
    """Term-major CSR over the whole corpus.

    Replaces the per-document pickled BM25Okapi objects
    (reference src/ingestion.py:19-22).  Posting lists are capped by default
    (``max_postings_per_term``, pass ``None`` for uncapped) — see
    :data:`DEFAULT_MAX_POSTINGS_PER_TERM`.
    """
    V = 1 << vocab_bits
    n = len(chunk_texts)

    # native C++ builder (native/csr_builder.cpp) — same tokenizer and
    # hash, ~2 orders faster at million-chunk scale; falls back to the
    # Python path when no C++ compiler is available
    from ..utils.native import build_csr_native

    nat = build_csr_native(list(chunk_texts), vocab_bits)
    if nat is not None:
        indptr, chunk_ids_n, tf_n, df_n, chunk_len_n = nat
        df = np.asarray(df_n, np.float32)
        chunk_len = np.zeros((n_pad,), np.float32)
        chunk_len[:n] = chunk_len_n
        indptr = np.asarray(indptr, np.int64)
        chunk_ids_u = np.asarray(chunk_ids_n, np.int32)
        tf_u = np.asarray(tf_n, np.float32)
    else:
        # term -> list of (chunk, tf)
        tf_maps: List[Dict[int, int]] = []
        chunk_len = np.zeros((n_pad,), np.float32)
        df = np.zeros((V,), np.float32)
        for i, text in enumerate(chunk_texts):
            ids = tok.token_ids(text, vocab_bits)
            chunk_len[i] = len(ids)
            m: Dict[int, int] = {}
            for t in ids:
                m[t] = m.get(t, 0) + 1
            tf_maps.append(m)
            for t in m:
                df[t] += 1.0

        postings: Dict[int, List[Tuple[int, int]]] = {}
        for i, m in enumerate(tf_maps):
            for t, c in m.items():
                postings.setdefault(t, []).append((i, c))

        indptr = np.zeros((V + 1,), np.int64)
        for t, lst in postings.items():
            indptr[t + 1] = len(lst)
        np.cumsum(indptr, out=indptr)
        nnz0 = int(indptr[-1])
        chunk_ids_u = np.zeros((nnz0,), np.int32)
        tf_u = np.zeros((nnz0,), np.float32)
        for t, lst in postings.items():
            s = indptr[t]
            for j, (ci, c) in enumerate(lst):
                chunk_ids_u[s + j] = ci
                tf_u[s + j] = c

    if max_postings_per_term:
        indptr, chunk_ids_u, tf_u = _cap_postings(
            indptr, chunk_ids_u, tf_u, max_postings_per_term
        )

    nnz = int(indptr[-1])
    counts = np.diff(indptr)
    max_post = int(counts.max()) if len(counts) else 0
    # one sentinel posting when the corpus has none: the scorer clamps
    # gather positions into the buffer, so it must not be empty
    chunk_ids = np.full((max(nnz, 1),), n_pad - 1, np.int32)
    tf = np.zeros((max(nnz, 1),), np.float32)
    chunk_ids[:nnz] = chunk_ids_u
    tf[:nnz] = tf_u

    avgdl = float(chunk_len[:n].mean()) if n else 1.0
    # per-posting doc length (schema.SparseIndex.dl): one vectorized take
    # at build replaces a per-query random [N] gather at serve time
    dl = chunk_len[np.clip(chunk_ids, 0, n_pad - 1)].astype(np.float32)
    return SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=jnp.asarray(chunk_ids),
        tf=jnp.asarray(tf),
        df=jnp.asarray(df),
        chunk_len=jnp.asarray(chunk_len),
        avgdl=jnp.float32(avgdl),
        dl=jnp.asarray(dl),
        vocab_bits=vocab_bits,
        max_postings=max_post,
    )


def build_corpus_index(
    reports: Iterable[Dict],
    embeddings: Sequence[np.ndarray],
    *,
    dtype=jnp.float32,
    with_sparse: bool = True,
    vocab_bits: int = tok.DEFAULT_VOCAB_BITS,
    max_postings_per_term: Optional[int] = DEFAULT_MAX_POSTINGS_PER_TERM,
    device_put: bool = True,
) -> Tuple[CorpusIndex, CorpusMeta]:
    """Assemble one CorpusIndex + CorpusMeta from per-document inputs.

    ``embeddings[d]`` must be ``[n_chunks_d, D]`` float32, row i matching
    ``reports[d]["content"]["chunks"][i]`` (the FAISS row order of
    reference src/ingestion.py:79-84).
    """
    reports = list(reports)
    assert len(reports) == len(embeddings), "one embedding matrix per report"
    dim = int(embeddings[0].shape[1]) if embeddings else 0

    docs: List[DocMeta] = []
    companies: List[str] = []
    chunk_texts: List[str] = []
    page_texts: Dict[int, str] = {}
    page_seg_info: List[Tuple[int, int]] = []

    cols = {k: [] for k in ("doc_id", "page", "year", "company_id", "kind", "page_seg", "chunk_in_doc")}
    emb_rows: List[np.ndarray] = []
    page_seg_lookup: Dict[Tuple[int, int], int] = {}
    synthesized_segs: set = set()  # pages absent from pages[] (text built from chunks)

    for d, (rep, emb) in enumerate(zip(reports, embeddings)):
        mi = rep["metainfo"]
        company = mi.get("company_name", "") or ""
        if company not in companies:
            companies.append(company)
        cid = companies.index(company)
        year = infer_doc_year(mi)
        pages = rep["content"]["pages"]
        chunks = rep["content"]["chunks"]
        assert emb.shape[0] == len(chunks), (
            f"doc {mi.get('sha1_name')}: {emb.shape[0]} embeddings vs {len(chunks)} chunks"
        )
        for pg in pages:
            key = (d, int(pg["page"]))
            if key not in page_seg_lookup:
                page_seg_lookup[key] = len(page_seg_info)
                page_seg_info.append(key)
                page_texts[page_seg_lookup[key]] = pg.get("text", "")
        for i, ch in enumerate(chunks):
            pgno = int(ch["page"])
            seg = page_seg_lookup.setdefault((d, pgno), len(page_seg_info))
            if seg == len(page_seg_info):  # chunk on a page missing from pages[]
                page_seg_info.append((d, pgno))
                page_texts[seg] = ch.get("text", "")
                synthesized_segs.add(seg)
            elif seg in synthesized_segs:
                # later chunks of a synthesized page extend its text —
                # keeping only chunk 0 silently truncates the parent-page
                # context handed to answering
                t = ch.get("text", "")
                if t:
                    page_texts[seg] = (
                        page_texts[seg] + "\n" + t if page_texts[seg] else t
                    )
            cols["doc_id"].append(d)
            cols["page"].append(pgno)
            cols["year"].append(year if year is not None else -1)
            cols["company_id"].append(cid)
            cols["kind"].append(
                KIND_SERIALIZED_TABLE if ch.get("type") == "serialized_table" else KIND_CONTENT
            )
            cols["page_seg"].append(seg)
            cols["chunk_in_doc"].append(i)
            chunk_texts.append(ch.get("text", ""))
            emb_rows.append(np.asarray(emb[i], np.float32))
        docs.append(DocMeta(mi.get("sha1_name", f"doc{d}"), company, year, len(chunks), len(pages)))

    n = len(emb_rows)
    n_pad = max(_round_up(max(n, 1), ROW_PAD), ROW_PAD)
    E = np.zeros((n_pad, dim), np.float32)
    if n:
        E[:n] = np.stack(emb_rows)

    def col(name: str, fill: int) -> np.ndarray:
        a = np.full((n_pad,), fill, np.int32)
        a[:n] = np.asarray(cols[name], np.int32)
        return a

    sparse = (
        _build_sparse(chunk_texts, n_pad, vocab_bits, max_postings_per_term)
        if with_sparse
        else None
    )

    valid = np.zeros((n_pad,), bool)
    valid[:n] = True
    idx = CorpusIndex(
        emb=jnp.asarray(E, dtype),
        doc_id=jnp.asarray(col("doc_id", -1)),
        page=jnp.asarray(col("page", -1)),
        year=jnp.asarray(col("year", -1)),
        company_id=jnp.asarray(col("company_id", -1)),
        kind=jnp.asarray(col("kind", -1)),
        page_seg=jnp.asarray(col("page_seg", 2**30)),
        chunk_in_doc=jnp.asarray(col("chunk_in_doc", -1)),
        valid=jnp.asarray(valid),
        sparse=sparse,
        n_chunks=n,
        n_pages=len(page_seg_info),
        n_docs=len(docs),
        dim=dim,
    )
    if device_put:
        idx = jax.device_put(idx)
    meta = CorpusMeta(
        docs=docs,
        companies=companies,
        chunk_texts=chunk_texts,
        page_texts=page_texts,
        page_seg_info=page_seg_info,
    )
    return idx, meta

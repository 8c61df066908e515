"""On-device index format.

The reference keeps one FAISS ``IndexFlatIP`` file and one pickled
``BM25Okapi`` per document (reference src/ingestion.py:79-102, :43-47) and
loads them all into host RAM, pairing each with its chunked-report JSON
(reference src/retrieval.py:488-541).  Device-resident design instead:

*   ONE corpus-wide embedding matrix in device memory, padded to a
    fixed row multiple.
    "Per-document / per-year databases" become **masks** over rows — year
    routing and company routing are cheap elementwise predicates fused into
    the scoring kernel, not file selection (SURVEY.md §5 "year-routing maps
    to shard masking").
*   Row-aligned metadata columns (doc id, page, year, company id, chunk
    kind, page-segment id) as int32 device arrays, so parent-page
    aggregation is a segment op instead of a Python dict loop
    (reference src/retrieval.py:1552-1599).
*   A corpus-wide CSR term index for BM25 (term-major postings), replacing
    the per-document pickled BM25Okapi objects.
*   Host-side ``CorpusMeta`` keeps everything the device doesn't need
    (texts, sha1s, company names) for result materialisation.

``CorpusIndex`` is a pytree, so it jits/shards/donates like any array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax

# Pad rows to a multiple of 1024: corpora of similar size share compiled
# shapes, and block shapes stay friendly for large corpora.
ROW_PAD = 1024
KIND_CONTENT = 0
KIND_SERIALIZED_TABLE = 1  # reference src/text_splitter.py:33-60 "serialized_table"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SparseIndex:
    """Corpus-wide BM25 term index (term-major CSR) as device arrays.

    Postings for term t: ``chunk_ids[indptr[t]:indptr[t+1]]`` with term
    frequencies ``tf[...]``.  ``df`` gives document frequency per vocab slot
    (for idf), ``chunk_len`` the token count per chunk row.
    """

    indptr: jax.Array      # i32 [V + 1]
    chunk_ids: jax.Array   # i32 [NNZ]
    tf: jax.Array          # f32 [NNZ]
    df: jax.Array          # f32 [V]
    chunk_len: jax.Array   # f32 [N_pad]
    avgdl: jax.Array       # f32 scalar
    # per-POSTING doc length (chunk_len[chunk_ids], precomputed at build):
    # lets the scorer read lengths as contiguous spans beside tf instead
    # of a random [N] gather per posting.  Optional (the scorer falls back
    # to the gather).
    dl: Optional[jax.Array] = None  # f32 [NNZ]
    vocab_bits: int = dataclasses.field(metadata=dict(static=True), default=20)
    max_postings: int = dataclasses.field(metadata=dict(static=True), default=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedSparseIndex:
    """Row-range-sharded BM25 index: one CSR per dense shard.

    Multi-chip sparse story (SURVEY.md §2.3 "BM25 CSR shards live
    alongside dense shards"): postings are partitioned by CHUNK row range
    so every corpus row's postings live entirely on the shard that holds
    its dense rows — per-shard BM25 totals are complete (no cross-shard
    partial sums) and merge with the same all-gather top-k as the dense
    path.  Leading axis S stacks the per-shard CSRs; placed with
    ``PartitionSpec(axis, None)`` over the mesh, GSPMD keeps each shard's
    gather/sort local and inserts the collective only at the final merge.

    Global statistics (``df`` for idf, ``chunk_len``/``avgdl`` for length
    normalization) stay replicated — scores are bit-comparable to the
    unsharded kernel.
    """

    indptr: jax.Array      # i32 [S, V + 1]
    chunk_ids: jax.Array   # i32 [S, L] — GLOBAL corpus rows, zero-padded
    tf: jax.Array          # f32 [S, L]
    df: jax.Array          # f32 [V]       (global, replicated)
    chunk_len: jax.Array   # f32 [N_pad]   (global, replicated)
    avgdl: jax.Array       # f32 scalar
    # per-posting doc length beside tf (see SparseIndex.dl) — shard-local,
    # so the length read stays on the shard's device
    dl: Optional[jax.Array] = None  # f32 [S, L]
    vocab_bits: int = dataclasses.field(metadata=dict(static=True), default=20)
    max_postings: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_shards: int = dataclasses.field(metadata=dict(static=True), default=1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CorpusIndex:
    """The whole searchable corpus as one pytree of device arrays."""

    emb: jax.Array         # f32|bf16|int8 [N_pad, D] — chunk embeddings, zero-padded rows
    doc_id: jax.Array      # i32 [N_pad]
    page: jax.Array        # i32 [N_pad]  (1-based page numbers, as in the reference JSON)
    year: jax.Array        # i32 [N_pad]
    company_id: jax.Array  # i32 [N_pad]
    kind: jax.Array        # i32 [N_pad]  KIND_CONTENT | KIND_SERIALIZED_TABLE
    page_seg: jax.Array    # i32 [N_pad] — dense global page-segment id (doc, page)
    chunk_in_doc: jax.Array  # i32 [N_pad] — chunk index within its document
    valid: jax.Array       # bool [N_pad]
    sparse: Optional[SparseIndex]
    emb_scale: Optional[jax.Array] = None  # f32 [N_pad] when emb is int8 (ops/quant.py)
    n_chunks: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_pages: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_docs: int = dataclasses.field(metadata=dict(static=True), default=0)
    dim: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n_pad(self) -> int:
        return self.emb.shape[0]


@dataclasses.dataclass
class DocMeta:
    sha1: str
    company: str
    year: Optional[int]
    n_chunks: int
    n_pages: int


@dataclasses.dataclass
class CorpusMeta:
    """Host-side companions to CorpusIndex (not a pytree; never on device)."""

    docs: List[DocMeta]
    companies: List[str]                   # company_id → name
    chunk_texts: List[str]                 # row → chunk text ('' for pad rows)
    page_texts: Dict[int, str]             # page_seg id → page markdown
    page_seg_info: List[Tuple[int, int]]   # page_seg id → (doc_id, page)

    def company_id(self, name: str) -> int:
        try:
            return self.companies.index(name)
        except ValueError:
            return -1

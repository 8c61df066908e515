"""Index persistence.

The reference persists one ``<sha1>.faiss`` + one ``<sha1>.pkl`` per
document (reference src/ingestion.py:92-102, :43-47).  We persist the whole
corpus index as a single ``.npz`` (device arrays → numpy) plus a JSON
sidecar for host metadata — append-only, numbered like the reference's
never-overwrite convention (reference src/pipeline.py:233-252 is mirrored
in pipeline/paths.py).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.tokenize import TOKENIZER_VERSION
from .schema import CorpusIndex, CorpusMeta, DocMeta, SparseIndex

_FORMAT_VERSION = 1


def save_index(path: Path, idx: CorpusIndex, meta: Optional[CorpusMeta] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    emb_np = np.asarray(idx.emb)
    if emb_np.dtype.kind == "V":  # bfloat16: npz has no bf16 — persist the
        emb_np = emb_np.view(np.uint16)  # raw bits, emb_dtype restores it
    arrays = {
        "emb": emb_np,
        "doc_id": np.asarray(idx.doc_id),
        "page": np.asarray(idx.page),
        "year": np.asarray(idx.year),
        "company_id": np.asarray(idx.company_id),
        "kind": np.asarray(idx.kind),
        "page_seg": np.asarray(idx.page_seg),
        "chunk_in_doc": np.asarray(idx.chunk_in_doc),
        "valid": np.asarray(idx.valid),
    }
    if idx.emb_scale is not None:
        arrays["emb_scale"] = np.asarray(idx.emb_scale)
    statics = {
        "version": _FORMAT_VERSION,
        "n_chunks": idx.n_chunks,
        "n_pages": idx.n_pages,
        "n_docs": idx.n_docs,
        "dim": idx.dim,
        "emb_dtype": str(jnp.asarray(idx.emb).dtype),
        "has_sparse": idx.sparse is not None,
        "tokenizer_version": TOKENIZER_VERSION,
    }
    if idx.sparse is not None:
        sp = idx.sparse
        arrays.update(
            sp_indptr=np.asarray(sp.indptr),
            sp_chunk_ids=np.asarray(sp.chunk_ids),
            sp_tf=np.asarray(sp.tf),
            sp_df=np.asarray(sp.df),
            sp_chunk_len=np.asarray(sp.chunk_len),
            sp_avgdl=np.asarray(sp.avgdl),
        )
        statics["sp_vocab_bits"] = sp.vocab_bits
        statics["sp_max_postings"] = sp.max_postings
    np.savez_compressed(path, __statics__=json.dumps(statics), **arrays)

    if meta is not None:
        side = {
            "docs": [dataclasses.asdict(d) for d in meta.docs],
            "companies": meta.companies,
            "chunk_texts": meta.chunk_texts,
            "page_texts": {str(k): v for k, v in meta.page_texts.items()},
            "page_seg_info": [list(t) for t in meta.page_seg_info],
        }
        with open(str(path) + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(side, f, ensure_ascii=False)


def quantize_index(idx: CorpusIndex) -> CorpusIndex:
    """int8 variant of a built corpus index: quarter the row-store memory
    so one device holds 4× the corpus at the same memory budget (BASELINE.md
    "equal memory"; measured recall/QPS trade in bench.py).  The engine
    dispatches on ``emb.dtype`` — searches, traversal, and BM25 fusion all
    work unchanged."""
    from ..ops.quant import quantize_rows

    if idx.emb.dtype == jnp.int8:
        # idempotent: re-quantizing int8 CODES would replace the true
        # per-row scales with ~amax(codes)/127 ≈ 1 and silently corrupt
        # every dense score
        return idx
    emb_i8, scale = quantize_rows(idx.emb)
    return dataclasses.replace(idx, emb=emb_i8, emb_scale=scale)


def index_fingerprint(index_path: Path) -> str:
    """Cheap identity stamp of a saved index artifact (size + mtime).

    Persisted IVF sidecars are only valid for the exact corpus npz they
    were clustered from; the stamp invalidates them on any rebuild."""
    st = Path(index_path).stat()
    return f"{st.st_size}:{int(st.st_mtime_ns)}"


def save_ivf(path: Path, ivf, fingerprint: Optional[str] = None) -> None:
    """Persist a built IVFIndex (index/ivf.py) as one npz sidecar.

    The reference writes its indexes once and loads them forever
    (reference src/ingestion.py:92-102); before this, the pipeline paid
    the full on-device k-means build (~59 s at 1M rows) on every process
    start (pipeline/run.py)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    emb_np = np.asarray(ivf.emb_perm)
    if emb_np.dtype.kind == "V":  # bfloat16 — same raw-bits trick as emb
        emb_np = emb_np.view(np.uint16)
    arrays = {
        "centroids": np.asarray(ivf.centroids),
        "emb_perm": emb_np,
        "row_ids": np.asarray(ivf.row_ids),
        "pos_cluster": np.asarray(ivf.pos_cluster),
        "list_offsets": np.asarray(ivf.list_offsets),
    }
    if ivf.row_scale is not None:
        arrays["row_scale"] = np.asarray(ivf.row_scale)
    for opt in ("list_row_min", "list_row_max", "cluster_doc"):
        if getattr(ivf, opt) is not None:
            arrays[opt] = np.asarray(getattr(ivf, opt))
    statics = {
        "version": _FORMAT_VERSION,
        "k_clusters": ivf.k_clusters,
        "max_list": ivf.max_list,
        "dim": ivf.dim,
        "emb_dtype": str(jnp.asarray(ivf.emb_perm).dtype),
        "fingerprint": fingerprint,
    }
    np.savez_compressed(path, __statics__=json.dumps(statics), **arrays)


def load_ivf(path: Path, expect_fingerprint: Optional[str] = None,
             device_put: bool = True):
    """Load a persisted IVFIndex; returns None when the sidecar is missing
    or was built from a different corpus artifact (fingerprint mismatch)."""
    from .ivf import IVFIndex

    path = Path(path)
    if not path.exists():
        return None
    z = np.load(path, allow_pickle=False)
    statics = json.loads(str(z["__statics__"]))
    if (
        expect_fingerprint is not None
        and statics.get("fingerprint") != expect_fingerprint
    ):
        return None
    emb_np = z["emb_perm"]
    if statics.get("emb_dtype", "") == "bfloat16":
        import ml_dtypes

        emb_np = emb_np.view(ml_dtypes.bfloat16)
    ivf = IVFIndex(
        centroids=jnp.asarray(z["centroids"]),
        emb_perm=jnp.asarray(emb_np),
        row_ids=jnp.asarray(z["row_ids"]),
        pos_cluster=jnp.asarray(z["pos_cluster"]),
        list_offsets=jnp.asarray(z["list_offsets"]),
        row_scale=jnp.asarray(z["row_scale"]) if "row_scale" in z.files else None,
        list_row_min=(
            jnp.asarray(z["list_row_min"]) if "list_row_min" in z.files else None
        ),
        list_row_max=(
            jnp.asarray(z["list_row_max"]) if "list_row_max" in z.files else None
        ),
        cluster_doc=(
            jnp.asarray(z["cluster_doc"]) if "cluster_doc" in z.files else None
        ),
        k_clusters=statics["k_clusters"],
        max_list=statics["max_list"],
        dim=statics["dim"],
        # older sidecars also carry "list_align"/"dma_pad_rows" and pad
        # rows between lists (row id -1): the probe masks those rows, so
        # the fields are ignored
    )
    if device_put:
        ivf = jax.device_put(ivf)
    return ivf


def load_index(path: Path, device_put: bool = True) -> Tuple[CorpusIndex, Optional[CorpusMeta]]:
    path = Path(path)
    z = np.load(path, allow_pickle=False)
    statics = json.loads(str(z["__statics__"]))
    stamped = statics.get("tokenizer_version")
    if stamped is not None and stamped != TOKENIZER_VERSION:
        import warnings

        warnings.warn(
            f"index {path} was built with tokenizer {stamped!r}; current is "
            f"{TOKENIZER_VERSION!r} — BM25 term ids and encoder token ids "
            "will not match. Rebuild with process-reports.",
            stacklevel=2,
        )
    sparse = None
    if statics.get("has_sparse"):
        # per-posting doc lengths are derived, not persisted (schema.dl):
        # one host-side take keeps the file format unchanged
        cids = np.asarray(z["sp_chunk_ids"])
        clen = np.asarray(z["sp_chunk_len"])
        dl = clen[np.clip(cids, 0, len(clen) - 1)].astype(np.float32)
        sparse = SparseIndex(
            indptr=jnp.asarray(z["sp_indptr"]),
            chunk_ids=jnp.asarray(cids),
            tf=jnp.asarray(z["sp_tf"]),
            df=jnp.asarray(z["sp_df"]),
            chunk_len=jnp.asarray(clen),
            avgdl=jnp.asarray(z["sp_avgdl"]),
            dl=jnp.asarray(dl),
            vocab_bits=statics["sp_vocab_bits"],
            max_postings=statics["sp_max_postings"],
            # older files pad chunk_ids/tf past indptr[-1]; no span reads
            # there, so the padding is carried along unread
        )
    emb_np = z["emb"]
    emb_dtype = statics.get("emb_dtype", "")
    if emb_dtype == "bfloat16":
        import ml_dtypes

        emb = jnp.asarray(emb_np.view(ml_dtypes.bfloat16))
    else:
        emb = jnp.asarray(emb_np)
    idx = CorpusIndex(
        emb=emb,
        doc_id=jnp.asarray(z["doc_id"]),
        page=jnp.asarray(z["page"]),
        year=jnp.asarray(z["year"]),
        company_id=jnp.asarray(z["company_id"]),
        kind=jnp.asarray(z["kind"]),
        page_seg=jnp.asarray(z["page_seg"]),
        chunk_in_doc=jnp.asarray(z["chunk_in_doc"]),
        valid=jnp.asarray(z["valid"]),
        sparse=sparse,
        emb_scale=jnp.asarray(z["emb_scale"]) if "emb_scale" in z.files else None,
        n_chunks=statics["n_chunks"],
        n_pages=statics["n_pages"],
        n_docs=statics["n_docs"],
        dim=statics["dim"],
    )
    if device_put:
        idx = jax.device_put(idx)

    meta = None
    meta_path = Path(str(path) + ".meta.json")
    if meta_path.exists():
        with open(meta_path, "r", encoding="utf-8") as f:
            side = json.load(f)
        meta = CorpusMeta(
            docs=[DocMeta(**d) for d in side["docs"]],
            companies=side["companies"],
            chunk_texts=side["chunk_texts"],
            page_texts={int(k): v for k, v in side["page_texts"].items()},
            page_seg_info=[tuple(t) for t in side["page_seg_info"]],
        )
    return idx, meta

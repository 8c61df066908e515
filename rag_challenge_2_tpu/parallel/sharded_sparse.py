"""Multi-chip sparse (BM25) search: row-range CSR shards + merged top-k.

Completes the sharded hybrid story (SURVEY.md §2.3): the reference scores
BM25 per document on one host (reference src/retrieval.py:261-262); at the
10M-row scale of BASELINE config 5 the postings must live beside their
dense shards.  ``shard_sparse_index`` partitions the corpus CSR by chunk
row range — every row's postings land on exactly one shard, so per-shard
scores are COMPLETE row totals — and ``sharded_bm25_topk`` runs the
single-device kernel per shard (vmap over the stacked shard axis; GSPMD
keeps each shard's gather/sort on its device) and merges the per-shard
top-k with the same deterministic lowest-row tie-break as the dense merge
(parallel/sharded_search.py).

The whole hybrid graph (dense + BM25 + fusion, retrieval/engine.py
``search_device``) accepts a ``ShardedSparseIndex`` transparently —
the multi-chip dryrun asserts its parity against single-device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.schema import ShardedSparseIndex, SparseIndex
from ..ops.topk import NEG_INF


def shard_sparse_index(
    sparse: SparseIndex,
    n_shards: int,
    mesh=None,
    axis: str = "data",
) -> ShardedSparseIndex:
    """Partition a corpus CSR into per-row-range shards (host-side build).

    Shard ``s`` owns corpus rows ``[s*rows_per, (s+1)*rows_per)`` — the
    same equal row split ``sharded_search.shard_rows`` gives the dense
    matrix — and receives exactly the postings whose chunk id falls in
    that range (term-major order is preserved by the boolean selection).
    When ``mesh`` is given, the stacked arrays are placed sharded over
    ``axis`` and the global statistics replicated.
    """
    indptr = np.asarray(sparse.indptr).astype(np.int64)
    nnz = int(indptr[-1])
    ids = np.asarray(sparse.chunk_ids)[:nnz]
    tfv = np.asarray(sparse.tf)[:nnz]
    V = indptr.shape[0] - 1
    n_pad = sparse.chunk_len.shape[0]
    rows_per = -(-n_pad // n_shards)
    term_of = np.repeat(np.arange(V, dtype=np.int64), np.diff(indptr))
    shard_of = np.minimum(ids // rows_per, n_shards - 1)

    parts = []
    L = 1
    max_post = 0
    for s in range(n_shards):
        sel = shard_of == s
        cnt = np.bincount(term_of[sel], minlength=V)
        ip = np.zeros(V + 1, np.int64)
        np.cumsum(cnt, out=ip[1:])
        parts.append((ip, ids[sel], tfv[sel]))
        L = max(L, int(sel.sum()))
        if V:
            max_post = max(max_post, int(cnt.max()))
    L = -(-L // 1024) * 1024
    sip = np.zeros((n_shards, V + 1), np.int32)
    sid = np.zeros((n_shards, L), np.int32)
    stf = np.zeros((n_shards, L), np.float32)
    sdl = np.zeros((n_shards, L), np.float32)
    clen = np.asarray(sparse.chunk_len)
    for s, (ip, i_s, t_s) in enumerate(parts):
        sip[s] = ip
        sid[s, : len(i_s)] = i_s
        stf[s, : len(t_s)] = t_s
        sdl[s, : len(i_s)] = clen[i_s]

    put_sharded = put_rep = jnp.asarray
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def put_sharded(x):
            x = jnp.asarray(x)
            return jax.device_put(
                x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
            )

        def put_rep(x):
            return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))

    return ShardedSparseIndex(
        indptr=put_sharded(sip),
        chunk_ids=put_sharded(sid),
        tf=put_sharded(stf),
        df=put_rep(sparse.df),
        chunk_len=put_rep(sparse.chunk_len),
        avgdl=jnp.asarray(sparse.avgdl),
        dl=put_sharded(sdl),
        vocab_bits=sparse.vocab_bits,
        max_postings=max_post,
        n_shards=n_shards,
    )


@functools.partial(jax.jit, static_argnames=("k", "window", "k1", "b"))
def _sharded_bm25_topk_impl(
    indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, doc_masks,
    row_slot, dl, *, k, window, k1, b
):
    from ..ops.bm25 import _bm25_topk_impl

    local = functools.partial(_bm25_topk_impl, window=window, k=k, k1=k1, b=b)
    # per-shard scorer over the stacked CSR axis (the per-shard nnz is 1/S
    # of the corpus — the gather domain shrinks with the shard)
    sv, sr, sok = jax.vmap(
        local,
        in_axes=(0, 0, 0, None, None, None, None, None, None, None, None,
                 None if dl is None else 0),
    )(indptr, chunk_ids, tf, df, chunk_len, avgdl, query_terms, doc_masks,
      row_slot, None, None, dl)                        # [S, M, B, k] each

    S, M, B, K = sv.shape
    v = jnp.moveaxis(sv, 0, 2).reshape(M, B, S * K)
    r = jnp.moveaxis(sr, 0, 2).reshape(M, B, S * K)
    ok = jnp.moveaxis(sok, 0, 2).reshape(M, B, S * K)
    vm = jnp.where(ok, v, NEG_INF)
    # deterministic merge: sort candidates by row so equal scores break
    # toward the lower global row (same rule as the dense sharded merge)
    order = jnp.argsort(jnp.where(r >= 0, r, 2 ** 30), axis=-1, stable=True)
    vm = jnp.take_along_axis(vm, order, axis=-1)
    r = jnp.take_along_axis(r, order, axis=-1)
    mv, mi = jax.lax.top_k(vm, k)
    mr = jnp.take_along_axis(r, mi, axis=-1)
    valid = mv > NEG_INF / 2
    return (
        jnp.where(valid, mv, 0.0),
        jnp.where(valid, mr, -1),
        valid,
    )


def sharded_bm25_topk(
    sparse: ShardedSparseIndex,
    query_terms: jax.Array,
    doc_masks: jax.Array,
    k: int,
    *,
    row_slot: Optional[jax.Array] = None,
    k1: float = 1.5,
    b: float = 0.75,
    window: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-document BM25 top-k over the sharded CSR.

    Same contract as ``ops.bm25.bm25_topk`` — ``(scores [M, B, k], rows
    [M, B, k], valid [M, B, k])`` with global corpus rows — and the same
    ``row_slot`` disjoint-mask requirement, applied per shard.
    """
    W = int(window or max(sparse.max_postings, 1))
    return _sharded_bm25_topk_impl(
        sparse.indptr, sparse.chunk_ids, sparse.tf, sparse.df,
        sparse.chunk_len, sparse.avgdl, query_terms, doc_masks, row_slot,
        sparse.dl, k=k, window=W, k1=k1, b=b,
    )

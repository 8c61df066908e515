"""IVF-Flat clustered index (the faiss-IVF equivalent, built on device).

Layout: rows are permuted so each cluster's rows are contiguous
(``emb_perm``), with ``list_offsets [K+1]`` marking ranges and ``row_ids``
mapping permuted positions back to corpus rows.  Query = coarse top-nprobe
centroid scores, then an exact scan over the probed lists gathered with a
static window (``max_list``), then top-k — all one jitted graph.  Equal
memory vs the flat index: same f32 rows, plus K·D centroids (<1% at
K=√N·4).

Recall target: match faiss IVF-Flat at the same (K, nprobe) on recall@10
vs exact (BASELINE.md config 3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kmeans import assign_clusters, kmeans, kmeans_batched
from ..ops.topk import NEG_INF


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IVFIndex:
    centroids: jax.Array     # f32 [K, D]
    emb_perm: jax.Array      # f32|bf16|int8 [N_pad, D] — rows grouped by cluster
    row_ids: jax.Array       # i32 [N_pad] — permuted position → corpus row (-1 pad)
    pos_cluster: jax.Array   # i32 [N_pad] — cluster id per permuted position (K pad)
    list_offsets: jax.Array  # i32 [K + 1]
    row_scale: Optional[jax.Array] = None  # f32 [N_pad] when emb_perm is int8
    # per-cluster min/max ORIGINAL row id (-1/-1 for empty lists): interval
    # overlap gives routed-probe eligibility under contiguous-range routing
    # without the [B, N] mask scatter (over-approximate — exact row-range
    # masking happens on the candidates; a false-eligible cluster only
    # costs a probe, never a wrong result)
    list_row_min: Optional[jax.Array] = None  # i32 [K]
    list_row_max: Optional[jax.Array] = None  # i32 [K]
    # [K, n_docs] bool — does cluster c contain rows of doc d?  Built by
    # cluster_order_index (doc identity is known there); exact routed-probe
    # eligibility for cluster-ordered corpora via one one-hot matmul
    cluster_doc: Optional[jax.Array] = None
    k_clusters: int = dataclasses.field(metadata=dict(static=True), default=0)
    max_list: int = dataclasses.field(metadata=dict(static=True), default=0)
    dim: int = dataclasses.field(metadata=dict(static=True), default=0)


def build_ivf(
    emb: jax.Array,
    n_clusters: Optional[int] = None,
    iters: int = 10,
    seed: int = 0,
    valid: Optional[jax.Array] = None,
    max_list_size: Optional[int] = None,
) -> IVFIndex:
    """Cluster + permute. ``emb`` may include zero padding rows — pass
    ``valid`` to keep them out of every list.

    ``max_list_size`` balances the lists: oversized clusters are
    re-clustered into ⌈n/cap⌉ sub-centroids (up to 3 rounds).  The probe
    window pads to the longest list, so capping it converts tail imbalance
    directly into probe throughput.  The cap is SOFT: a
    dense isotropic blob has no meaningful k-means split, so a list may
    exceed the cap by a modest factor rather than be chopped arbitrarily
    (arbitrary chopping would silently cost recall)."""
    N, D = emb.shape
    if valid is None:
        valid_np = np.ones((N,), bool)
    else:
        valid_np = np.asarray(valid)
    rows = np.nonzero(valid_np)[0]
    K = n_clusters or max(1, int(np.sqrt(len(rows)) * 4))
    # The big matrix never round-trips through the host: ``emb`` stays
    # device-resident.  Only small arrays (assign, counts, centroids,
    # index vectors) cross the host boundary.
    x = jnp.asarray(emb, jnp.float32)
    if len(rows) != N:
        x = x[jnp.asarray(rows)]
    centroids, assign = kmeans(x, K, iters=iters, seed=seed)
    assign = np.asarray(assign)

    if max_list_size:
        centroids, assign = _balance_clusters(
            x, assign, centroids, max_list_size, iters, seed
        )
        K = centroids.shape[0]

    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(sorted_assign, minlength=K)
    offsets, n_pad = _list_offsets(counts)

    # scatter rows into their lists' slots.  x scatters DIRECTLY via the
    # inverse permutation — x[order] as a scatter operand would hold a
    # third full-matrix buffer at the build's peak (4 GB at 1M×1024)
    within = np.arange(len(rows)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    pos = offsets[:-1][sorted_assign] + within
    pos_of_x = np.empty(len(rows), np.int64)
    pos_of_x[order] = pos
    emb_perm_dev = _scatter_into_zeros(
        jnp.asarray(pos_of_x, jnp.int32), x, n_pad, jnp.dtype(emb.dtype)
    )
    rows_sorted = rows[order]
    row_ids = np.full((n_pad,), -1, np.int32)
    pos_cluster = np.full((n_pad,), K, np.int32)
    row_ids[pos] = rows_sorted
    pos_cluster[pos] = sorted_assign
    lmin, lmax = _list_row_bounds(sorted_assign, rows_sorted, K)

    max_list = int(counts.max()) if len(counts) else 0
    return IVFIndex(
        centroids=centroids,
        emb_perm=emb_perm_dev,
        row_ids=jnp.asarray(row_ids),
        pos_cluster=jnp.asarray(pos_cluster),
        list_offsets=jnp.asarray(offsets, jnp.int32),
        list_row_min=jnp.asarray(lmin),
        list_row_max=jnp.asarray(lmax),
        k_clusters=K,
        max_list=max_list,
        dim=D,
    )


@functools.partial(jax.jit, static_argnames=("n_pad", "dtype"))
def _scatter_into_zeros(idx, src, n_pad: int, dtype):
    """``zeros[n_pad, D].at[idx].set(src)`` as ONE jitted graph: XLA
    initializes the output buffer and scatters in place, so the build's
    peak holds source + destination only.  The same expression outside
    jit materializes the zeros AND a separate scatter result — a third
    full-matrix buffer."""
    return jnp.zeros((n_pad, src.shape[1]), dtype).at[idx].set(
        src.astype(dtype), unique_indices=True
    )


def _list_offsets(counts: np.ndarray):
    """Cluster list offsets ``[K + 1]`` and the store's row count (at
    least one row, so an empty index still has a buffer to clamp into)."""
    offsets = np.zeros((len(counts) + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, max(int(offsets[-1]), 1)


def _list_row_bounds(sorted_assign, rows_sorted, K):
    """Per-cluster min/max original row id (-1 for empty lists)."""
    lmin = np.full((K,), np.iinfo(np.int32).max, np.int64)
    lmax = np.full((K,), -1, np.int64)
    np.minimum.at(lmin, sorted_assign, rows_sorted)
    np.maximum.at(lmax, sorted_assign, rows_sorted)
    lmin[lmax < 0] = -1
    return lmin.astype(np.int32), lmax.astype(np.int32)


# bound on the [G, n, D] gather one batched sub-split holds in HBM
_BALANCE_BATCH_BYTES = 2 << 30


def _balance_clusters(x, assign, centroids, max_list_size, iters, seed):
    """Sub-split oversized clusters (the SOFT cap — see :func:`build_ivf`).

    ``x`` are the vectors the assignments refer to — the full corpus in
    :func:`build_ivf`, a training sample in :func:`build_ivf_streaming`
    (where ``max_list_size`` is pre-scaled by the sample fraction).
    Returns (centroids [K', D] device, assign [len(x)] np.int32).

    Oversized clusters are grouped by (padded size, k_sub) and each group
    sub-splits through ONE batched k-means dispatch
    (ops/kmeans.kmeans_batched).  The per-cluster sequential form this
    replaces spent most of a 1M-row build on dispatch round trips and
    per-shape compiles.
    """
    assign = np.asarray(assign).copy()  # np view of a jax array is read-only
    cent_list = list(np.asarray(centroids))
    D = x.shape[1]
    # a sub-split can itself come out uneven; a few rounds converge
    for rnd in range(3):
        counts = np.bincount(assign, minlength=len(cent_list))
        oversized = np.nonzero(counts > max_list_size)[0]
        if len(oversized) == 0:
            break
        # group by (pad_n, k_sub): one batched dispatch per shape class
        groups: dict = {}
        for c in oversized:
            n_c = int(counts[c])
            k_sub = int(np.ceil(n_c / max_list_size))
            pad_n = 1 << (n_c - 1).bit_length()
            groups.setdefault((pad_n, min(k_sub, pad_n)), []).append(int(c))
        for (pad_n, k_sub), cids in sorted(groups.items()):
            g_cap = max(1, _BALANCE_BATCH_BYTES // (pad_n * D * 4))
            for s in range(0, len(cids), g_cap):
                batch = cids[s : s + g_cap]
                members_b, idx_rows = [], []
                for c in batch:
                    members = np.nonzero(assign == c)[0]
                    members_b.append(members)
                    # pad rows CYCLE through the members so no single
                    # point is double-weighted during sub-clustering
                    idx_rows.append(members[np.arange(pad_n) % len(members)])
                xs = x[jnp.asarray(np.stack(idx_rows))]     # device gather
                sub_c, sub_a = kmeans_batched(
                    xs, k_sub, iters=max(3, iters // 2),
                    seed=seed + rnd * 131071 + batch[0] + 1,
                )
                sub_c = np.asarray(sub_c)
                sub_a = np.asarray(sub_a)
                for gi, c in enumerate(batch):
                    members = members_b[gi]
                    a_g = sub_a[gi, : len(members)]
                    # first sub-cluster reuses slot c; the rest append
                    cent_list[c] = sub_c[gi, 0]
                    for j in range(1, k_sub):
                        new_id = len(cent_list)
                        cent_list.append(sub_c[gi, j])
                        assign[members[a_g == j]] = new_id
    return jnp.asarray(np.stack(cent_list), jnp.float32), assign


def build_ivf_streaming(
    chunk_provider,
    n_chunks: int,
    n_clusters: Optional[int] = None,
    iters: int = 10,
    seed: int = 0,
    sample_rows: int = 500_000,
    max_list_size: Optional[int] = None,
    quantize: bool = False,
) -> IVFIndex:
    """IVF build for corpora whose flat + permuted copies exceed HBM.

    :func:`build_ivf` holds the source matrix AND its cluster-permuted
    copy live at the permute gather — 2× the store (20.5 GB for the 10M
    int8 store of BASELINE config 5).  This
    builder never holds more than ONE chunk of source beside the
    destination, in three streamed passes (the faiss-IVF train-on-sample
    recipe, reference src/ingestion.py:79-102 writes the analogous
    artifact once):

    1. **Train**: k-means (+ soft balancing, cap scaled by the sample
       fraction) over ``sample_rows`` drawn evenly from every chunk.
    2. **Assign**: one matmul pass per chunk; only [C] i32 assignments
       cross to the host, giving exact list offsets.
    3. **Scatter**: each chunk (quantized per row iff ``quantize``) is
       written straight into its clusters' destination slots with one
       donated unique-index row scatter — the f32 chunk is the only
       transient.

    Args:
        chunk_provider: ``i -> f32 [C_i, D]`` device array (row chunk i;
            deterministic — called twice per chunk).  All rows are valid.
        n_chunks: number of chunks.
        quantize: store int8 rows + per-row scales (``quantize_ivf``
            layout) — the chunk is quantized AFTER assignment, so
            centroids and assignments are full-precision.

    Returns the same :class:`IVFIndex` as build_ivf (+quantize_ivf).
    """
    # -- pass 1: sample + train ------------------------------------------
    sizes = []
    samples = []
    for i in range(n_chunks):
        chunk = chunk_provider(i)
        sizes.append(chunk.shape[0])
        per = max(1, sample_rows // n_chunks)
        stride = max(1, chunk.shape[0] // per)
        samples.append(jnp.asarray(chunk[::stride][:per]))
        del chunk
    N = int(np.sum(sizes))
    starts = np.zeros(n_chunks, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    x_s = jnp.concatenate(samples, axis=0)
    del samples
    S = x_s.shape[0]
    K = n_clusters or max(1, int(np.sqrt(N) * 4))
    centroids, assign_s = kmeans(x_s, K, iters=iters, seed=seed)
    if max_list_size:
        cap_s = max(1, int(max_list_size * S / N))
        centroids, _ = _balance_clusters(
            x_s, assign_s, centroids, cap_s, iters, seed
        )
    K = centroids.shape[0]
    del x_s, assign_s

    # -- pass 2: assign every chunk --------------------------------------
    assigns = []
    for i in range(n_chunks):
        assigns.append(np.asarray(assign_clusters(chunk_provider(i), centroids)))
    counts = np.bincount(np.concatenate(assigns), minlength=K)
    offsets, n_pad = _list_offsets(counts)

    # -- pass 3: scatter into the permuted store -------------------------
    D = int(centroids.shape[1])
    store_dtype = jnp.int8 if quantize else None
    dest = None
    row_scale = jnp.zeros((n_pad,), jnp.float32) if quantize else None
    row_ids = np.full((n_pad,), -1, np.int32)
    cursor = offsets[:K].copy()

    @functools.partial(jax.jit, donate_argnums=(0,))
    def scatter_rows(buf, pos, chunk):
        return buf.at[pos].set(chunk.astype(buf.dtype))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def scatter_rows_q(buf, scales, pos, chunk):
        from ..ops.quant import quantize_rows

        q8, sc = quantize_rows(chunk)
        return buf.at[pos].set(q8), scales.at[pos].set(sc)

    for i in range(n_chunks):
        chunk = chunk_provider(i)
        if dest is None:
            store_dtype = store_dtype or chunk.dtype
            dest = jnp.zeros((n_pad, D), store_dtype)
        a = assigns[i]
        # per-row destination slot: next free position of its list
        pos = np.empty(len(a), np.int64)
        for c in np.unique(a):
            m = a == c
            n_c = int(m.sum())
            pos[m] = cursor[c] + np.arange(n_c)
            cursor[c] += n_c
        row_ids[pos] = starts[i] + np.arange(len(a))
        pos_j = jnp.asarray(pos.astype(np.int32))
        if quantize:
            dest, row_scale = scatter_rows_q(dest, row_scale, pos_j, chunk)
        else:
            dest = scatter_rows(dest, pos_j, chunk)
        del chunk

    pos_cluster = np.full((n_pad,), K, np.int32)
    for c in range(K):
        pos_cluster[offsets[c] : offsets[c] + counts[c]] = c
    live = row_ids >= 0
    lmin, lmax = _list_row_bounds(
        pos_cluster[live], row_ids[live].astype(np.int64), K
    )

    return IVFIndex(
        centroids=centroids,
        emb_perm=dest,
        row_ids=jnp.asarray(row_ids),
        pos_cluster=jnp.asarray(pos_cluster),
        list_offsets=jnp.asarray(offsets, jnp.int32),
        row_scale=row_scale,
        list_row_min=jnp.asarray(lmin),
        list_row_max=jnp.asarray(lmax),
        k_clusters=K,
        max_list=int(counts.max()) if len(counts) else 0,
        dim=D,
    )


def quantize_ivf(index: IVFIndex) -> IVFIndex:
    """int8 variant of a built IVF index: quarter the row-store memory
    (equal-memory headroom under BASELINE.md's bar) AND quarter the probe's
    gather bytes.  The probe keeps the dot in int8×int8→int32 and
    dequantizes per candidate (ops/quant.py) — unlike the bf16 variant,
    nothing upcasts the gathered ``[B, W, D]`` block."""
    from ..ops.quant import quantize_rows

    if index.emb_perm.dtype == jnp.int8:
        return index  # idempotent — see index/store.quantize_index
    emb_i8, scale = quantize_rows(index.emb_perm)
    return dataclasses.replace(index, emb_perm=emb_i8, row_scale=scale)


def cluster_order_index(idx, meta, ivf: IVFIndex):
    """Rearrange a corpus into its IVF's cluster order — ONE store for both
    the probe path and every flat path.

    FAISS keeps vectors inside the IVF's inverted lists and nothing else
    (reference src/ingestion.py:79-102 persists only the IVF artifact); the
    flat-plus-IVF layout this framework uses elsewhere doubles row-store
    device memory (10.2 GB twice at the 10M int8 corpus).
    Cluster ordering makes ``ivf.emb_perm`` THE corpus: metadata columns and
    ``CorpusMeta.chunk_texts`` are permuted to match (host-side, [N]-sized),
    the BM25 CSR's chunk ids are remapped, and the returned IVF's
    ``row_ids`` become the identity — probes gather from the same buffer
    the traversal/anchor paths read.

    Trade-off: documents are no longer contiguous row ranges, so
    ``QueryEngine.window`` degrades to 0 (traversal hops fall back to the
    masked full-corpus path — identical results).  Intended for probe-served
    corpora (SearchConfig(use_ivf=True)) where the doc-windowed exact scan
    is not the serving path anyway.

    Returns ``(new_idx, new_meta, new_ivf)``; ``new_idx.emb`` IS
    ``ivf.emb_perm`` (no copy).
    """
    from .schema import CorpusIndex, CorpusMeta

    row_ids = np.asarray(ivf.row_ids)
    P = int(row_ids.shape[0])
    live = row_ids >= 0
    src = np.where(live, row_ids, 0)
    pad_pos = np.flatnonzero(~live)

    def perm(col, fill):
        c = np.asarray(col)
        return jnp.asarray(np.where(live, c[src], fill).astype(c.dtype))

    new_sparse = None
    if idx.sparse is not None:
        # sentinel for posting-buffer padding: prefer an invalid (padded)
        # position; any in-range id is CORRECT either way — out-of-span
        # postings are zero-masked by the scorer (ops/bm25.py
        # _gather_contributions `in_window`), their row id never scores
        sent = int(pad_pos[-1]) if pad_pos.size else 0
        inv = np.full((idx.n_pad,), sent, np.int64)
        inv[row_ids[live]] = np.flatnonzero(live)
        old_cid = np.asarray(idx.sparse.chunk_ids)
        new_cid = inv[np.clip(old_cid, 0, idx.n_pad - 1)].astype(np.int32)
        new_clen = np.where(
            live, np.asarray(idx.sparse.chunk_len)[src], 0.0
        ).astype(np.float32)
        new_sparse = dataclasses.replace(
            idx.sparse,
            chunk_ids=jnp.asarray(new_cid),
            chunk_len=jnp.asarray(new_clen),
        )

    new_idx = CorpusIndex(
        emb=ivf.emb_perm,
        doc_id=perm(idx.doc_id, -1),
        page=perm(idx.page, -1),
        year=perm(idx.year, -1),
        company_id=perm(idx.company_id, -1),
        kind=perm(idx.kind, -1),
        page_seg=perm(idx.page_seg, 2**30),
        chunk_in_doc=perm(idx.chunk_in_doc, -1),
        valid=jnp.asarray(np.where(live, np.asarray(idx.valid)[src], False)),
        sparse=new_sparse,
        emb_scale=ivf.row_scale if ivf.emb_perm.dtype == jnp.int8 else None,
        n_chunks=idx.n_chunks,
        n_pages=idx.n_pages,
        n_docs=idx.n_docs,
        dim=idx.dim,
    )
    new_meta = meta
    if meta is not None:
        texts = meta.chunk_texts
        new_texts = [
            texts[int(r)] if (r >= 0 and r < len(texts)) else ""
            for r in row_ids
        ]
        new_meta = dataclasses.replace(meta, chunk_texts=new_texts)
    # cluster × doc presence: exact routed-probe eligibility for the
    # cluster-ordered store (one one-hot matmul per search instead of the
    # [B, N] row_ok scatter — ivf_search doc-mode)
    pos_c = np.asarray(ivf.pos_cluster)
    doc_perm = np.asarray(new_idx.doc_id)
    K1 = ivf.k_clusters + 1
    n_docs = max(idx.n_docs, 1)
    cd = np.zeros((K1, n_docs), bool)
    # rows whose doc id falls outside [0, n_docs) (pad sentinels, or
    # malformed metadata) are simply never probe-eligible — doc-mode
    # ivf_search compares ids by equality, so leaving their bits unset
    # matches the device semantics instead of crashing the host build
    sel = live & (doc_perm >= 0) & (doc_perm < n_docs)
    cd[pos_c[sel], doc_perm[sel]] = True

    new_ivf = dataclasses.replace(
        ivf,
        row_ids=jnp.asarray(np.where(live, np.arange(P), -1).astype(np.int32)),
        cluster_doc=jnp.asarray(cd),
        # original-row bounds are meaningless after the reorder (rows ARE
        # positions now) — doc-mode eligibility replaces them
        list_row_min=None,
        list_row_max=None,
    )
    return new_idx, new_meta, new_ivf


@functools.partial(jax.jit, static_argnames=("nprobe", "k", "window"))
def ivf_search(
    index: IVFIndex,
    q: jax.Array,
    k: int,
    nprobe: int = 8,
    window: Optional[int] = None,
    mask: Optional[jax.Array] = None,
    win_start: Optional[jax.Array] = None,
    win_len: Optional[jax.Array] = None,
    pair_doc: Optional[jax.Array] = None,
    pos_doc: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k corpus rows per query.

    Routing (pick ONE; all reproduce the flat path's semantics including
    coarse probe selection — a routed query never probes only clusters
    with no eligible rows):

    * ``mask`` ([N] or [B, N] bool over corpus rows) — general but
      expensive at scale: eligibility is a [B, N] scatter and candidate
      masking a [B, W] gather per probe.
    * ``win_start``/``win_len`` ([B] i32) — contiguous ORIGINAL-row range
      per query (the index/build doc layout): eligibility from per-list
      row bounds (``list_row_min/max``, over-approximate — exact range
      masking happens on the candidates), candidate masking by compare.
    * ``pair_doc`` ([B] i32 routed doc per query, -1 invalid) with
      ``pos_doc`` ([N_rows] i32 doc id per PERMUTED position) — the
      cluster-ordered-store mode: exact eligibility from the
      ``cluster_doc`` presence bitmap (one one-hot matmul), candidate
      masking by doc equality.

    The probe is a scan over the ``P`` probed lists: each step gathers the
    list's ``[B, W, D]`` rows and takes their dot with the query, then
    merges into a running top-k.

    window: static per-list gather width (defaults to the longest list).
    """
    B, D = q.shape
    if win_start is not None and index.list_row_min is None and mask is None:
        # silent fallthrough here would skip coarse eligibility entirely:
        # a routed query could probe only clusters with zero eligible rows
        # and return empty results.  Bounds are built by build_ivf /
        # build_ivf_streaming; legacy sidecars without them must route by
        # mask (or doc equality on cluster-ordered corpora).
        raise ValueError(
            "win_start routing requires IVFIndex.list_row_min/max "
            "(absent on this index — a pre-bounds sidecar?); pass a "
            "routing mask instead"
        )
    W = int(window or max(index.max_list, 1))
    qf = q.astype(jnp.float32)
    int8_store = index.emb_perm.dtype == jnp.int8
    if int8_store:
        from ..ops.quant import quantize_rows

        q_i8, q_scale = quantize_rows(qf)

    coarse = jnp.dot(qf, index.centroids.T, preferred_element_type=jnp.float32)
    K = index.k_clusters
    if pair_doc is not None and index.cluster_doc is not None:
        # exact per-(query, cluster) eligibility: one one-hot matmul
        n_docs = index.cluster_doc.shape[1]
        onehot = (
            pair_doc[:, None] == jnp.arange(n_docs, dtype=jnp.int32)[None, :]
        ).astype(jnp.float32)                                    # [B, n_docs]
        elig = jnp.einsum(
            "kd,bd->bk", index.cluster_doc[:K].astype(jnp.float32), onehot
        ) > 0.0
        coarse = jnp.where(elig, coarse, NEG_INF)
    elif win_start is not None and index.list_row_min is not None:
        # interval-overlap eligibility (over-approximate, correctness-safe)
        lo = index.list_row_min[None, :K]
        hi = index.list_row_max[None, :K]
        s_col = win_start[:, None]
        e_col = (win_start + win_len)[:, None]
        elig = (hi >= 0) & (lo < e_col) & (hi >= s_col) & (win_len[:, None] > 0)
        coarse = jnp.where(elig, coarse, NEG_INF)
    elif mask is not None:
        # per-cluster eligibility under the routing mask
        safe_rows_all = jnp.maximum(index.row_ids, 0)
        row_ok = (
            mask[safe_rows_all] if mask.ndim == 1 else mask[:, safe_rows_all]
        ) & (index.row_ids >= 0)                                # [N_pad] or [B, N_pad]
        K1 = index.k_clusters + 1
        if row_ok.ndim == 1:
            elig = jnp.zeros((K1,), bool).at[index.pos_cluster].max(row_ok)
            coarse = jnp.where(elig[None, :K], coarse, NEG_INF)
        else:
            elig = jnp.zeros((B, K1), bool).at[:, index.pos_cluster].max(row_ok)
            coarse = jnp.where(elig[:, :K], coarse, NEG_INF)
    _, probes = jax.lax.top_k(coarse, min(nprobe, index.k_clusters))  # [B, P]
    P = probes.shape[1]
    k_eff = min(k, P * W)

    starts = index.list_offsets[probes]              # [B, P]
    ends = index.list_offsets[probes + 1]            # [B, P]
    offs = jnp.arange(W, dtype=jnp.int32)            # [W]

    # Scan over probes with a running top-k: the candidate-vector gather is
    # [B, W, D] per step instead of [B, P, W, D] at once — this is what
    # keeps 1M-row corpora inside device memory.
    def step(carry, p):
        top_v, top_r = carry
        pos = starts[:, p, None] + offs              # [B, W]
        in_list = offs[None, :] < (ends[:, p] - starts[:, p])[:, None]
        pos = jnp.clip(pos, 0, index.emb_perm.shape[0] - 1)
        cand_rows = index.row_ids[pos]               # [B, W]
        cand_vecs = index.emb_perm[pos]              # [B, W, D]
        if int8_store:
            acc = jnp.einsum(
                "bd,bwd->bw", q_i8, cand_vecs,
                preferred_element_type=jnp.int32,
            )
            scores = (
                acc.astype(jnp.float32)
                * q_scale[:, None]
                * index.row_scale[pos]
            )
        else:
            scores = jnp.einsum(
                "bd,bwd->bw", qf, cand_vecs.astype(jnp.float32),
                precision=jax.lax.Precision.HIGHEST,
            )
        ok = in_list & (cand_rows >= 0)
        if pair_doc is not None and pos_doc is not None:
            cand_doc = pos_doc[pos]                  # [B, W]
            ok = ok & (cand_doc == pair_doc[:, None]) & (pair_doc[:, None] >= 0)
            cand_rows = pos                          # positions ARE rows here
        elif win_start is not None:
            ok = ok & (cand_rows >= win_start[:, None]) & (
                cand_rows < (win_start + win_len)[:, None]
            )
        elif mask is not None:
            safe = jnp.maximum(cand_rows, 0)
            ok = ok & (
                mask[safe] if mask.ndim == 1
                else jnp.take_along_axis(mask, safe, axis=1)
            )
        scores = jnp.where(ok, scores, NEG_INF)
        cv = jnp.concatenate([top_v, scores], axis=1)
        cr = jnp.concatenate([top_r, jnp.where(ok, cand_rows, -1)], axis=1)
        nv, ni = jax.lax.top_k(cv, k_eff)
        nr = jnp.take_along_axis(cr, ni, axis=1)
        return (nv, nr), None

    init = (
        jnp.full((B, k_eff), NEG_INF, jnp.float32),
        jnp.full((B, k_eff), -1, jnp.int32),
    )
    (vals, rows), _ = jax.lax.scan(step, init, jnp.arange(P))
    rows = jnp.where(vals > NEG_INF / 2, rows, -1)
    return vals, rows

"""Multi-device IVF: per-shard clustered indexes + distributed probe merge.

`parallel/sharded_search.py` scales the EXACT scan across devices; this
module scales the clustered (ANN) path the same way — the faiss-distributed
recipe: each device owns a contiguous row range of the corpus and builds
its OWN IVF over it (k-means per shard is embarrassingly parallel), queries
probe every shard's nprobe best lists locally, and the per-shard top-k
candidates merge with one ``all_gather`` with the same
deterministic tie-breaking as the dense merge (lower global row wins).

Probing nprobe lists on EACH of S shards scans S·nprobe lists total, so at
matched nprobe the sharded search has strictly higher recall than a single
same-K-per-shard IVF; matched-work comparisons use nprobe/S per shard
(tests measure both).

Replaces: the reference has no distributed ANN at all — its scale story is
"load every per-year FAISS flat file into host RAM and thread-pool over
them" (reference src/retrieval.py:488-541, :1475-1504); BASELINE.md
config 5 sets the 10M+ multi-shard bar this module serves.

Static-shape contract: every shard's IVF is padded to common shapes —
same ``k_clusters`` (pass ``n_clusters``; per-shard soft balancing is
disabled because it can change K), ``emb_perm`` padded to the largest
shard's padded row count, probe window = max ``max_list`` over shards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.ivf import IVFIndex, build_ivf, ivf_search, quantize_ivf
from ..ops.topk import NEG_INF


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedIVF:
    """S per-shard IVFs stacked on a leading device axis.

    Array fields carry shape ``[S, ...]`` and are placed with
    ``P(axis, ...)`` so each device holds exactly its own shard's index.
    ``row_ids`` are LOCAL to the shard; global row = local + shard_id ·
    ``rows_per_shard``.
    """

    centroids: jax.Array     # f32 [S, K, D]
    emb_perm: jax.Array      # f32|int8 [S, n_pad, D]
    row_ids: jax.Array       # i32 [S, n_pad] local rows (-1 pad)
    pos_cluster: jax.Array   # i32 [S, n_pad]
    list_offsets: jax.Array  # i32 [S, K + 1]
    row_scale: Optional[jax.Array] = None   # f32 [S, n_pad] for int8 stores
    list_row_min: Optional[jax.Array] = None  # i32 [S, K] LOCAL row bounds
    list_row_max: Optional[jax.Array] = None
    k_clusters: int = dataclasses.field(metadata=dict(static=True), default=0)
    max_list: int = dataclasses.field(metadata=dict(static=True), default=0)
    dim: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_shards: int = dataclasses.field(metadata=dict(static=True), default=0)
    rows_per_shard: int = dataclasses.field(metadata=dict(static=True), default=0)
    # the mesh the arrays are placed over (hashable → static aux data);
    # lets consumers (retrieval/engine's use_ivf path) run the probe
    # search without threading the mesh through their own signatures
    mesh: Optional[Mesh] = dataclasses.field(
        metadata=dict(static=True), default=None
    )
    axis: str = dataclasses.field(metadata=dict(static=True), default="data")


def build_sharded_ivf(
    emb: jax.Array,
    mesh: Mesh,
    n_clusters: int,
    iters: int = 10,
    seed: int = 0,
    valid: Optional[jax.Array] = None,
    axis: str = "data",
    quantize: bool = False,
) -> ShardedIVF:
    """Build one IVF per contiguous row shard and stack them device-placed.

    ``emb`` is the [N, D] corpus; each shard's k-means runs independently
    (one after another, on the default device).  Each finished shard is
    moved to host memory and the stack is placed from there, so no device
    ever holds more than one shard's build beside ``emb``.  ``quantize``
    stores int8 rows per shard (ops/quant.py)."""
    S = mesh.shape[axis]
    N, D = emb.shape
    if N < S:
        raise ValueError(f"corpus of {N} rows cannot shard {S} ways")
    rows_per_shard = -(-N // S)
    if valid is None:
        valid = jnp.ones((N,), bool)
    parts = []
    for s in range(S):
        lo = s * rows_per_shard
        hi = min(N, lo + rows_per_shard)
        ivf = build_ivf(
            emb[lo:hi], n_clusters=n_clusters, iters=iters,
            seed=seed + s, valid=valid[lo:hi],
        )
        if quantize:
            ivf = quantize_ivf(ivf)
        parts.append(jax.device_get(ivf))

    if any(p.k_clusters != parts[0].k_clusters for p in parts):
        raise ValueError("per-shard IVFs must share k_clusters")
    K = parts[0].k_clusters
    n_pad = max(int(p.emb_perm.shape[0]) for p in parts)
    max_list = max(int(p.max_list) for p in parts)

    def stack(get, pad_value):
        outs = []
        for p in parts:
            a = get(p)
            pad = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            outs.append(np.pad(a, pad, constant_values=pad_value))
        return np.stack(outs)

    sivf = ShardedIVF(
        centroids=np.stack([p.centroids for p in parts]),
        emb_perm=stack(lambda p: p.emb_perm, 0),
        row_ids=stack(lambda p: p.row_ids, -1),
        pos_cluster=stack(lambda p: p.pos_cluster, K),
        list_offsets=np.stack([p.list_offsets for p in parts]),
        row_scale=(
            stack(lambda p: p.row_scale, 0.0) if quantize else None
        ),
        list_row_min=np.stack([p.list_row_min for p in parts]),
        list_row_max=np.stack([p.list_row_max for p in parts]),
        k_clusters=K,
        max_list=max_list,
        dim=D,
        n_shards=S,
        rows_per_shard=rows_per_shard,
        mesh=mesh,
        axis=axis,
    )

    def put(a, *rest):
        if a is None:
            return None
        return jax.device_put(a, NamedSharding(mesh, P(axis, *rest)))

    return dataclasses.replace(
        sivf,
        centroids=put(sivf.centroids, None, None),
        emb_perm=put(sivf.emb_perm, None, None),
        row_ids=put(sivf.row_ids, None),
        pos_cluster=put(sivf.pos_cluster, None),
        list_offsets=put(sivf.list_offsets, None),
        row_scale=put(sivf.row_scale, None),
        list_row_min=put(sivf.list_row_min, None),
        list_row_max=put(sivf.list_row_max, None),
    )


_SEARCH_CACHE: dict = {}


def make_sharded_ivf_search(
    mesh: Mesh,
    k: int,
    nprobe: int,
    statics: Tuple[int, int, int, int],
    axis: str = "data",
    with_window: bool = False,
    int8: bool = False,
):
    """Jitted distributed probe search, cached per static config.

    ``statics`` = (k_clusters, max_list, dim, rows_per_shard) — the
    ShardedIVF's static fields, rebuilt into each device's local
    ``IVFIndex`` inside shard_map.  Returned fn:
    ``(arrays..., q[, win_start, win_len]) → (vals [B,k], rows [B,k])``
    with GLOBAL row indices and the dense merge's deterministic
    tie-breaking; use :func:`sharded_ivf_search` rather than calling it
    directly."""
    key = (mesh, k, nprobe, statics, axis, with_window, int8)
    cached = _SEARCH_CACHE.get(key)
    if cached is not None:
        return cached
    n_shards = mesh.shape[axis]
    K, max_list, dim, rows_per_shard = statics

    def local(cent, perm, rids, pcl, loff, scale, lmin, lmax, q, *win):
        ivf = IVFIndex(
            centroids=cent[0],
            emb_perm=perm[0],
            row_ids=rids[0],
            pos_cluster=pcl[0],
            list_offsets=loff[0],
            row_scale=scale[0] if int8 else None,
            list_row_min=lmin[0],
            list_row_max=lmax[0],
            k_clusters=K,
            max_list=max_list,
            dim=dim,
        )
        base = jax.lax.axis_index(axis) * rows_per_shard
        kw = {}
        if with_window:
            ws, wl = win
            # intersect the global [ws, ws+wl) range with this shard's rows
            lo = jnp.clip(ws - base, 0, rows_per_shard)
            hi = jnp.clip(ws + wl - base, 0, rows_per_shard)
            kw = dict(win_start=lo, win_len=jnp.maximum(hi - lo, 0))
        # ivf_search returns min(k_l, P·W) columns (index/ivf.py:569,
        # P = min(nprobe, K) probes of W = max_list rows each) — clamp
        # k_l to that too, or the [S, B, k_l] reshape below is wrong
        # whenever nprobe·max_list < min(k, n_pad) (small shards / low
        # nprobe: hybrid_expansion's k=50 over a 4-way 256-row index)
        k_l = min(k, ivf.emb_perm.shape[0], min(nprobe, K) * max_list)
        vals, rows = ivf_search(ivf, q, k_l, nprobe=nprobe, **kw)
        grows = jnp.where(rows >= 0, rows + base, -1)
        av = jax.lax.all_gather(vals, axis)              # [S, B, k_l]
        ai = jax.lax.all_gather(grows, axis)
        B = q.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(B, n_shards * k_l)
        ai = jnp.moveaxis(ai, 0, 1).reshape(B, n_shards * k_l)
        # deterministic ties: prefer lower global row (sharded_search idiom)
        order = jnp.argsort(jnp.where(ai >= 0, ai, 2**30), axis=1, stable=True)
        av = jnp.take_along_axis(av, order, axis=1)
        ai = jnp.take_along_axis(ai, order, axis=1)
        mv, midx = jax.lax.top_k(av, min(k, n_shards * k_l))
        mi = jnp.take_along_axis(ai, midx, axis=1)
        mi = jnp.where(mv > NEG_INF / 2, mi, -1)
        if mv.shape[1] < k:
            # tiny shards (n_pad·S < k): pad to the caller's static k —
            # consumers (engine basic_block) rely on exactly k columns
            pad = k - mv.shape[1]
            mv = jnp.pad(mv, ((0, 0), (0, pad)), constant_values=NEG_INF)
            mi = jnp.pad(mi, ((0, 0), (0, pad)), constant_values=-1)
        return mv, mi

    sh = P(axis, None)
    in_specs = (
        P(axis, None, None), P(axis, None, None), sh, sh, sh,
        sh, sh, sh, P(None, None),
    )
    if with_window:
        in_specs = in_specs + (P(None), P(None))
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    jitted = jax.jit(fn)
    _SEARCH_CACHE[key] = jitted
    return jitted


def sharded_ivf_search(
    sivf: ShardedIVF,
    q: jax.Array,
    k: int,
    mesh: Optional[Mesh] = None,
    nprobe: int = 8,
    axis: Optional[str] = None,
    win_start: Optional[jax.Array] = None,
    win_len: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k global rows per query over every shard's probed lists.

    ``mesh``/``axis`` default to the ones the index was built over."""
    mesh = mesh if mesh is not None else sivf.mesh
    axis = axis if axis is not None else sivf.axis
    if mesh is None:
        raise ValueError("sharded_ivf_search needs a mesh (build_sharded_ivf "
                         "stamps one; pass mesh= for hand-built indexes)")
    with_window = win_start is not None
    statics = (
        sivf.k_clusters, sivf.max_list, sivf.dim, sivf.rows_per_shard
    )
    fn = make_sharded_ivf_search(
        mesh, k, nprobe, statics, axis,
        with_window=with_window, int8=sivf.row_scale is not None,
    )
    scale = sivf.row_scale
    if scale is None:
        # placeholder so the shard_map signature is static (ignored when
        # the int8 flag is off)
        scale = jnp.zeros((sivf.n_shards, 1), jnp.float32)
    args = (
        sivf.centroids, sivf.emb_perm, sivf.row_ids, sivf.pos_cluster,
        sivf.list_offsets, scale, sivf.list_row_min,
        sivf.list_row_max, q,
    )
    if with_window:
        args = args + (win_start, win_len)
    return fn(*args)

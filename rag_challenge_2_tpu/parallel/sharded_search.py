"""Multi-device exact search: row-sharded embeddings + distributed top-k.

The scaling axis of this framework is index length, not sequence length
(SURVEY.md §5): the embedding matrix row-shards across the ``data`` mesh
axis, every device scores its shard locally (matmul + local top-k), and the
per-shard candidates merge with one ``all_gather`` — the classic
distributed top-k, written with ``shard_map`` so the collective is explicit
and deterministic (ties break toward lower global row, matching the
single-device kernel).

Replaces the reference's "load every per-year FAISS file into host RAM"
model (reference src/retrieval.py:488-541) at 10M-vector scale
(BASELINE.md config 5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.topk import NEG_INF


def shard_rows(emb: jax.Array, mesh: Mesh, axis: str = "data") -> jax.Array:
    """Place [N, D] embeddings row-sharded over the mesh axis."""
    return jax.device_put(emb, NamedSharding(mesh, P(axis, None)))


def shard_vec(x: jax.Array, mesh: Mesh, axis: str = "data") -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


_TOPK_CACHE: dict = {}


def make_sharded_topk(mesh: Mesh, k: int, axis: str = "data", int8: bool = False):
    """Build the jitted distributed top-k: (q, emb, mask[, scale]) → (vals, rows).

    Cached per (mesh, k, axis, int8): a fresh closure per call would carry
    a fresh jit wrapper, so every invocation through the convenience
    ``sharded_dense_topk`` would retrace + recompile.

    q: [B, D] replicated; emb: [N, D] row-sharded; mask: [N] row-sharded.
    With ``int8=True``, emb is an int8 store and a row-sharded [N] f32
    ``row_scale`` is the extra trailing argument (ops/quant.py) — each
    device then holds 4× the rows at the same memory budget.
    Returns replicated ([B, k], [B, k]) with global row indices.
    """
    key = (mesh, k, axis, int8)
    cached = _TOPK_CACHE.get(key)
    if cached is not None:
        return cached
    n_shards = mesh.shape[axis]

    def local(q, emb_l, mask_l, *rest):
        rows_per_shard = emb_l.shape[0]
        if int8:
            from ..ops.quant import int8_scores

            (scale_l,) = rest
            scores = int8_scores(q, emb_l, scale_l)
        else:
            scores = jnp.dot(
                q, emb_l.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        scores = jnp.where(mask_l[None, :], scores, NEG_INF)
        k_l = min(k, rows_per_shard)
        vals, idx = jax.lax.top_k(scores, k_l)
        offset = jax.lax.axis_index(axis) * rows_per_shard
        gidx = jnp.where(vals > NEG_INF / 2, idx + offset, -1)
        # gather all shards' candidates, merge on every device (replicated out)
        av = jax.lax.all_gather(vals, axis)            # [S, B, k_l]
        ai = jax.lax.all_gather(gidx, axis)
        B = q.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(B, n_shards * k_l)
        ai = jnp.moveaxis(ai, 0, 1).reshape(B, n_shards * k_l)
        # deterministic ties: prefer lower global row — sort by (-val, row)
        order = jnp.argsort(jnp.where(ai >= 0, ai, 2**30), axis=1, stable=True)
        av = jnp.take_along_axis(av, order, axis=1)
        ai = jnp.take_along_axis(ai, order, axis=1)
        mv, midx = jax.lax.top_k(av, min(k, n_shards * k_l))
        mi = jnp.take_along_axis(ai, midx, axis=1)
        return mv, mi

    in_specs = (P(None, None), P(axis, None), P(axis))
    if int8:
        in_specs = in_specs + (P(axis),)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    jitted = jax.jit(fn)
    _TOPK_CACHE[key] = jitted
    return jitted


def make_hierarchical_topk(
    mesh: Mesh,
    k: int,
    slice_axis: str = "slice",
    dev_axis: str = "device",
    int8: bool = False,
    pair_mask: bool = False,
):
    """Two-level distributed top-k over a (slice × device) mesh.

    Multi-node topology (SURVEY.md §5): a slice is one node, whose devices
    talk over the intra-node links (NVLink between the GPUs of one host);
    slices talk over the inter-node network, with far less bandwidth.  The
    flat merge (``make_sharded_topk``) all-gathers every device's k
    candidates across the WHOLE mesh, so the inter-node network carries
    S_dev × k rows per slice.  Here the merge is hierarchical:

    1. local top-k per device;
    2. ``all_gather`` over ``dev_axis`` (intra-node) + merge → each
       slice's top-k, replicated within the slice;
    3. ``all_gather`` over ``slice_axis`` (inter-node) + merge → global
       top-k — each slice ships exactly k candidates across nodes, an
       S_dev× reduction in inter-node traffic.

    Ties break toward the lower global row at BOTH levels, so results are
    bit-identical to the flat merge and the single-device kernel.

    Rows are sharded over the flattened (slice, device) order:
    ``P((slice_axis, dev_axis), None)`` — global row =
    ((slice · n_dev) + dev) · rows_per_shard + local row.

    ``pair_mask=True`` takes a PER-QUERY ``[B, N]`` routing mask (column-
    sharded ``P(None, (slice, dev))``) instead of the shared ``[N]`` one —
    the shape the engine's (query × doc-slot) anchor grid produces, which
    is how ``retrieval.engine.search_device(hier=...)`` runs its dense
    stage through this merge.
    """
    key = (mesh, k, slice_axis, dev_axis, int8, pair_mask, "hier")
    cached = _TOPK_CACHE.get(key)
    if cached is not None:
        return cached
    n_slices = mesh.shape[slice_axis]
    n_dev = mesh.shape[dev_axis]

    def merge(av, ai, axis_name, n_parts, k_out):
        """all_gather + deterministic merge over one mesh axis."""
        av = jax.lax.all_gather(av, axis_name)        # [S, B, k_in]
        ai = jax.lax.all_gather(ai, axis_name)
        B = av.shape[1]
        av = jnp.moveaxis(av, 0, 1).reshape(B, -1)
        ai = jnp.moveaxis(ai, 0, 1).reshape(B, -1)
        # deterministic ties: prefer lower global row — sort by row first,
        # then top_k (stable) keeps the first occurrence among equal vals
        order = jnp.argsort(jnp.where(ai >= 0, ai, 2**30), axis=1, stable=True)
        av = jnp.take_along_axis(av, order, axis=1)
        ai = jnp.take_along_axis(ai, order, axis=1)
        mv, midx = jax.lax.top_k(av, min(k_out, av.shape[1]))
        mi = jnp.take_along_axis(ai, midx, axis=1)
        return mv, mi

    def local(q, emb_l, mask_l, *rest):
        rows_per_shard = emb_l.shape[0]
        if int8:
            from ..ops.quant import int8_scores

            (scale_l,) = rest
            scores = int8_scores(q, emb_l, scale_l)
        else:
            scores = jnp.dot(
                q, emb_l.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        scores = jnp.where(mask_l if pair_mask else mask_l[None, :],
                           scores, NEG_INF)
        k_l = min(k, rows_per_shard)
        vals, idx = jax.lax.top_k(scores, k_l)
        shard = (
            jax.lax.axis_index(slice_axis) * n_dev
            + jax.lax.axis_index(dev_axis)
        )
        gidx = jnp.where(vals > NEG_INF / 2, idx + shard * rows_per_shard, -1)
        # level 1 — intra-node, within the slice
        sv, si = merge(vals, gidx, dev_axis, n_dev, k)
        # level 2 — inter-node, across slices: k per slice, not S_dev·k
        return merge(sv, si, slice_axis, n_slices, k)

    mask_spec = (P(None, (slice_axis, dev_axis)) if pair_mask
                 else P((slice_axis, dev_axis)))
    in_specs = (P(None, None), P((slice_axis, dev_axis), None), mask_spec)
    if int8:
        in_specs = in_specs + (P((slice_axis, dev_axis)),)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    jitted = jax.jit(fn)
    _TOPK_CACHE[key] = jitted
    return jitted


def hierarchical_dense_topk(
    q: jax.Array,
    emb: jax.Array,
    k: int,
    mesh: Mesh,
    mask: Optional[jax.Array] = None,
    slice_axis: str = "slice",
    dev_axis: str = "device",
    row_scale: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Convenience wrapper around :func:`make_hierarchical_topk` — shards
    rows over the flattened (slice, device) grid and runs the two-level
    merge.  Results are bit-identical to :func:`sharded_dense_topk` over
    the equivalent flat mesh."""
    int8 = emb.dtype == jnp.int8
    if int8 and row_scale is None:
        raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
    n = emb.shape[0]
    s = mesh.shape[slice_axis] * mesh.shape[dev_axis]
    pad = (-n) % s
    if pad:
        emb = jnp.pad(emb, ((0, pad), (0, 0)))
        mask = jnp.pad(
            mask if mask is not None else jnp.ones((n,), bool), (0, pad)
        )
        if int8:
            row_scale = jnp.pad(row_scale, (0, pad))
    elif mask is None:
        mask = jnp.ones((n,), bool)
    grid = P((slice_axis, dev_axis), None)
    emb = jax.device_put(emb, NamedSharding(mesh, grid))
    mask = jax.device_put(mask, NamedSharding(mesh, P((slice_axis, dev_axis))))
    args = (q, emb, mask)
    if int8:
        args = args + (
            jax.device_put(
                row_scale, NamedSharding(mesh, P((slice_axis, dev_axis)))
            ),
        )
    return make_hierarchical_topk(
        mesh, k, slice_axis, dev_axis, int8=int8
    )(*args)


def sharded_dense_topk(
    q: jax.Array,
    emb: jax.Array,
    k: int,
    mesh: Mesh,
    mask: Optional[jax.Array] = None,
    axis: str = "data",
    row_scale: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Convenience wrapper: shard, search, return ([B,k] vals, [B,k] rows).

    Pass ``row_scale`` with an int8 ``emb`` (ops/quant.py store)."""
    int8 = emb.dtype == jnp.int8
    if int8 and row_scale is None:
        raise ValueError("int8 emb requires row_scale (see ops/quant.py)")
    n = emb.shape[0]
    s = mesh.shape[axis]
    pad = (-n) % s
    if pad:
        emb = jnp.pad(emb, ((0, pad), (0, 0)))
        mask = jnp.pad(
            mask if mask is not None else jnp.ones((n,), bool), (0, pad)
        )
        if int8:
            row_scale = jnp.pad(row_scale, (0, pad))
    elif mask is None:
        mask = jnp.ones((n,), bool)
    emb = shard_rows(emb, mesh, axis)
    mask = shard_vec(mask, mesh, axis)
    args = (q, emb, mask)
    if int8:
        args = args + (shard_vec(row_scale, mesh, axis),)
    return make_sharded_topk(mesh, k, axis, int8=int8)(*args)

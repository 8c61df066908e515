"""On-device k-means (Lloyd's iterations as matmul + segment ops).

The coarse quantizer for the IVF index (SURVEY.md §7 step 6): assignment
is one matmul per row block (``argmin ‖x−c‖² = argmax (x·c − ‖c‖²/2)``),
the update is a segment-sum.  Row blocks stream through a ``lax.scan`` so
the [N, K] score matrix never materialises for million-row corpora.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("block",))
def assign_clusters(x: jax.Array, centroids: jax.Array, block: int = 16384) -> jax.Array:
    """Nearest-centroid id per row, block-streamed. x: [N, D] → i32 [N]."""
    N, D = x.shape
    half_c2 = 0.5 * jnp.sum(centroids * centroids, axis=1)  # [K]
    pad = (-N) % block
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    blocks = xp.reshape(-1, block, D)

    def body(_, xb):
        scores = jnp.dot(xb, centroids.T, preferred_element_type=jnp.float32) - half_c2
        return None, jnp.argmax(scores, axis=1).astype(jnp.int32)

    _, assign = jax.lax.scan(body, None, blocks)
    return assign.reshape(-1)[:N]


@functools.partial(jax.jit, static_argnames=("k",))
def _update_centroids(x, assign, old_centroids, k):
    sums = jax.ops.segment_sum(x, assign, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((x.shape[0],), jnp.float32), assign, num_segments=k)
    new = sums / jnp.maximum(counts, 1.0)[:, None]
    # empty clusters keep their previous centroid
    return jnp.where(counts[:, None] > 0, new, old_centroids), counts


@functools.partial(jax.jit, static_argnames=("k",))
def _assign_batched(xs, cent, k):
    half = 0.5 * jnp.sum(cent * cent, axis=2)                  # [G, k]
    scores = jnp.einsum(
        "gnd,gkd->gnk", xs, cent, preferred_element_type=jnp.float32
    ) - half[:, None, :]
    return jnp.argmax(scores, axis=2).astype(jnp.int32)        # [G, n]


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def _kmeans_batched_iters(xs, cent, k: int, iters: int):
    def body(c, _):
        a = _assign_batched(xs, c, k)
        onehot = jax.nn.one_hot(a, k, dtype=jnp.float32)       # [G, n, k]
        sums = jnp.einsum("gnk,gnd->gkd", onehot, xs)
        counts = jnp.sum(onehot, axis=1)                       # [G, k]
        new = sums / jnp.maximum(counts, 1.0)[:, :, None]
        return jnp.where(counts[:, :, None] > 0, new, c), None

    cent, _ = jax.lax.scan(body, cent, None, length=iters)
    return cent, _assign_batched(xs, cent, k)


def kmeans_batched(
    xs: jax.Array, k: int, iters: int = 10, seed: int = 0
) -> Tuple[jax.Array, jax.Array]:
    """Lloyd's over G independent small problems at once.

    ``xs``: [G, n, D] → (centroids [G, k, D], assignments [G, n]).
    One dispatch replaces G sequential :func:`kmeans` calls — built for
    IVF list balancing, where hundreds of oversized clusters each need a
    tiny sub-k-means and per-cluster dispatches would dominate a 1M-row
    build (index/ivf._balance_clusters).
    """
    G, n, D = xs.shape
    rng = np.random.default_rng(seed)
    k = min(k, n)
    init = np.stack([
        rng.choice(n, size=k, replace=False) for _ in range(G)
    ]).astype(np.int32)
    cent0 = jnp.take_along_axis(
        xs, jnp.asarray(init)[:, :, None], axis=1
    ).astype(jnp.float32)
    return _kmeans_batched_iters(xs, cent0, k=k, iters=iters)


def kmeans(
    x: jax.Array,
    k: int,
    iters: int = 10,
    seed: int = 0,
    block: int = 16384,
) -> Tuple[jax.Array, jax.Array]:
    """Lloyd's k-means.  Returns (centroids [k, D], assignments [N]).

    Init = random distinct rows (k-means++ on 1M rows costs more than the
    few extra Lloyd iterations it saves on this workload).
    """
    N = x.shape[0]
    rng = np.random.default_rng(seed)
    init_rows = rng.choice(N, size=min(k, N), replace=False)
    # device gather — np.asarray(x) would copy the whole matrix to the host
    centroids = x[jnp.asarray(init_rows)].astype(jnp.float32)
    if k > N:
        centroids = jnp.pad(centroids, ((0, k - N), (0, 0)))
    for _ in range(iters):
        assign = assign_clusters(x, centroids, block=block)
        centroids, _ = _update_centroids(x, assign, centroids, k)
    return centroids, assign_clusters(x, centroids, block=block)

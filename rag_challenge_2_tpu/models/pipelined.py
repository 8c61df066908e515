"""Pipeline-parallel encoder forward (GPipe over the block stack).

The encoder's transformer blocks are homogeneous, so the stack maps
directly onto parallel/pipeline.py's GPipe schedule: block ``i`` lives on
pipe-stage ``i``, microbatches stream through with activations rotating
between devices (``ppermute``), and the embedding / pooling / projection ends run
replicated outside the pipelined region.

The reference has no model execution at all (SURVEY.md §2.3); this is the
scaling path for encoders whose weights exceed one device's memory
(BASELINE.md config 4 at larger model sizes).  dp×pp composes: the
microbatch batch dim shards over the ``data`` axis inside the same
shard_map (see ``pipeline_forward(batch_axis=...)``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..parallel.pipeline import pipeline_forward
from .encoder import EncoderConfig, block, embed_tokens_in, pool_head


def stack_block_params(params, n_layers: int):
    """``block0..blockN`` param subtrees → one stacked pytree [S, ...]."""
    blocks = [params["params"][f"block{i}"] for i in range(n_layers)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)


def encode_pipelined(
    cfg: EncoderConfig,
    params,
    token_ids: jax.Array,
    mesh: Mesh,
    n_micro: int,
    axis: str = "pipe",
    batch_axis: str | None = "data",
) -> jax.Array:
    """Pipelined equivalent of ``encoder.encode`` (same params tree).

    Requires ``mesh.shape[axis] == cfg.n_layers`` (one block per stage),
    a dense FFN stack (no MoE — stages must be homogeneous), and a batch
    divisible by ``n_micro``.
    """
    if cfg.moe_experts:
        raise ValueError("pipelined encoder requires homogeneous (dense) blocks")
    S = mesh.shape[axis]
    if S != cfg.n_layers:
        raise ValueError(
            f"pipe axis ({S}) must equal n_layers ({cfg.n_layers}) — one stage per block")
    B, L = token_ids.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    p = params["params"]

    x, pad = embed_tokens_in(p, token_ids, cfg)
    mb = B // n_micro
    xs = x.reshape(n_micro, mb, L, cfg.d_model)
    pads = pad.reshape(n_micro, mb, L)

    def stage_fn(pb, x_mb, pad_mb):
        return block(pb, x_mb, pad_mb, cfg)[0]

    y = pipeline_forward(
        stage_fn, stack_block_params(params, cfg.n_layers), xs, mesh,
        axis=axis, extras=pads,
        batch_axis=batch_axis if batch_axis in mesh.shape else None,
    )
    return pool_head(p, y.reshape(B, L, cfg.d_model), pad, cfg)

"""Mixture-of-experts FFN with expert parallelism.

GShard-style dense dispatch: routing
produces capacity-limited one-hot dispatch/combine tensors, expert FFNs
run as one batched einsum over the expert dimension, and the expert
dimension shards over the mesh — expert parallelism expressed to GSPMD,
no ragged all-to-all written by hand (XLA inserts it from the shardings).

Used by the encoder when ``EncoderConfig.moe_experts > 0``: every other
block's MLP becomes :func:`moe_ffn`.  The reference has no training stack at
all; this exists so the framework's training step exercises dp × tp × sp ×
ep and scales the encoder's capacity for corpus-embedding quality work.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def top2_dispatch(router_logits: jax.Array, capacity: int):
    """Top-2 gating with per-expert capacity.

    Args:
        router_logits: [T, E] (T = flattened tokens).
        capacity: max tokens an expert accepts (static).

    Returns:
        dispatch [T, E, C] one-hot, combine [T, E, C] gate-weighted,
        aux_loss (load-balancing, Switch-style).
    """
    T, E = router_logits.shape
    probs = jax.nn.softmax(router_logits, axis=-1)

    g1, e1 = jax.lax.top_k(probs, 1)
    masked = probs * (1.0 - jax.nn.one_hot(e1[:, 0], E))
    g2, e2 = jax.lax.top_k(masked, 1)

    def one_expert(eidx, gate, prio_offset):
        onehot = jax.nn.one_hot(eidx, E)                       # [T, E]
        # position of each token within its expert's queue; second-choice
        # tokens queue after all first choices (prio_offset)
        pos = jnp.cumsum(onehot, axis=0) - 1 + prio_offset      # [T, E]
        keep = (onehot > 0) & (pos < capacity)
        pos_c = jax.nn.one_hot(jnp.sum(pos * onehot, axis=1).astype(jnp.int32), capacity)
        disp = keep[:, :, None] * onehot[:, :, None] * pos_c[:, None, :]
        return disp, disp * gate[:, None, None]

    first_count = jnp.cumsum(jax.nn.one_hot(e1[:, 0], E), axis=0)[-1]  # [E]
    d1, c1 = one_expert(e1[:, 0], g1[:, 0], 0.0)
    d2, c2 = one_expert(e2[:, 0], g2[:, 0], first_count[None, :])
    dispatch = d1 + d2
    combine = c1 + c2

    # load-balance aux loss: E * Σ_e fraction_tokens_e * mean_prob_e
    frac = jnp.mean(jax.nn.one_hot(e1[:, 0], E), axis=0)
    mean_prob = jnp.mean(probs, axis=0)
    aux = E * jnp.sum(frac * mean_prob)
    return dispatch, combine, aux


def init_moe_params(key, n_experts: int, d_model: int, d_ff: int) -> dict:
    """``{"router": {kernel, bias}, "w_in": [E, D, F], "w_out": [E, F, D]}``."""
    lecun = jax.nn.initializers.lecun_normal()
    k_r, k_in, k_out = jax.random.split(key, 3)
    return {
        "router": {
            "kernel": lecun(k_r, (d_model, n_experts), jnp.float32),
            "bias": jnp.zeros((n_experts,), jnp.float32),
        },
        "w_in": lecun(k_in, (n_experts, d_model, d_ff), jnp.float32),
        "w_out": lecun(k_out, (n_experts, d_ff, d_model), jnp.float32),
    }


def _ep(x, spec, mesh: Optional[Mesh]):
    if mesh is not None and "model" in mesh.shape:
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
    return x


def moe_ffn(
    p: dict,
    x: jax.Array,
    capacity_factor: float = 1.25,
    dtype=jnp.bfloat16,
    mesh: Optional[Mesh] = None,
):
    """Capacity-routed top-2 MoE feed-forward → ``(out [B, L, D], aux)``.

    Expert weights are [E, ...]; ``mesh`` shards E over the ``model`` axis
    (ep).  The dispatch/combine einsums become XLA all-to-alls under that
    sharding.  ``aux`` is the Switch-style load-balance loss, which the
    training objective adds (models/train.contrastive_loss).
    """
    B, L, D = x.shape
    T = B * L
    E = p["w_in"].shape[0]
    capacity = max(1, int(capacity_factor * T / E))

    xt = x.reshape(T, D)
    router = xt.astype(jnp.float32) @ p["router"]["kernel"] + p["router"]["bias"]
    dispatch, combine, aux = top2_dispatch(router, capacity)

    # expert-parallel: expert dim sharded over 'model'
    spec = P("model", None, None)
    w_in = _ep(p["w_in"], spec, mesh)
    w_out = _ep(p["w_out"], spec, mesh)

    expert_in = jnp.einsum("tec,td->ecd", dispatch.astype(dtype), xt.astype(dtype))
    expert_in = _ep(expert_in, spec, mesh)
    h = jnp.einsum("ecd,edf->ecf", expert_in, w_in.astype(dtype))
    h = jax.nn.gelu(h)
    expert_out = jnp.einsum("ecf,efd->ecd", h, w_out.astype(dtype))
    expert_out = _ep(expert_out, spec, mesh)
    out = jnp.einsum("tec,ecd->td", combine.astype(dtype), expert_out)
    return out.reshape(B, L, D), aux

"""Contrastive training for the embedding encoder, sharded over a mesh.

The reference never trains anything (its embeddings come from a paid API);
to make on-device corpus embedding (BASELINE.md config 4) self-contained,
the encoder trains with symmetric InfoNCE over (query, passage) pairs —
in-batch negatives, which under GSPMD span the *global* batch: the
``q @ d.T`` logits matrix forces an all-gather of passage embeddings over
the ``data`` axis, exactly the cross-device negatives trick, expressed to
XLA instead of hand-written NCCL.

Parallelism: batch shards over ``data``; encoder weights shard over
``model`` per parallel/mesh.py's Megatron-style rules.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.mesh import shard_params
from .encoder import EncoderConfig, encode, init_params


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    sequence_parallel: bool = False  # shard sequence axis over 'model' too
    moe_aux_weight: float = 0.01     # Switch-style load-balance coefficient
    pp_microbatches: int = 2         # GPipe microbatches when mesh has 'pipe'
    # lr schedule: total_steps > 0 switches the constant lr to linear
    # warmup (warmup_steps) → cosine decay to lr*min_lr_frac at
    # total_steps — long pretraining runs (models/pretrain.py) plateau
    # under a constant lr once the contrastive task sharpens
    total_steps: int = 0
    warmup_steps: int = 100
    min_lr_frac: float = 0.05


def make_optimizer(tc: TrainConfig) -> optax.GradientTransformation:
    if tc.total_steps > 0:
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=tc.lr,
            warmup_steps=min(tc.warmup_steps, max(tc.total_steps // 10, 1)),
            decay_steps=tc.total_steps, end_value=tc.lr * tc.min_lr_frac,
        )
        return optax.adamw(sched, weight_decay=tc.weight_decay)
    return optax.adamw(tc.lr, weight_decay=tc.weight_decay)


def contrastive_loss(
    params, apply_fn, q_tokens: jax.Array, d_tokens: jax.Array,
    temperature: float, moe_aux_weight: float = 0.01, targets=None,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Symmetric InfoNCE with in-(global)-batch negatives.

    ``apply_fn(params, tokens) -> (embeddings, aux)`` abstracts over the
    plain GSPMD forward and the GPipe-pipelined one.  ``aux`` is the MoE
    load-balance term (a scalar, or any pytree of scalars that is summed);
    it is added to the objective so the router cannot collapse
    unpenalized.

    ``targets`` (optional, [B, B] row-stochastic) replaces the identity
    labels with SOFT listwise targets — the distillation objective: the
    dense q→d score distribution is pulled toward a teacher's (e.g. the
    in-repo BM25 path's, models/pretrain.py PairSampler) instead of
    one-hot self-match.  ``targets=None`` is exactly the classic InfoNCE.
    The reverse (d→q) direction renormalizes ``targets.T`` per row, so
    both directions distill the same teacher mass."""
    qe, qvars = apply_fn(params, q_tokens)
    de, dvars = apply_fn(params, d_tokens)
    logits = qe @ de.T / temperature                   # [B, B] global negatives
    labels = jnp.arange(logits.shape[0])
    if targets is None:
        l_qd = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        l_dq = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean()
    else:
        t_qd = targets
        t_dq = targets.T / jnp.clip(
            jnp.sum(targets.T, axis=1, keepdims=True), 1e-9)
        l_qd = optax.softmax_cross_entropy(logits, t_qd).mean()
        l_dq = optax.softmax_cross_entropy(logits.T, t_dq).mean()
    aux_leaves = jax.tree_util.tree_leaves(qvars) + jax.tree_util.tree_leaves(dvars)
    aux = sum((jnp.sum(a) for a in aux_leaves), jnp.float32(0.0))
    loss = (l_qd + l_dq) / 2 + moe_aux_weight * aux
    acc = jnp.mean(jnp.argmax(logits, axis=1) == labels)
    return loss, {"loss": loss, "accuracy": acc, "moe_aux": aux}


def make_train_step(
    apply_fn,
    optimizer: optax.GradientTransformation,
    tc: TrainConfig,
    mesh: Mesh,
):
    """Build the jitted, mesh-sharded train step.

    Returned step signature: ``(params, opt_state, q_tokens, d_tokens
    [, targets]) -> (params, opt_state, metrics)``; ``targets`` is the
    optional [B, B] soft listwise matrix (see :func:`contrastive_loss`).
    Batch inputs are constrained to shard over ``data``; parameter
    shardings ride along from their placement.
    """
    data_sharding = NamedSharding(mesh, P("data", None))

    @jax.jit
    def step(params, opt_state, q_tokens, d_tokens, targets=None):
        q_tokens = jax.lax.with_sharding_constraint(q_tokens, data_sharding)
        d_tokens = jax.lax.with_sharding_constraint(d_tokens, data_sharding)
        if targets is not None:
            targets = jax.lax.with_sharding_constraint(targets, data_sharding)
        (loss, metrics), grads = jax.value_and_grad(
            contrastive_loss, has_aux=True
        )(params, apply_fn, q_tokens, d_tokens, tc.temperature,
          tc.moe_aux_weight, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, metrics

    return step


def make_chunked_train_step(
    apply_fn,
    optimizer: optax.GradientTransformation,
    tc: TrainConfig,
    mesh: Mesh,
):
    """K train steps per dispatch via ``lax.scan``.

    Signature: ``(params, opt_state, q_tokens [K,B,L], d_tokens [K,B,L]
    [, targets [K,B,B]]) -> (params, opt_state, metrics)`` where each
    metrics value is stacked ``[K]``.  Update order and arithmetic are
    identical to :func:`make_train_step` applied K times — the scan only
    amortizes the per-dispatch host overhead (models/pretrain.py uses this
    for every full chunk of K steps).
    """
    data_sharding = NamedSharding(mesh, P(None, "data", None))

    # params/opt_state are donated: the training loop rebinds both every
    # call, so the update happens in place instead of allocating fresh
    # output buffers per dispatch
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def multi_step(params, opt_state, q_tokens, d_tokens, targets=None):
        q_tokens = jax.lax.with_sharding_constraint(q_tokens, data_sharding)
        d_tokens = jax.lax.with_sharding_constraint(d_tokens, data_sharding)
        if targets is not None:
            targets = jax.lax.with_sharding_constraint(targets, data_sharding)

        def body(carry, xs):
            params, opt_state = carry
            if targets is None:
                q, d = xs
                t = None
            else:
                q, d, t = xs
            (_, metrics), grads = jax.value_and_grad(
                contrastive_loss, has_aux=True
            )(params, apply_fn, q, d, tc.temperature, tc.moe_aux_weight, t)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), metrics

        xs = (q_tokens, d_tokens) if targets is None else (
            q_tokens, d_tokens, targets)
        (params, opt_state), metrics = jax.lax.scan(
            body, (params, opt_state), xs)
        return params, opt_state, metrics

    return multi_step


def init_training(
    cfg: EncoderConfig,
    tc: TrainConfig,
    mesh: Mesh,
    seed: int = 0,
):
    """Init sharded params + optimizer state + jitted step on the mesh.

    Returns ``(forward, params, opt_state, step)``; ``forward(params,
    tokens)`` is the embedding forward the step trains (sequence-parallel
    when ``tc.sequence_parallel``).  When the mesh carries a ``pipe``
    axis, the encoder's block stack runs through the GPipe schedule
    (models/pipelined.py) — dp×pp — instead of the plain GSPMD forward."""
    sp_mesh = mesh if tc.sequence_parallel else None
    params = shard_params(init_params(cfg, jax.random.PRNGKey(seed)), mesh)
    optimizer = make_optimizer(tc)
    opt_state = optimizer.init(params)

    if "pipe" in mesh.shape:
        from .pipelined import encode_pipelined

        def apply_fn(p, tokens):
            return encode_pipelined(cfg, p, tokens, mesh, tc.pp_microbatches), 0.0
    else:
        def apply_fn(p, tokens):
            return encode(p, tokens, cfg, mesh=sp_mesh, with_aux=True)

    step = make_train_step(apply_fn, optimizer, tc, mesh)
    # the chunked (scan-of-K) variant rides the same apply_fn/optimizer;
    # exposed as an attribute so the 4-tuple contract stays stable
    step.chunked = make_chunked_train_step(apply_fn, optimizer, tc, mesh)

    def forward(p, tokens):
        return encode(p, tokens, cfg, mesh=sp_mesh)

    return forward, params, opt_state, step

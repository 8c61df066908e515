"""Pipeline parallelism: GPipe scheduling over a mesh axis.

Stages are homogeneous (stacked params with a leading stage dim, sharded
over the ``pipe`` axis); microbatches flow through the classic
(S + M − 1)-step schedule, activations rotating stage→stage with
``ppermute``.  Written with ``shard_map`` so the schedule and the
collective are explicit — the part of the parallelism inventory GSPMD
can't derive from shardings alone.

The reference has no model execution at all (SURVEY.md §2.3); this exists
for scaling the encoder beyond one device's memory.  `pipeline_forward`
runs any per-stage function; the encoder's homogeneous block stack fits
it directly (models/pipelined.py).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def pipeline_forward(
    stage_fn: Callable,
    stage_params,
    x_microbatches: jax.Array,
    mesh: Mesh,
    axis: str = "pipe",
    extras=None,
    batch_axis: str | None = None,
) -> jax.Array:
    """Run M microbatches through S pipelined stages.

    Differentiable (the schedule is a ``lax.scan``), so it can sit inside a
    training step — the encoder integration in models/train.py runs dp×pp
    by sharding the microbatch dim over ``batch_axis`` while activations
    rotate over ``axis``.

    Args:
        stage_fn: ``(params_one_stage, x) -> y`` — or, when ``extras`` is
            given, ``(params_one_stage, x, extra) -> y`` — with
            ``y.shape == x.shape`` (homogeneous stages — the
            transformer-block case).
        stage_params: pytree whose leaves have leading dim S; sharded over
            ``axis`` so each device holds exactly its stage's weights.
        x_microbatches: ``[M, mb, ...]`` input microbatches.
        mesh: mesh containing ``axis`` of size S.
        extras: optional pytree of ``[M, mb, ...]`` per-microbatch side
            inputs (attention masks) that follow each microbatch through
            every stage unchanged.
        batch_axis: optional mesh axis to shard the per-microbatch batch
            dim (dim 1) over — data parallelism inside the pipeline.

    Returns:
        ``[M, mb, ...]`` outputs.
    """
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]
    x_spec = P(None, batch_axis) if batch_axis else P()

    def spmd(params_local, xs, extras_local):
        sid = jax.lax.axis_index(axis)
        params_l = jax.tree_util.tree_map(lambda p: p[0], params_local)
        buf = jnp.zeros_like(xs[0])
        outs = jnp.zeros_like(xs)

        def step(carry, t):
            buf, outs = carry
            mb = t - sid
            active = (mb >= 0) & (mb < M)
            mb_c = jnp.clip(mb, 0, M - 1)
            # stage 0 ingests fresh microbatches; later stages consume the
            # activation rotated in from the previous stage last step
            inp = jnp.where(sid == 0, xs[mb_c], buf)
            if extras_local is None:
                y = stage_fn(params_l, inp)
            else:
                ex = jax.tree_util.tree_map(lambda e: e[mb_c], extras_local)
                y = stage_fn(params_l, inp, ex)
            y = jnp.where(active, y, buf)
            outs = jnp.where(
                active & (sid == S - 1), outs.at[mb_c].set(y), outs
            )
            buf = jax.lax.ppermute(
                y, axis, [(i, (i + 1) % S) for i in range(S)]
            )
            return (buf, outs), None

        (_, outs), _ = jax.lax.scan(
            step, (buf, outs), jnp.arange(S + M - 1)
        )
        # only the last stage holds real outputs; psum replicates them
        # (all other stages contribute zeros)
        return jax.lax.psum(jnp.where(sid == S - 1, outs, 0.0), axis)

    fn = shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P(axis), x_spec, x_spec if extras is not None else P()),
        out_specs=x_spec,
        check_vma=False,
    )
    return fn(stage_params, x_microbatches, extras)

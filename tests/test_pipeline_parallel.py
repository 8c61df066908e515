"""GPipe pipeline_forward vs sequential stage application."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rag_challenge_2_tpu.parallel.mesh import make_mesh
from rag_challenge_2_tpu.parallel.pipeline import pipeline_forward

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _stage_fn(params, x):
    w, b = params["w"], params["b"]
    return jnp.tanh(x @ w + b)


def _stack_params(rng, S, d):
    return {
        "w": jnp.asarray(rng.normal(size=(S, d, d)).astype(np.float32) * 0.3),
        "b": jnp.asarray(rng.normal(size=(S, d)).astype(np.float32) * 0.1),
    }


@needs8
@pytest.mark.parametrize("S,M", [(4, 6), (8, 3), (2, 1)])
def test_pipeline_matches_sequential(rng, S, M):
    d, mb = 16, 4
    mesh = make_mesh({"pipe": S})
    params = _stack_params(rng, S, d)
    xs = jnp.asarray(rng.normal(size=(M, mb, d)).astype(np.float32))

    got = pipeline_forward(_stage_fn, params, xs, mesh, axis="pipe")

    expected = np.asarray(xs)
    for s in range(S):
        p = {"w": np.asarray(params["w"][s]), "b": np.asarray(params["b"][s])}
        expected = np.tanh(expected @ p["w"] + p["b"])
    np.testing.assert_allclose(np.asarray(got), expected, rtol=2e-4, atol=2e-5)


@needs8
def test_pipeline_with_encoder_blocks():
    """The encoder's homogeneous block stack runs through the pipeline."""
    from rag_challenge_2_tpu.models.encoder import (
        EncoderConfig, block, init_block_params)

    # local rng: the shared session fixture makes bf16-tolerance comparisons
    # order-dependent across test runs
    rng = np.random.default_rng(42)

    cfg = EncoderConfig(vocab_bits=8, d_model=16, n_layers=4, n_heads=2,
                        d_ff=32, max_len=8, out_dim=8)
    S, M, mb, L = 4, 2, 2, 8
    mesh = make_mesh({"pipe": S})
    pad = jnp.ones((mb, L), bool)

    keys = jax.random.split(jax.random.PRNGKey(0), S)
    stage_params = [init_block_params(cfg, k) for k in keys]
    stacked = jax.tree_util.tree_map(
        lambda *ps: jnp.stack(ps), *stage_params
    )

    def apply(params, x):
        return block(params, x, pad[:x.shape[0]], cfg)[0].astype(jnp.float32)

    def stage_fn(params, x):
        return apply(params, x.astype(jnp.float32))
    xs = jnp.asarray(rng.normal(size=(M, mb, L, cfg.d_model)).astype(np.float32))
    got = pipeline_forward(stage_fn, stacked, xs, mesh, axis="pipe")

    expected = xs
    for s in range(S):
        p = stage_params[s]
        expected = jnp.stack([apply(p, expected[m]) for m in range(M)])
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(expected, np.float32),
        rtol=6e-2, atol=6e-2,  # 4 bf16 blocks compound rounding
    )


@needs8
def test_encode_pipelined_matches_plain(rng):
    """GPipe block-stack forward == the plain encoder on the same params."""
    from rag_challenge_2_tpu.models.encoder import EncoderConfig, encode, init_params
    from rag_challenge_2_tpu.models.pipelined import encode_pipelined

    cfg = EncoderConfig(vocab_bits=10, d_model=32, n_layers=4, n_heads=4,
                        d_ff=64, max_len=16, out_dim=16)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(8, 12)).astype(np.int32))
    tokens = tokens.at[3, 6:].set(-1)  # a padded row

    ref = encode(params, tokens, cfg)
    mesh = make_mesh({"data": 2, "pipe": 4})
    got = encode_pipelined(cfg, params, tokens, mesh, n_micro=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-2, atol=2e-2)


@needs8
def test_train_step_dp_pp(rng):
    """One InfoNCE step through the GPipe forward on a data×pipe mesh."""
    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training

    cfg = EncoderConfig(vocab_bits=10, d_model=32, n_layers=2, n_heads=4,
                        d_ff=64, max_len=16, out_dim=16)
    mesh = make_mesh({"data": 4, "pipe": 2})
    module, params, opt_state, step = init_training(
        cfg, TrainConfig(pp_microbatches=2), mesh
    )
    q = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(8, 12)).astype(np.int32))
    d = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(8, 12)).astype(np.int32))
    p0 = params["params"]["block0"]["mlp_in"]["kernel"]
    params2, opt_state, metrics = step(params, opt_state, q, d)
    assert np.isfinite(float(metrics["loss"]))
    # pipelined blocks actually receive gradient
    p1 = params2["params"]["block0"]["mlp_in"]["kernel"]
    assert not np.allclose(np.asarray(p0), np.asarray(p1))
    p1b = params2["params"]["block1"]["mlp_in"]["kernel"]
    p0b = params["params"]["block1"]["mlp_in"]["kernel"]
    assert not np.allclose(np.asarray(p0b), np.asarray(p1b))

"""Dense top-k vs numpy oracle (SURVEY.md §4 test strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rag_challenge_2_tpu.ops.topk import dense_topk


def _oracle(q, emb, k, mask=None):
    scores = q @ emb.T
    if mask is not None:
        scores = np.where(mask[None, :] if mask.ndim == 1 else mask, scores, -np.inf)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    return vals, idx


@pytest.mark.parametrize("B,N,D,k", [(4, 1000, 64, 10), (1, 256, 32, 5), (8, 2048, 128, 30)])
def test_xla_topk_matches_oracle(rng, B, N, D, k):
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    vals, idx = dense_topk(jnp.asarray(q), jnp.asarray(emb), k, impl="xla")
    ov, oi = _oracle(q, emb, k)
    np.testing.assert_allclose(np.asarray(vals), ov, rtol=1e-5, atol=1e-5)
    # indices may differ on exact ties; compare score sets instead of ids
    np.testing.assert_allclose(
        np.sort(np.asarray(vals), axis=1), np.sort(ov, axis=1), rtol=1e-5, atol=1e-5
    )


def test_topk_with_row_mask(rng):
    B, N, D, k = 3, 500, 32, 8
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = rng.random(N) > 0.5
    vals, idx = dense_topk(jnp.asarray(q), jnp.asarray(emb), k, mask=jnp.asarray(mask))
    assert mask[np.asarray(idx)].all(), "masked rows must never be returned"
    ov, _ = _oracle(q, emb, k, mask)
    np.testing.assert_allclose(np.asarray(vals), ov, rtol=1e-5, atol=1e-5)


def test_topk_per_query_mask(rng):
    B, N, D, k = 2, 300, 16, 5
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = rng.random((B, N)) > 0.3
    vals, idx = dense_topk(jnp.asarray(q), jnp.asarray(emb), k, mask=jnp.asarray(mask))
    idxn = np.asarray(idx)
    for b in range(B):
        assert mask[b, idxn[b]].all()


def test_topk_k_larger_than_n(rng):
    q = rng.normal(size=(2, 16)).astype(np.float32)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    vals, idx = dense_topk(jnp.asarray(q), jnp.asarray(emb), 20, impl="xla")
    assert vals.shape == (2, 8)


# ---------------------------------------------------------------- blocked scan

def test_blocked_topk_bit_identical_to_xla(rng):
    """blocked_topk must be BIT-identical to the one-shot path — values,
    indices, and lowest-index tie-breaks — including a non-divisible tail
    block (the clamp+re-mask overlap)."""
    from rag_challenge_2_tpu.ops.topk import _xla_topk, blocked_topk

    B, N, D, k = 5, 1337, 32, 11          # N % block != 0 → clamped tail
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    # manufacture exact ties across block boundaries
    emb[500] = emb[100]
    emb[900] = emb[100]
    xv, xi = _xla_topk(jnp.asarray(q), jnp.asarray(emb), None, k)
    bv, bi = blocked_topk(jnp.asarray(q), jnp.asarray(emb), k, block=256)
    np.testing.assert_array_equal(np.asarray(xv), np.asarray(bv))
    np.testing.assert_array_equal(np.asarray(xi), np.asarray(bi))


@pytest.mark.parametrize("mask_kind", ["row", "per_query"])
def test_blocked_topk_masks(rng, mask_kind):
    from rag_challenge_2_tpu.ops.topk import _xla_topk, blocked_topk

    B, N, D, k = 3, 700, 16, 6
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = (
        rng.random(N) > 0.4 if mask_kind == "row" else rng.random((B, N)) > 0.4
    )
    xv, xi = _xla_topk(jnp.asarray(q), jnp.asarray(emb), jnp.asarray(mask), k)
    bv, bi = blocked_topk(
        jnp.asarray(q), jnp.asarray(emb), k, mask=jnp.asarray(mask), block=128
    )
    np.testing.assert_array_equal(np.asarray(xv), np.asarray(bv))
    np.testing.assert_array_equal(np.asarray(xi), np.asarray(bi))


def test_blocked_topk_int8_matches_one_shot(rng):
    """int8 store: blocked scan == one-shot int8_topk (same quantized-dot
    scheme per block), and int8_topk itself routes large N to the scan."""
    from rag_challenge_2_tpu.ops.quant import int8_scores, quantize_rows
    from rag_challenge_2_tpu.ops.topk import blocked_topk

    B, N, D, k = 4, 999, 32, 9
    q = rng.normal(size=(B, D)).astype(np.float32)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    emb8, scale = quantize_rows(jnp.asarray(x))
    one = np.asarray(int8_scores(jnp.asarray(q), emb8, scale))
    ov = np.sort(one, axis=1)[:, ::-1][:, :k]
    bv, bi = blocked_topk(jnp.asarray(q), emb8, k, row_scale=scale, block=250)
    np.testing.assert_allclose(np.asarray(bv), ov, rtol=1e-6, atol=1e-6)
    # returned indices score exactly the returned values
    np.testing.assert_allclose(
        np.take_along_axis(one, np.asarray(bi), axis=1), np.asarray(bv),
        rtol=1e-6, atol=1e-6,
    )


def test_blocked_topk_fully_masked_query(rng):
    from rag_challenge_2_tpu.ops.topk import blocked_topk

    B, N, D, k = 2, 300, 16, 4
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0, :50] = True                    # query 1 has zero eligible rows
    bv, bi = blocked_topk(
        jnp.asarray(q), jnp.asarray(emb), k, mask=jnp.asarray(mask), block=64
    )
    assert (np.asarray(bv)[1] < -1e37).all()
    assert (np.asarray(bi)[0] < 50).all()


# -------------------------------------------------------------- two-stage


def test_approx_topk_contract(rng):
    """approx_topk: dense_topk contract (shapes, mask, int8) with
    recall governed by recall_target.  On the CPU (and the GPU)
    lax.approx_max_k is an exact fallback, so results must equal the
    exact scan here."""
    from rag_challenge_2_tpu.ops.quant import quantize_rows
    from rag_challenge_2_tpu.ops.topk import approx_topk, dense_topk

    B, N, D, k = 5, 4096, 64, 10
    q = rng.normal(size=(B, D)).astype(np.float32)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    mask = rng.random(N) > 0.3
    av, ai = approx_topk(
        jnp.asarray(q), jnp.asarray(emb), k, mask=jnp.asarray(mask)
    )
    assert av.shape == (B, k) and ai.shape == (B, k) and ai.dtype == jnp.int32
    assert mask[np.asarray(ai)].all(), "masked rows must never be returned"
    xv, _ = dense_topk(jnp.asarray(q), jnp.asarray(emb), k,
                       mask=jnp.asarray(mask), impl="xla")
    np.testing.assert_allclose(np.asarray(av), np.asarray(xv), rtol=1e-5)
    # int8 store path
    e8, scale = quantize_rows(jnp.asarray(emb))
    av8, ai8 = approx_topk(jnp.asarray(q), e8, k, row_scale=scale)
    v8, i8 = dense_topk(jnp.asarray(q), e8, k, row_scale=scale)
    np.testing.assert_allclose(np.asarray(av8), np.asarray(v8), rtol=1e-5)
    with pytest.raises(ValueError):
        approx_topk(jnp.asarray(q), e8, k)  # int8 without row_scale


def test_large_topk_from_scores_modes(rng):
    """Exact mode = lax.top_k parity; approx_rt mode honors the contract
    (sorted desc, valid indices; exact on the CPU fallback)."""
    from rag_challenge_2_tpu.ops.topk import large_topk_from_scores

    B, N, k = 4, 3000, 7
    s = rng.normal(size=(B, N)).astype(np.float32)
    ev, ei = large_topk_from_scores(jnp.asarray(s), k)
    ov = np.sort(s, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(np.asarray(ev), ov, rtol=1e-6)
    av, ai = large_topk_from_scores(jnp.asarray(s), k, approx_rt=0.99)
    a_v, a_i = np.asarray(av), np.asarray(ai)
    assert (np.diff(a_v, axis=1) <= 1e-6).all()
    np.testing.assert_allclose(
        np.take_along_axis(s, a_i, axis=1), a_v, rtol=1e-6
    )

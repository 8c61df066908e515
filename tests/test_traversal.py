"""SSG / Triangulation traversal vs a numpy oracle implementing the
reference algorithms (reference src/retrieval.py:585-806) verbatim."""

import numpy as np
import jax.numpy as jnp
import pytest

from rag_challenge_2_tpu.retrieval.traversal import traverse, emit_hits


def _oracle_ssg(emb, mask, anchor, max_hops, neighbor_k):
    """Reference _ssg_search (src/retrieval.py:585-688) on numpy, with the
    documented first-hop-exempt deviation (the reference's prev=1.0 seed
    makes SSG a no-op on unit-norm embeddings — see traversal.py)."""
    visited = {anchor}
    path = [anchor]
    cur = anchor
    prev_sim = -np.inf
    for _ in range(max_hops):
        scores = emb[cur] @ emb.T
        scores[~mask] = -np.inf
        order = np.argsort(-scores, kind="stable")[: neighbor_k + 1]
        cands = [(scores[i], i) for i in order if i not in visited and np.isfinite(scores[i])]
        if not cands:
            break
        best_sim, best = max(cands, key=lambda t: (t[0], -t[1]))
        if best_sim <= prev_sim:
            break
        visited.add(best)
        path.append(best)
        cur = best
        prev_sim = best_sim
    return path


def _oracle_tri(emb, q, mask, anchor, max_hops, neighbor_k):
    """Reference _triangulation_search (src/retrieval.py:690-806) on numpy."""
    visited = {anchor}
    path = [anchor]
    cur = anchor
    for _ in range(max_hops):
        scores = emb[cur] @ emb.T
        scores[~mask] = -np.inf
        order = np.argsort(-scores, kind="stable")[: neighbor_k + 1]
        cands = []
        for i in order:
            if i in visited or not np.isfinite(scores[i]):
                continue
            centroid = (q + emb[cur] + emb[i]) / 3.0
            cscore = 1.0 / (1.0 + np.linalg.norm(centroid - q))
            cands.append((cscore, i))
        if not cands:
            break
        _, best = max(cands, key=lambda t: (t[0], -t[1]))
        visited.add(best)
        path.append(best)
        cur = best
    return path


def _mk(rng, n=200, d=32):
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssg_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    emb = _mk(rng)
    mask = np.ones(emb.shape[0], bool)
    anchors = np.array([0, 17, 42, 99], np.int32)
    q = emb[anchors] + 0.01 * rng.normal(size=(4, emb.shape[1])).astype(np.float32)
    res = traverse(jnp.asarray(emb), jnp.asarray(anchors), jnp.asarray(q),
                   jnp.asarray(mask), max_hops=4, neighbor_k=10, mode="ssg")
    for a, anchor in enumerate(anchors):
        exp = _oracle_ssg(emb.copy(), mask, int(anchor), 4, 10)
        got = [int(x) for x in np.asarray(res.path[a]) if x >= 0]
        assert got == exp, (a, got, exp)


@pytest.mark.parametrize("seed", [0, 3])
def test_triangulation_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    emb = _mk(rng)
    mask = np.ones(emb.shape[0], bool)
    anchors = np.array([5, 60, 150], np.int32)
    q = rng.normal(size=(3, emb.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    res = traverse(jnp.asarray(emb), jnp.asarray(anchors), jnp.asarray(q),
                   jnp.asarray(mask), max_hops=4, neighbor_k=12, mode="triangulation")
    for a, anchor in enumerate(anchors):
        exp = _oracle_tri(emb.copy(), q[a], mask, int(anchor), 4, 12)
        got = [int(x) for x in np.asarray(res.path[a]) if x >= 0]
        assert got == exp, (a, got, exp)


def test_traversal_respects_doc_mask():
    rng = np.random.default_rng(7)
    emb = _mk(rng, n=100)
    mask = np.zeros((2, 100), bool)
    mask[0, :50] = True
    mask[1, 50:] = True
    anchors = np.array([3, 60], np.int32)
    q = emb[anchors]
    res = traverse(jnp.asarray(emb), jnp.asarray(anchors), jnp.asarray(q),
                   jnp.asarray(mask), max_hops=4, neighbor_k=8, mode="ssg")
    p0 = [int(x) for x in np.asarray(res.path[0]) if x >= 0]
    p1 = [int(x) for x in np.asarray(res.path[1]) if x >= 0]
    assert all(i < 50 for i in p0)
    assert all(i >= 50 for i in p1)


def test_inactive_anchor():
    rng = np.random.default_rng(1)
    emb = _mk(rng, n=50)
    res = traverse(jnp.asarray(emb), jnp.asarray(np.array([-1, 2], np.int32)),
                   jnp.asarray(emb[[0, 2]]), jnp.asarray(np.ones(50, bool)),
                   max_hops=3, neighbor_k=5, mode="ssg")
    assert not bool(res.valid[0].any())
    assert bool(res.valid[1, 0])


def test_emit_hits_rescore():
    rng = np.random.default_rng(2)
    emb = _mk(rng, n=80)
    anchors = np.array([10], np.int32)
    q = rng.normal(size=(1, emb.shape[1])).astype(np.float32)
    res = traverse(jnp.asarray(emb), jnp.asarray(anchors), jnp.asarray(q),
                   jnp.asarray(np.ones(80, bool)), max_hops=3, neighbor_k=6, mode="triangulation")
    rows, sims = emit_hits(jnp.asarray(emb), jnp.asarray(q), res)
    rows, sims = np.asarray(rows), np.asarray(sims)
    for j in range(rows.shape[1]):
        if rows[0, j] >= 0:
            np.testing.assert_allclose(sims[0, j], q[0] @ emb[rows[0, j]], rtol=1e-4)


@pytest.mark.parametrize("mode", ["ssg", "triangulation"])
@pytest.mark.parametrize("quant", [False, True])
def test_windowed_matches_full_traversal(mode, quant):
    """traverse_windowed over contiguous doc windows must reproduce
    traverse with the equivalent [A, N] doc masks — paths, scores, and
    candidate records, global row ids."""
    from rag_challenge_2_tpu.retrieval.traversal import traverse_windowed

    rng = np.random.default_rng(11)
    G, CPD, D, A = 3, 40, 32, 5            # 3 docs x 40 chunks, 5 anchors each
    N = G * CPD + 8                        # trailing pad rows outside any doc
    emb = _mk(rng, n=N, d=D)
    row_scale = None
    emb_j = jnp.asarray(emb)
    if quant:
        from rag_challenge_2_tpu.ops.quant import quantize_rows

        emb_j, scale = quantize_rows(jnp.asarray(emb))
        row_scale = scale
    win_start = np.array([0, CPD, 2 * CPD], np.int32)
    win_len = np.full((G,), CPD, np.int32)
    anchors = np.stack([
        rng.integers(g * CPD, (g + 1) * CPD, size=A) for g in range(G)
    ]).astype(np.int32)
    anchors[1, 3] = -1                     # inactive anchor slot
    q = rng.normal(size=(G, A, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)

    W = 64                                 # static window > CPD, forces clamping
    got = traverse_windowed(
        emb_j, jnp.asarray(anchors), jnp.asarray(q),
        jnp.asarray(win_start), jnp.asarray(win_len), row_scale,
        window=W, max_hops=4, neighbor_k=8, mode=mode,
    )

    mask = np.zeros((G * A, N), bool)
    for g in range(G):
        mask[g * A : (g + 1) * A, g * CPD : (g + 1) * CPD] = True
    ref = traverse(
        emb_j, jnp.asarray(anchors.reshape(-1)),
        jnp.asarray(q.reshape(G * A, D)), jnp.asarray(mask), row_scale,
        max_hops=4, neighbor_k=8, mode=mode,
    )
    np.testing.assert_array_equal(np.asarray(got.path), np.asarray(ref.path))
    np.testing.assert_allclose(
        np.asarray(got.hop_score), np.asarray(ref.hop_score), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(got.cand_ids), np.asarray(ref.cand_ids))
    np.testing.assert_allclose(
        np.asarray(got.cand_scores), np.asarray(ref.cand_scores), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("mode", ["ssg", "triangulation"])
def test_approx_hop_wiring(mode, monkeypatch):
    """approx_rt routes hop-candidate selection through lax.approx_max_k
    (the 1M+/10M fast tier — engine SearchConfig.scan_rt).  On the CPU
    approx_max_k falls back to an exact sort, so with the width gate
    patched open both traverse and traverse_windowed must reproduce the
    exact-hop paths bit-for-bit."""
    import rag_challenge_2_tpu.retrieval.traversal as tv

    rng = np.random.default_rng(23)
    G, CPD, D, A = 2, 48, 32, 4
    N = G * CPD
    emb = _mk(rng, n=N, d=D)
    emb_j = jnp.asarray(emb)
    anchors = np.stack([
        rng.integers(g * CPD, (g + 1) * CPD, size=A) for g in range(G)
    ]).astype(np.int32)
    q = rng.normal(size=(G, A, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    win_start = jnp.asarray(np.array([0, CPD], np.int32))
    win_len = jnp.asarray(np.full((G,), CPD, np.int32))

    exact_w = tv.traverse_windowed(
        emb_j, jnp.asarray(anchors), jnp.asarray(q), win_start, win_len,
        None, window=CPD, max_hops=4, neighbor_k=8, mode=mode)
    mask = np.zeros((G * A, N), bool)
    for g in range(G):
        mask[g * A:(g + 1) * A, g * CPD:(g + 1) * CPD] = True
    exact_f = tv.traverse(
        emb_j, jnp.asarray(anchors.reshape(-1)),
        jnp.asarray(q.reshape(G * A, D)), jnp.asarray(mask),
        max_hops=4, neighbor_k=8, mode=mode)

    monkeypatch.setattr(tv, "HOP_APPROX_MIN_COLS", 1)
    apx_w = tv.traverse_windowed(
        emb_j, jnp.asarray(anchors), jnp.asarray(q), win_start, win_len,
        None, window=CPD, max_hops=4, neighbor_k=8, mode=mode,
        approx_rt=0.95)
    apx_f = tv.traverse(
        emb_j, jnp.asarray(anchors.reshape(-1)),
        jnp.asarray(q.reshape(G * A, D)), jnp.asarray(mask),
        max_hops=4, neighbor_k=8, mode=mode, approx_rt=0.95)

    np.testing.assert_array_equal(np.asarray(apx_w.path), np.asarray(exact_w.path))
    np.testing.assert_array_equal(np.asarray(apx_f.path), np.asarray(exact_f.path))
    np.testing.assert_allclose(
        np.asarray(apx_w.hop_score), np.asarray(exact_w.hop_score),
        rtol=1e-5, atol=1e-6)

"""chip_smoke.py's comparison helpers and device check, on the CPU at
tiny shapes (the script itself runs only on a GPU)."""

import types

import jax
import numpy as np
import pytest

import chip_smoke as cs


@pytest.mark.parametrize("case,ok", [
    ("equal", True),
    ("tie_swap", True),
    ("cutoff_swap", True),
    ("non_tie_swap", False),
    ("score_off", False),
])
def test_compare_topk(case, ok):
    ref_rows = np.array([7, 3, 9, 1])
    ref = np.array([0.9, 0.5, 0.5 + 5e-7, 0.1])
    rows, scores = ref_rows.copy(), ref.copy()
    if case == "tie_swap":
        rows[[1, 2]] = rows[[2, 1]]           # 3 and 9 tie within atol
    elif case == "cutoff_swap":
        rows[3] = 42                          # last place: tie at the cutoff
    elif case == "non_tie_swap":
        rows[[0, 1]] = rows[[1, 0]]
    elif case == "score_off":
        scores[0] += 1e-3
    if ok:
        diff, swaps = cs.compare_topk(rows, scores, ref_rows, ref, atol=1e-5)
        assert diff <= 1e-5 and swaps == int(case.endswith("swap")) * (
            2 if case == "tie_swap" else 1)
    else:
        with pytest.raises(cs.CheckFailed):
            cs.compare_topk(rows, scores, ref_rows, ref, atol=1e-5)


def test_numpy_topk_and_recall():
    rows, vals = cs.numpy_topk(np.array([0.2, 0.9, 0.9, -np.inf, 0.5]), 3)
    assert rows.tolist() == [1, 2, 4] and vals.tolist() == [0.9, 0.9, 0.5]
    assert cs.recall_at_k([[1, 2, 3]], [[3, 2, 9]]) == pytest.approx(2 / 3)


def test_require_gpu_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu(jax)
    fake = types.SimpleNamespace(
        default_backend=lambda: "gpu",
        devices=lambda: [types.SimpleNamespace(platform="gpu")])
    assert len(cs.require_gpu(fake)) == 1
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.require_gpu(fake, 4)


def test_bm25_oracle_and_check_on_tiny_corpus(tiny_corpus):
    """The numpy oracle equals the repo's scatter scorer, and check_bm25
    accepts both device scorers on the tiny corpus."""
    from rag_challenge_2_tpu.ops.bm25 import bm25_scores, encode_queries

    idx, *_ = tiny_corpus
    sp = idx.sparse
    qt = encode_queries(["金盘科技 营业收入", "页面2 chunk4", "doc0"], 16,
                        sp.vocab_bits)
    oracle = cs.bm25_oracle(sp.indptr, sp.chunk_ids, sp.tf, sp.df,
                            sp.chunk_len, qt, idx.n_pad)
    dense = np.asarray(bm25_scores(sp, qt, idx.n_pad))
    np.testing.assert_allclose(dense, oracle, rtol=1e-5, atol=1e-5)
    doc_id, valid = np.asarray(idx.doc_id), np.asarray(idx.valid)
    masks = np.stack([valid & (doc_id == d) for d in range(idx.n_docs)])
    msg = cs.check_bm25(jax, sp, qt, masks, idx.n_pad, sp.max_postings, oracle)
    assert "bm25_topk rows equal" in msg


def test_synthetic_texts_shape():
    from rag_challenge_2_tpu.models.encoder import tokenize_batch

    texts = cs.synthetic_texts(np.random.default_rng(0), 8, 50)
    lens = (tokenize_batch(texts, 512, 15) >= 0).sum(1)
    assert len(texts) == 8 and 200 <= lens.mean() <= 400
    rows = cs.unit_rows(np.random.default_rng(0), 5, 7)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, rtol=1e-6)

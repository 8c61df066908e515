"""Distributed top-k over an 8-device CPU mesh vs the single-device kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rag_challenge_2_tpu.ops.topk import dense_topk
from rag_challenge_2_tpu.parallel.mesh import make_mesh
from rag_challenge_2_tpu.parallel.sharded_search import sharded_dense_topk

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@needs_devices
@pytest.mark.parametrize("N,D,B,k", [(4096, 64, 4, 10), (1000, 32, 2, 7)])
def test_sharded_matches_single_device(rng, N, D, B, k):
    mesh = make_mesh({"data": 8})
    q = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    emb = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    sv, si = sharded_dense_topk(q, emb, k, mesh)
    xv, xi = dense_topk(q, emb, k, impl="xla")
    np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), rtol=1e-5, atol=1e-5)
    assert (np.asarray(si) == np.asarray(xi)).all(), "deterministic parity incl. ties"


@needs_devices
def test_sharded_with_mask(rng):
    mesh = make_mesh({"data": 8})
    N, D, B, k = 2048, 32, 3, 8
    q = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    emb = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    mask = rng.random(N) > 0.5
    sv, si = sharded_dense_topk(q, emb, k, mesh, mask=jnp.asarray(mask))
    assert mask[np.asarray(si)].all()
    xv, _ = dense_topk(q, emb, k, mask=jnp.asarray(mask), impl="xla")
    np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), rtol=1e-5, atol=1e-5)


@needs_devices
def test_sharded_uneven_rows(rng):
    # N not divisible by 8 exercises the pad path
    mesh = make_mesh({"data": 8})
    N, D, B, k = 1001, 16, 2, 5
    q = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    emb = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    sv, si = sharded_dense_topk(q, emb, k, mesh)
    assert (np.asarray(si) < N).all() and (np.asarray(si) >= 0).all()
    xv, xi = dense_topk(q, emb, k, impl="xla")
    np.testing.assert_allclose(np.asarray(sv), np.asarray(xv), rtol=1e-5, atol=1e-5)


@needs_devices
@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hierarchical_matches_flat_and_oracle(rng, shape):
    """Two-level merge (slice × device mesh) must be bit-identical to the
    flat merge AND the single-device kernel — including ties (SURVEY §5:
    all_gather within a node's devices, then across nodes)."""
    from rag_challenge_2_tpu.parallel.sharded_search import (
        hierarchical_dense_topk)

    n_slices, n_dev = shape
    mesh = make_mesh({"slice": n_slices, "device": n_dev})
    flat_mesh = make_mesh({"data": 8})
    N, D, B, k = 4096, 64, 4, 10
    q = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    emb = rng.normal(size=(N, D)).astype(np.float32)
    emb[100] = emb[200]  # planted exact tie — both merges must pick row 100
    emb = jnp.asarray(emb)
    hv, hi = hierarchical_dense_topk(q, emb, k, mesh)
    fv, fi = sharded_dense_topk(q, emb, k, flat_mesh)
    xv, xi = dense_topk(q, emb, k, impl="xla")
    np.testing.assert_allclose(np.asarray(hv), np.asarray(xv), rtol=1e-5, atol=1e-5)
    assert (np.asarray(hi) == np.asarray(fi)).all(), "hier == flat incl. ties"
    assert (np.asarray(hi) == np.asarray(xi)).all(), "hier == single-device"


@needs_devices
def test_hierarchical_int8_and_mask(rng):
    from rag_challenge_2_tpu.ops.quant import quantize_rows
    from rag_challenge_2_tpu.parallel.sharded_search import (
        hierarchical_dense_topk)

    mesh = make_mesh({"slice": 2, "device": 4})
    N, D, B, k = 1001, 32, 3, 8      # uneven rows: exercises the pad path
    q = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    emb = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    mask = jnp.asarray(rng.random(N) > 0.5)
    q8, sc = quantize_rows(emb)
    hv, hi = hierarchical_dense_topk(q, q8, k, mesh, mask=mask, row_scale=sc)
    assert np.asarray(mask)[np.asarray(hi)].all()
    flat_mesh = make_mesh({"data": 8})
    fv, fi = sharded_dense_topk(q, q8, k, flat_mesh, mask=mask, row_scale=sc)
    assert (np.asarray(hi) == np.asarray(fi)).all()
    np.testing.assert_allclose(np.asarray(hv), np.asarray(fv), rtol=1e-6)


@needs_devices
def test_engine_search_with_row_sharded_index(tiny_corpus, rng):
    """The full jitted query pipeline (search_device) runs with the corpus
    embedding matrix row-sharded over a mesh — GSPMD propagates the
    sharding through scoring/fusion (BASELINE config 5's single-graph
    hybrid query, validated on the virtual mesh)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

    idx, meta, reports, embs = tiny_corpus
    eng_plain = QueryEngine(idx, meta)
    q = embs[0][5][None, :].astype(np.float32)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True)
    base = eng_plain.materialize(
        eng_plain.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg
    )

    mesh = make_mesh({"data": 8})
    import dataclasses
    sharded_idx = dataclasses.replace(
        idx,
        emb=jax.device_put(idx.emb, NamedSharding(mesh, P("data", None))),
        valid=jax.device_put(idx.valid, NamedSharding(mesh, P("data"))),
    )
    eng_sharded = QueryEngine(sharded_idx, meta)
    got = eng_sharded.materialize(
        eng_sharded.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg
    )
    assert [r["rep_row"] for r in got] == [r["rep_row"] for r in base]
    for a, b in zip(got, base):
        assert abs(a["distance"] - b["distance"]) < 1e-4


@needs_devices
def test_sharded_int8_matches_single_device():
    """int8 shards: same distributed merge, 4x rows per HBM byte."""
    from rag_challenge_2_tpu.ops.quant import int8_topk, quantize_rows

    rng = np.random.default_rng(11)
    x = rng.normal(size=(1000, 64)).astype("float32")
    x /= (x ** 2).sum(1, keepdims=True) ** 0.5
    q = rng.normal(size=(4, 64)).astype("float32")
    q /= (q ** 2).sum(1, keepdims=True) ** 0.5
    emb8, sc = quantize_rows(jnp.asarray(x))

    mesh = make_mesh({"data": 8})
    vs, rs = sharded_dense_topk(jnp.asarray(q), emb8, 10, mesh, row_scale=sc)
    v1, r1 = int8_topk(jnp.asarray(q), emb8, sc, 10)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(v1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(rs), np.asarray(r1))


@needs_devices
@pytest.mark.parametrize("method", ["ssg", "triangulation", "hybrid_expansion"])
def test_engine_traversal_on_row_sharded_index(tiny_corpus, method):
    """Graph-traversal retrieval (anchor gathers + per-hop matvecs +
    visited masks) returns bit-identical rows when the corpus embedding
    matrix is row-sharded over the mesh — GSPMD inserts the collectives;
    no traversal-specific sharding code exists or is needed."""
    import dataclasses

    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig

    idx, meta, reports, embs = tiny_corpus
    eng_plain = QueryEngine(idx, meta)
    q = embs[0][5][None, :].astype(np.float32)
    cfg = SearchConfig(method=method, top_k=5, top_n=10, use_bm25=False)
    base = eng_plain.materialize(
        eng_plain.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg)

    mesh = make_mesh({"data": 8})
    sharded_idx = dataclasses.replace(
        idx,
        emb=jax.device_put(idx.emb, NamedSharding(mesh, P("data", None))),
        valid=jax.device_put(idx.valid, NamedSharding(mesh, P("data"))),
    )
    eng_sh = QueryEngine(sharded_idx, meta)
    got = eng_sh.materialize(
        eng_sh.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg)
    assert [r["rep_row"] for r in got] == [r["rep_row"] for r in base]
    for a, b in zip(got, base):
        assert abs(a["distance"] - b["distance"]) < 1e-4


def test_engine_hier_merge_through_product_graph(rng):
    """search_device(hier=...) runs the dense stage through the two-level
    merge (make_hierarchical_topk pair_mask mode) INSIDE the full hybrid
    graph — fused rows/scores must match the replicated engine (the merge
    exercised through the product graph, not standalone)."""
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rag_challenge_2_tpu.index import build_corpus_index
    from rag_challenge_2_tpu.retrieval.engine import QueryEngine, SearchConfig
    from tests.conftest import make_reports

    # 3 docs x 16 chunks = 48 rows — divisible by the 2x4 (slice, device)
    # grid (shard_map needs even shards; production pads via store layout)
    reports, embs = make_reports(rng, chunks_per_page=4)
    idx, meta = build_corpus_index(reports, embs, vocab_bits=16)
    assert idx.emb.shape[0] % 8 == 0

    q = embs[0][5][None, :].astype(np.float32)
    cfg = SearchConfig(method="basic", top_k=5, top_n=10, use_bm25=True)
    eng_plain = QueryEngine(idx, meta)
    base = eng_plain.materialize(
        eng_plain.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg
    )

    mesh = make_mesh({"slice": 2, "device": 4})
    sharded_idx = dataclasses.replace(
        idx,
        emb=jax.device_put(
            idx.emb, NamedSharding(mesh, P(("slice", "device"), None))),
        valid=jax.device_put(
            idx.valid, NamedSharding(mesh, P(("slice", "device")))),
    )
    eng = QueryEngine(sharded_idx, meta, hier=(mesh, "slice", "device"))
    got = eng.materialize(
        eng.search(q, "金盘科技", cfg=cfg, query_texts=["营业收入"]), cfg
    )
    assert [r["rep_row"] for r in got] == [r["rep_row"] for r in base]
    for a, b in zip(got, base):
        assert abs(a["distance"] - b["distance"]) < 1e-4
        assert a["method_count"] == b["method_count"]

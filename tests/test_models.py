"""Encoder forward + sharded contrastive training on the 8-device CPU mesh."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rag_challenge_2_tpu.models.encoder import (
    EmbeddingModel,
    EncoderConfig,
    encode,
    init_params,
    tokenize_batch,
)

SMALL = EncoderConfig(
    vocab_bits=10, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_len=32, out_dim=16
)


def test_forward_unit_norm_and_shape():
    m = EmbeddingModel(SMALL)
    ids = jnp.asarray(tokenize_batch(["金盘科技营业收入", "hello world"], 32, 10))
    out = m.embed_tokens(ids)
    assert out.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(out), axis=1), 1.0, rtol=1e-5)


def test_padding_invariance():
    # same text, different amounts of trailing padding → same embedding
    m = EmbeddingModel(SMALL)
    ids1 = jnp.asarray(tokenize_batch(["营业收入增长"], 16, 10))
    ids2 = jnp.asarray(tokenize_batch(["营业收入增长"], 32, 10))
    e1 = np.asarray(m.embed_tokens(ids1))[0]
    e2 = np.asarray(m.embed_tokens(ids2))[0]
    np.testing.assert_allclose(e1, e2, atol=2e-2)


def test_embed_batching_consistent():
    m = EmbeddingModel(SMALL)
    texts = [f"文本 {i} 营业收入" for i in range(7)]
    full = m.embed(texts, batch_size=256)
    split = m.embed(texts, batch_size=3)
    assert full.shape == (7, 16)
    np.testing.assert_allclose(full, split, atol=2e-2)


def test_sharded_train_step_runs_and_learns():
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh({"data": 2, "model": 2})
    module, params, opt_state, step = init_training(SMALL, TrainConfig(lr=1e-2), mesh)
    rng = np.random.default_rng(0)
    B = 8
    q = rng.integers(0, 1024, size=(B, 16)).astype(np.int32)
    d = q.copy()  # matched pairs: easy task, loss should drop
    losses = []
    for _ in range(5):
        params, opt_state, metrics = step(params, opt_state, jnp.asarray(q), jnp.asarray(d))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_param_sharding_specs_cover_all_params():
    from rag_challenge_2_tpu.parallel.mesh import encoder_param_spec

    m = EmbeddingModel(SMALL)
    leaves = jax.tree_util.tree_leaves_with_path(m.params)
    for path, leaf in leaves:
        spec = encoder_param_spec(path, leaf)  # must not raise
        # spec rank never exceeds leaf rank
        assert len([s for s in spec if s is not None]) <= leaf.ndim


def test_sequence_parallel_train_step():
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh({"data": 2, "model": 2})
    # q == d starts near zero loss; lr 1e-2 overshoots it on the first
    # Adam step, 3e-3 descends from every init drawn so far
    module, params, opt_state, step = init_training(
        SMALL, TrainConfig(lr=3e-3, sequence_parallel=True), mesh
    )
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 1024, size=(8, 16)).astype(np.int32))
    losses = []
    for _ in range(4):
        params, opt_state, metrics = step(params, opt_state, q, q)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    # sp and non-sp models compute the same function
    out_sp = module(params, q)
    out_plain = encode(params, q, SMALL)
    np.testing.assert_allclose(np.asarray(out_sp), np.asarray(out_plain), atol=2e-2)


def test_moe_encoder_forward_and_ep_training():
    from rag_challenge_2_tpu.models.train import TrainConfig, init_training
    from rag_challenge_2_tpu.parallel.mesh import make_mesh

    cfg_moe = EncoderConfig(vocab_bits=10, d_model=32, n_layers=2, n_heads=4,
                            d_ff=64, max_len=32, out_dim=16, moe_experts=4)
    m = EmbeddingModel(cfg_moe)
    ids = jnp.asarray(tokenize_batch(["营业收入增长", "研发费用"], 32, 10))
    out = m.embed_tokens(ids)
    assert out.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(out), axis=1), 1.0, rtol=1e-5)
    # expert weights present and sharded over 'model' on a mesh
    flat = jax.tree_util.tree_leaves_with_path(m.params)
    moe_leaves = [(p, l) for p, l in flat if "moe" in str(p)]
    assert any(l.ndim == 3 and l.shape[0] == 4 for _, l in moe_leaves)

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh({"data": 2, "model": 2})
    module, params, opt_state, step = init_training(
        cfg_moe, TrainConfig(lr=1e-2, sequence_parallel=True), mesh
    )
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 1024, size=(8, 16)).astype(np.int32))
    losses = []
    for _ in range(4):
        params, opt_state, metrics = step(params, opt_state, q, q)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_moe_dispatch_capacity():
    from rag_challenge_2_tpu.models.moe import top2_dispatch

    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(size=(16, 4)).astype(np.float32))
    dispatch, combine, aux = top2_dispatch(logits, capacity=3)
    d = np.asarray(dispatch)
    # each expert accepts at most `capacity` tokens
    assert (d.sum(axis=(0, 2)) <= 2 * 3 + 1e-6).all()
    per_slot = d.sum(axis=0)  # [E, C] — each slot holds ≤1 token
    assert (per_slot <= 1 + 1e-6).all()
    # each token dispatched to ≤2 experts
    assert (d.sum(axis=(1, 2)) <= 2 + 1e-6).all()
    assert float(aux) > 0


def test_ict_pretraining_learns_and_roundtrips(tmp_path):
    from rag_challenge_2_tpu.models.pretrain import (
        PretrainConfig, ict_pairs, load_params, pretrain_encoder, save_params,
    )
    from rag_challenge_2_tpu.models.train import TrainConfig

    texts = [
        f"金盘科技{2020+i}年度营业收入为{40+i*7}亿元，同比增长{5+i}个百分点，"
        f"主要来自干式变压器与储能产品线的销售增长。" for i in range(20)
    ]
    rng = np.random.default_rng(0)
    qs, ps = ict_pairs(texts, 8, rng)
    assert len(qs) == 8 and all(q and p for q, p in zip(qs, ps))
    # query span removed from its passage
    assert all(q not in p or len(q) < 6 for q, p in zip(qs, ps))

    model, stats = pretrain_encoder(
        texts,
        enc_cfg=SMALL,
        pre_cfg=PretrainConfig(steps=30, batch_size=16, max_len=32,
                               bm25_neighbor_prob=0.0, hard_batch_prob=0.0),
        train_cfg=TrainConfig(lr=3e-3),
        log_every=29,
    )
    hist = stats["history"]
    assert hist[-1]["loss"] < hist[0]["loss"], hist

    path = tmp_path / "params.npz"
    save_params(model, path)
    m2 = load_params(EmbeddingModel(SMALL), path)
    a = model.embed(["营业收入增长"], batch_size=4)
    b = m2.embed(["营业收入增长"], batch_size=4)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_moe_aux_loss_reaches_objective():
    from rag_challenge_2_tpu.models.train import TrainConfig, contrastive_loss

    cfg_moe = EncoderConfig(vocab_bits=8, d_model=16, n_layers=2, n_heads=2,
                            d_ff=32, max_len=16, out_dim=8, moe_experts=4)
    params = init_params(cfg_moe, jax.random.PRNGKey(0))
    q = jnp.asarray(np.random.default_rng(0).integers(0, 256, size=(4, 8)).astype(np.int32))
    apply_fn = lambda p, t: encode(p, t, cfg_moe, with_aux=True)
    loss0, m0 = contrastive_loss(params, apply_fn, q, q, 0.05, moe_aux_weight=0.0)
    loss1, m1 = contrastive_loss(params, apply_fn, q, q, 0.05, moe_aux_weight=1.0)
    assert float(m1["moe_aux"]) > 0, "aux term must be collected"
    assert float(loss1) > float(loss0), "aux term must enter the objective"


FIXTURE = Path(__file__).parent / "data" / "encoder_fixture.npz"
FIXTURE_CFG = dict(vocab_bits=8, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                   max_len=16, out_dim=16)


def _fixture_params(z, name):
    """Rebuild the nested param tree from the fixture's flat path keys."""
    tree = {}
    for key in z.files:
        if not key.startswith(name + ":params/"):
            continue
        *parents, leaf = key.split(":", 1)[1].split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(z[key])
    return tree


@pytest.mark.parametrize("name,moe,dtype", [
    ("dense", 0, "bf16"), ("dense", 0, "f32"), ("moe", 4, "bf16"), ("moe", 4, "f32"),
])
def test_encoder_matches_recorded_fixture(name, moe, dtype):
    """The plain-JAX encoder reproduces outputs recorded once from the
    original module-based implementation (tests/data/encoder_fixture.npz:
    params under the same key paths, token batch with padded rows, and
    expected embeddings for bf16 and f32 activations), so every saved
    ``encoder_params.npz`` keeps its meaning."""
    z = np.load(FIXTURE)
    cfg = EncoderConfig(moe_experts=moe, **FIXTURE_CFG)
    if dtype == "f32":
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    params = _fixture_params(z, name)
    want_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, init_params(cfg, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: a.shape, params) == want_shapes
    with jax.default_matmul_precision("highest"):
        got, aux = encode(params, jnp.asarray(z["tokens"]), cfg, with_aux=True)
    cos = np.sum(np.asarray(got) * z[f"{name}@{dtype}"], axis=1)
    assert cos.min() >= 0.999, cos
    if moe:
        np.testing.assert_allclose(float(aux), float(z["moe@aux"]), rtol=1e-3)
    else:
        assert float(aux) == 0.0


def test_length_bucketing_preserves_embeddings():
    """embed() buckets sequence length to the batch's longest text (pow2,
    min 32, cap max_len); the pooled embedding must match full-max_len
    padding (pad positions are masked out of attention and pooling)."""
    texts = ["营业收入", "金盘科技2024年报"]
    # bucketing math: 11 tokens → L = 32, not the 512 cap
    ids_bkt = tokenize_batch(texts, 512, 10, bucket_len=True)
    assert ids_bkt.shape[1] == 32
    # model-level invariance through the public path (embed() buckets):
    # same embeddings as explicit full-max_len token batches
    m = EmbeddingModel(SMALL)
    e_full = np.asarray(m.embed_tokens(
        jnp.asarray(tokenize_batch(texts, 32, 10, bucket_len=False))))
    out = m.embed(texts)
    np.testing.assert_allclose(out, e_full, atol=2e-2)


def test_contrastive_pairs_mix_and_determinism():
    from rag_challenge_2_tpu.models.pretrain import contrastive_pairs

    texts = [
        f"金盘科技{2020+i}年度营业收入为{40+i*7}亿元，同比增长{5+i}个百分点，"
        f"主要来自干式变压器与储能产品线的销售增长。" for i in range(10)
    ]
    qs1, ps1 = contrastive_pairs(texts, 64, np.random.default_rng(7))
    qs2, ps2 = contrastive_pairs(texts, 64, np.random.default_rng(7))
    assert qs1 == qs2 and ps1 == ps2          # deterministic in the rng

    # crop pairs overlap: with crop_prob=1 every query is a substring of its
    # chunk and shares ≥ some characters with its passage
    qs, ps = contrastive_pairs(texts, 32, np.random.default_rng(0), crop_prob=1.0)
    for q, p in zip(qs, ps):
        src = [t for t in texts if q in t]
        assert src, "crop query must be a contiguous substring of a chunk"
        assert p in src[0] or any(q in t and p in t for t in texts)
        assert len(q) >= len(src[0]) // 2 and len(p) >= len(src[0]) // 2

    # keep_span_prob=1: ICT span survives inside the passage
    qs, ps = contrastive_pairs(
        texts, 32, np.random.default_rng(0), crop_prob=0.0, keep_span_prob=1.0
    )
    assert all(q in p for q, p in zip(qs, ps))

    # keep_span_prob=0 reproduces removal-only ICT (span cut out)
    qs, ps = contrastive_pairs(
        texts, 32, np.random.default_rng(0), crop_prob=0.0, keep_span_prob=0.0
    )
    assert all(q not in p or len(q) < 6 for q, p in zip(qs, ps))


def test_pair_sampler_bm25_distill_modes():
    """BM25-mined positives: the neighbor positive is a DIFFERENT chunk
    sharing tokens with the query crop; hard batches are one seed's
    lexical neighborhood."""
    from rag_challenge_2_tpu.models.pretrain import PairSampler, PretrainConfig

    texts = [
        f"公司A {y}年 营业收入 为 {v} 亿元 较上年 增长" for y, v in
        zip(range(2015, 2030), range(10, 25))
    ] + [
        f"公司B {y}年 净利润 达到 {v} 亿元 同比 下降" for y, v in
        zip(range(2015, 2030), range(30, 45))
    ]
    cfg = PretrainConfig(batch_size=16, bm25_neighbor_prob=1.0, min_span=6)
    s = PairSampler(texts, cfg)
    rng = np.random.default_rng(0)
    qs, ps, tg = s.sample(rng)
    assert tg is None
    assert len(qs) == len(ps) == 16
    assert all(p in texts for p in ps), "positives are real corpus chunks"
    # with neighbor_prob=1 most positives should not be the crop's source;
    # all must share at least one token with the query crop (BM25-mined)
    import re
    diff = sum(1 for q, p in zip(qs, ps) if q not in p)
    assert diff >= 8

    # hard batch: all examples drawn from one lexical neighborhood
    cfg2 = PretrainConfig(batch_size=8, hard_batch_prob=1.0, min_span=6,
                          crop_prob=1.0)
    s2 = PairSampler(texts, cfg2)
    qs2, ps2, _ = s2.sample(np.random.default_rng(1))
    srcs = {next(t for t in texts if p in t or t in p or p == t) for p in ps2}
    assert len(qs2) == 8

    # mining off reproduces the crop/ICT distribution (no sparse build)
    cfg3 = PretrainConfig(batch_size=8, crop_prob=1.0,
                          bm25_neighbor_prob=0.0, hard_batch_prob=0.0)
    s3 = PairSampler(texts, cfg3)
    assert s3._sparse is None
    qs3, ps3, _ = s3.sample(np.random.default_rng(2))
    assert all(any(q in t for t in texts) for q in qs3)

def test_pair_sampler_listwise_soft_targets():
    """soft_target_weight>0: sample() emits a [B, B] row-stochastic matrix
    mixing identity with the BM25 teacher softmax; a query's strongest
    off-diagonal teacher mass lands on a lexically-close passage."""
    from rag_challenge_2_tpu.models.pretrain import PairSampler, PretrainConfig

    texts = [
        f"公司A {y}年 营业收入 为 {v} 亿元 较上年 增长" for y, v in
        zip(range(2015, 2030), range(10, 25))
    ] + [
        f"公司B {y}年 净利润 达到 {v} 亿元 同比 下降" for y, v in
        zip(range(2015, 2030), range(30, 45))
    ]
    cfg = PretrainConfig(batch_size=12, soft_target_weight=0.6, min_span=6,
                         crop_prob=1.0)
    s = PairSampler(texts, cfg)
    qs, ps, tg = s.sample(np.random.default_rng(0))
    assert tg is not None and tg.shape == (12, 12)
    np.testing.assert_allclose(tg.sum(axis=1), 1.0, rtol=1e-5)
    assert (tg >= 0).all()
    # identity mixing floor: every diagonal owns at least (1-w) of its row
    assert (np.diag(tg) >= 1 - 0.6 - 1e-6).all()
    # and the teacher actually spreads mass: some off-diagonal weight
    assert (tg - np.diag(np.diag(tg))).sum() > 0


def test_contrastive_loss_soft_targets_identity_equivalence():
    """targets=I must reproduce the integer-label InfoNCE exactly, and a
    soft teacher must move the loss (the distillation term is live)."""
    import jax.numpy as jnp

    from rag_challenge_2_tpu.models.train import contrastive_loss

    rng = np.random.default_rng(0)
    B, D = 6, 8
    qe = rng.normal(size=(B, D)).astype(np.float32)
    de = rng.normal(size=(B, D)).astype(np.float32)

    def apply_q(params, tokens):
        return jnp.asarray(qe), {}

    def apply_d(params, tokens):
        return jnp.asarray(de), {}

    calls = []

    def apply_fn(params, tokens):
        calls.append(None)
        return (apply_q if len(calls) == 1 else apply_d)(params, tokens)

    l_int, _ = contrastive_loss({}, apply_fn, None, None, 0.05)
    calls.clear()
    l_eye, _ = contrastive_loss(
        {}, apply_fn, None, None, 0.05, targets=jnp.eye(B))
    np.testing.assert_allclose(float(l_int), float(l_eye), rtol=1e-6)
    calls.clear()
    soft = np.full((B, B), 1.0 / B, np.float32)
    l_soft, _ = contrastive_loss(
        {}, apply_fn, None, None, 0.05, targets=jnp.asarray(soft))
    assert abs(float(l_soft) - float(l_int)) > 1e-4


def test_pretrain_listwise_runs():
    """End-to-end: a few listwise-distillation steps run and return finite
    loss through the sharded train step."""
    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.pretrain import PretrainConfig, pretrain_encoder

    texts = [
        f"公司{c} {y}年 指标{m} 为 {v} 亿元" for c in "ABC"
        for y, (m, v) in zip(range(2018, 2024), enumerate(range(6)))
    ]
    model, info = pretrain_encoder(
        texts,
        enc_cfg=EncoderConfig(d_model=32, n_layers=1, n_heads=2, d_ff=64,
                              max_len=32, out_dim=16),
        pre_cfg=PretrainConfig(steps=3, batch_size=8,
                               soft_target_weight=0.5, min_span=4),
    )
    assert np.isfinite(info["final"]["loss"])


def test_pair_sampler_dense_teacher_mining():
    """A teacher_score_fn replaces BM25 as the mining oracle (dense
    self-training): neighbor positives come from the teacher's argmax and
    hard batches from its neighborhoods — no CSR is built."""
    from rag_challenge_2_tpu.models.pretrain import PairSampler, PretrainConfig

    texts = [f"公司{c} {y}年 营业收入 为 {v} 亿元" for c in "AB"
             for y, v in zip(range(2018, 2026), range(8))]

    # deterministic teacher: every query's best chunk is index 3
    def teacher(queries):
        s = np.zeros((len(queries), len(texts)), np.float32)
        s[:, 3] = 1.0
        s[:, 5] = 0.5
        return s

    cfg = PretrainConfig(batch_size=8, bm25_neighbor_prob=1.0, min_span=6)
    s = PairSampler(texts, cfg, teacher_score_fn=teacher)
    assert s._sparse is None and s._mine
    qs, ps, _ = s.sample(np.random.default_rng(0))
    # positives = teacher argmax (index 3), except when the crop's source
    # IS chunk 3 (self excluded -> runner-up 5)
    assert all(p in (texts[3], texts[5]) for p in ps), ps

    # hard batch: the teacher's neighborhood ranks chunks 3 and 5 first
    cfg2 = PretrainConfig(batch_size=4, hard_batch_prob=1.0, crop_prob=1.0,
                          min_span=6)
    s2 = PairSampler(texts, cfg2, teacher_score_fn=teacher)
    qs2, ps2, _ = s2.sample(np.random.default_rng(1))
    assert len(qs2) == 4


def test_pretrain_warm_start_and_lr_schedule():
    """init_params warm-starts pretraining; total_steps>0 switches the
    optimizer to warmup-cosine decay (loss stays finite, params move)."""
    import jax

    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.pretrain import PretrainConfig, pretrain_encoder
    from rag_challenge_2_tpu.models.train import TrainConfig, make_optimizer

    # the schedule is actually wired: lr at step 0 is ~0 (warmup ramp)
    import optax
    tc = TrainConfig(lr=1e-2, total_steps=20, warmup_steps=5)
    opt = make_optimizer(tc)
    p0 = {"w": np.ones((4,), np.float32)}
    st = opt.init(p0)
    g = {"w": np.ones((4,), np.float32)}
    upd, _ = opt.update(g, st, p0)
    assert float(np.abs(upd["w"]).max()) < 1e-3, "warmup step 0 should be ~0 lr"

    texts = [f"公司{c} {y}年 指标 为 {v} 亿元" for c in "AB"
             for y, v in zip(range(2018, 2024), range(6))]
    enc = EncoderConfig(d_model=32, n_layers=1, n_heads=2, d_ff=64,
                        max_len=32, out_dim=16)
    m1, _ = pretrain_encoder(
        texts, enc_cfg=enc,
        pre_cfg=PretrainConfig(steps=2, batch_size=8, min_span=4))
    m2, info = pretrain_encoder(
        texts, enc_cfg=enc,
        pre_cfg=PretrainConfig(steps=2, batch_size=8, min_span=4, seed=3),
        train_cfg=TrainConfig(lr=3e-4, total_steps=2),
        init_params=m1.params)
    assert np.isfinite(info["final"]["loss"])
    # warm start: m2 differs from m1 (training moved it) but shares shapes
    l1 = jax.tree_util.tree_leaves(m1.params)
    l2 = jax.tree_util.tree_leaves(m2.params)
    assert all(a.shape == b.shape for a, b in zip(l1, l2))


def test_pair_sampler_idf_sampling_oversamples_rare_vocab():
    """idf_sampling>0: chunks with rare vocabulary (glossary-like text)
    are drawn more often than common-template chunks; 0 keeps uniform."""
    from rag_challenge_2_tpu.models.pretrain import PairSampler, PretrainConfig

    # 30 near-identical template chunks (high df terms) + 2 chunks of
    # unique vocabulary (df=1 terms -> high mean idf)
    common = [f"公司A 2020年 营业收入 为 {v} 亿元 较上年 增长" for v in range(30)]
    rare = [
        "毛利率 定义 指 毛利 占 营业收入 比例 反映 盈利 能力",
        "资产负债率 定义 指 负债 总额 除以 资产 总额 衡量 杠杆",
    ]
    texts = common + rare

    cfg = PretrainConfig(batch_size=16, crop_prob=1.0, min_span=6,
                         idf_sampling=2.0)
    s = PairSampler(texts, cfg)
    assert s._chunk_p is not None and s._chunk_p.shape == (len(texts),)
    np.testing.assert_allclose(s._chunk_p.sum(), 1.0, rtol=1e-9)
    # each rare chunk individually outweighs each common chunk
    assert s._chunk_p[len(common):].min() > s._chunk_p[:len(common)].max()

    rng = np.random.default_rng(0)
    draws = np.asarray([s._draw_chunk(rng) for _ in range(2000)])
    rare_frac = float(np.mean(draws >= len(common)))
    assert rare_frac > 2 * len(rare) / len(texts), rare_frac

    # power 0 = uniform (no distribution built at all)
    s0 = PairSampler(texts, PretrainConfig(batch_size=16, crop_prob=1.0,
                                           min_span=6))
    assert s0._chunk_p is None


def test_mine_alias_pairs_and_query_swap():
    """Corpus-mined synonym substitution (PretrainConfig.alias_swap_prob):
    definitional sentences yield (term, alias) pairs; the sampler swaps
    terms in the QUERY view only, after teacher mining."""
    from rag_challenge_2_tpu.models.pretrain import (
        PairSampler, PretrainConfig, mine_alias_pairs)

    corpus = [
        "注：营业收入（亦称营收、销售收入）指报告期相关口径的指标。",
        "注：归母净利润（又称归属股东的净利润）指相关财务指标。",
        "公司2023年营业收入为12.5亿元，较上年同期增长。",
        "公司2023年归母净利润为3.2亿元，较上年同期增长。",
        "无定义句的普通语句，仅用于凑数并保证语料多样性。",
    ]
    pairs = mine_alias_pairs(corpus)
    assert ("营业收入", "营收") in pairs
    assert ("营业收入", "销售收入") in pairs
    assert ("归母净利润", "归属股东的净利润") in pairs

    # the term group has no left boundary in unsegmented Chinese: strip
    # possessive boilerplate, drop appositive junk aliases, accept 以下简称
    more = mine_alias_pairs([
        "本公司经营活动现金流（亦称经营现金流，下同）保持稳定。",
        "中兴通讯股份有限公司（以下简称中兴通讯）发布年报。",
    ])
    assert ("经营活动现金流", "经营现金流") in more
    assert all(a != "下同" for _, a in more)
    assert all(not t.startswith("本公司") for t, _ in more)
    assert ("中兴通讯股份有限公司", "中兴通讯") in more
    # longest-first: the swap must treat 归母净利润 atomically, never
    # rewrite its 净利润 suffix via a shorter key
    cfg = PretrainConfig(batch_size=8, crop_prob=1.0, min_span=4,
                         bm25_neighbor_prob=0.0, hard_batch_prob=0.0,
                         alias_swap_prob=1.0)
    s = PairSampler(corpus, cfg)
    rng = np.random.default_rng(0)
    out = s._alias_swap("查询2023年归母净利润和营业收入数据", rng)
    # 归母净利润 was treated atomically (replaced by its own alias, not a
    # partial rewrite of its 净利润 suffix via a shorter key)
    assert "归母" not in out
    assert "归属股东的净利润" in out
    assert "营业收入" not in out
    # prob 0 disables all machinery (explicit: the default is now 0.8)
    s0 = PairSampler(corpus, PretrainConfig(batch_size=8, crop_prob=1.0,
                                            min_span=4,
                                            bm25_neighbor_prob=0.0,
                                            hard_batch_prob=0.0,
                                            alias_swap_prob=0.0))
    assert s0._alias_re is None

    # end-to-end: with swap prob 1 the sampled queries contain alias
    # wording for chunks whose crop covered a defined term
    rng = np.random.default_rng(1)
    qs, ps, _ = s.sample(rng)
    assert len(qs) == len(ps) == 8
    joined = "".join(qs)
    assert "营收" in joined or "销售收入" in joined or "归属股东的净利润" in joined


def test_question_wrap_query_view():
    """doc2query-style question wrapping (PretrainConfig.question_wrap_prob):
    the QUERY view gains a generic interrogative frame after mining; the
    passage view is untouched; prob 0 is a no-op."""
    from rag_challenge_2_tpu.models.pretrain import (
        _QUESTION_FRAMES, PairSampler, PretrainConfig)

    corpus = [
        "公司2023年营业收入为12.5亿元，较上年同期增长。",
        "公司2023年归母净利润为3.2亿元，较上年同期增长。",
        "报告期内研发费用为1.1亿元，主要投向储能系统。",
        "无定义句的普通语句，仅用于凑数并保证语料多样性。",
    ]
    cfg = PretrainConfig(batch_size=8, crop_prob=1.0, min_span=4,
                         bm25_neighbor_prob=0.0, hard_batch_prob=0.0,
                         question_wrap_prob=1.0)
    s = PairSampler(corpus, cfg)
    rng = np.random.default_rng(0)
    qs, ps, _ = s.sample(rng)
    prefixes = tuple(f.split("{}")[0] for f in _QUESTION_FRAMES if
                     f.split("{}")[0])
    for q in qs:
        assert q.startswith(prefixes) or q.endswith(("？", "的问题"))
    # passages stay statement-shaped (crops of the corpus text)
    for p in ps:
        assert not p.startswith(prefixes)
    # prob 0: queries are raw crops
    s0 = PairSampler(corpus, PretrainConfig(
        batch_size=8, crop_prob=1.0, min_span=4,
        bm25_neighbor_prob=0.0, hard_batch_prob=0.0))
    qs0, _, _ = s0.sample(np.random.default_rng(0))
    assert not any(q.startswith(prefixes) for q in qs0)


def test_pair_sampler_passage_side_alias_swap():
    """alias_swap_passage_prob swaps terms in the PASSAGE view too —
    both-directions alias alignment; alias machinery is built even when
    the query-side prob is 0."""
    from rag_challenge_2_tpu.models.pretrain import PairSampler, PretrainConfig

    corpus = [
        "注：营业收入（亦称营收）指报告期相关口径的指标。",
        "公司2023年营业收入为12.5亿元，较上年同期增长。",
        "公司2024年营业收入为15.8亿元，再创新高水平。",
    ]
    cfg = PretrainConfig(batch_size=8, crop_prob=0.0, keep_span_prob=1.0,
                         min_span=4, bm25_neighbor_prob=0.0,
                         hard_batch_prob=0.0, alias_swap_prob=0.0,
                         alias_swap_passage_prob=1.0)
    s = PairSampler(corpus, cfg)
    assert s._alias_re is not None, "passage-only swap must build the map"
    rng = np.random.default_rng(0)
    seen_swapped = False
    for _ in range(10):
        qs, ps, _ = s.sample(rng)
        # keep_span=1: every passage is a full chunk -> any passage whose
        # source contained 营业收入 must now carry 营收 instead
        for p in ps:
            if "营收" in p and "营业收入" not in p:
                seen_swapped = True
    assert seen_swapped


def test_ensemble_teacher_promotes_lexical_candidates():
    """ensemble_teacher mixes max-normalized BM25 + dense scores; with
    alpha=1 it reduces to pure (normalized) BM25 ranking."""
    from rag_challenge_2_tpu.models.encoder import EmbeddingModel, EncoderConfig
    from rag_challenge_2_tpu.models.pretrain import ensemble_teacher

    corpus = [
        "公司2023年营业收入为12.5亿元，较上年同期增长。",
        "公司2023年研发费用为2.1亿元，持续加大投入。",
        "公司2024年营业收入为15.8亿元，再创新高水平。",
        "与营收无关的其他治理信息披露段落，仅用于对照。",
    ]
    cfg = EncoderConfig(vocab_bits=10, d_model=32, n_layers=1, n_heads=2,
                        d_ff=64, max_len=32, out_dim=16)
    model = EmbeddingModel(cfg, seed=0)
    t_bm = ensemble_teacher(corpus, model, alpha=1.0, vocab_bits=12)
    t_mix = ensemble_teacher(corpus, model, alpha=0.5, vocab_bits=12)
    s_bm = t_bm(["2023年营业收入"])
    s_mix = t_mix(["2023年营业收入"])
    assert s_bm.shape == (1, len(corpus)) and s_mix.shape == (1, len(corpus))
    # pure-BM25 ranking puts the lexically matching revenue chunk first
    assert int(np.argmax(s_bm[0])) == 0
    # the mix stays bounded by its components' normalization
    assert np.all(s_mix <= 1.0 + 1e-6)


def test_build_dataset_v2_transfer_corpus():
    """The transfer corpus is genuinely disjoint from corpus #1 (vocab,
    templates) and its definitional sentences are minable."""
    from rag_challenge_2_tpu.eval.encoder_quality import (
        METRICS, METRICS_V2, build_dataset, build_dataset_v2)
    from rag_challenge_2_tpu.models.pretrain import mine_alias_pairs

    ds1 = build_dataset(seed=0)
    ds2 = build_dataset_v2(seed=7)
    assert not (set(METRICS) & set(METRICS_V2)), "metric vocab must be disjoint"
    assert len(ds2.queries) == 200
    # no chunk text shared across corpora
    assert not (set(ds1.chunk_texts) & set(ds2.chunk_texts))
    # the v2 definitional form ("或称", full-width parens) mines pairs for
    # every v2 metric alias
    pairs = mine_alias_pairs(ds2.chunk_texts)
    mined_terms = {t for t, _ in pairs}
    assert set(METRICS_V2) <= mined_terms
    # every eval query uses alias wording (the regime being measured)
    hit = sum(
        any(a in q for m, (_, al) in METRICS_V2.items() for a in al)
        for q in ds2.queries
    )
    assert hit == len(ds2.queries)


def test_host_teacher_matches_device_bm25_scores():
    """PairSampler's host mining teacher (ops/bm25.HostBM25Scorer) must
    reproduce the device kernel's scores: same Lucene idf/k1/b formula
    over the same CSR — the whole point is removing a per-step device
    round trip WITHOUT changing which neighbors get mined."""
    from rag_challenge_2_tpu.models.pretrain import PretrainConfig, PairSampler
    from rag_challenge_2_tpu.ops.bm25 import bm25_scores, encode_queries

    texts = [
        f"公司{c}在{y}年的营业收入为{v}亿元，同比增长{v % 7}个百分点" for c in "甲乙丙"
        for y, v in zip(range(2018, 2026), range(8))
    ] + ["营业收入（亦称营收）指企业经营活动形成的收入总额"]
    cfg = PretrainConfig(steps=1, batch_size=4, min_span=4)
    s = PairSampler(texts, cfg)
    assert s._host_scorer is not None
    queries = [t[:12] for t in texts[:6]] + ["营收情况如何"]
    qt = encode_queries(queries, max_terms=48, vocab_bits=cfg.bm25_vocab_bits)
    dev = np.asarray(bm25_scores(s._sparse, qt, s._n_pad))
    host = s._host_scorer.scores(np.asarray(qt), s._n_pad)
    np.testing.assert_allclose(host, dev, rtol=2e-5, atol=2e-5)
    # empty queries (no postings at all) short-circuit to zeros
    empty = np.full((2, 48), -1, np.int32)
    assert s._host_scorer.scores(empty, s._n_pad).sum() == 0.0


def test_chunked_pretrain_trajectory_identical():
    """steps_per_dispatch only amortizes dispatch overhead: the scan-of-K
    update (models/train.make_chunked_train_step) must produce the SAME
    final parameters as K single steps — same sampler stream, same
    update order (a partial final chunk included)."""
    from rag_challenge_2_tpu.models.encoder import EncoderConfig
    from rag_challenge_2_tpu.models.pretrain import PretrainConfig, pretrain_encoder

    texts = [
        f"公司{c} {y}年 指标{m} 为 {v} 亿元" for c in "ABC"
        for y, (m, v) in zip(range(2018, 2024), enumerate(range(6)))
    ]
    enc = EncoderConfig(d_model=32, n_layers=1, n_heads=2, d_ff=64,
                        max_len=32, out_dim=16)
    runs = []
    for k in (1, 3):  # 3 does not divide 7: exercises the partial chunk
        m, h = pretrain_encoder(
            texts, enc_cfg=enc,
            pre_cfg=PretrainConfig(steps=7, batch_size=8, min_span=4,
                                   steps_per_dispatch=k),
        )
        runs.append((m.params, h))
    l1 = jax.tree_util.tree_leaves(runs[0][0])
    l2 = jax.tree_util.tree_leaves(runs[1][0])
    for a, b in zip(l1, l2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # history entries line up too (log_every grid over both paths)
    assert runs[0][1]["final"] == runs[1][1]["final"]

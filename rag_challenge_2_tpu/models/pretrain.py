"""Self-supervised encoder pretraining on a chunked corpus.

The reference rents its embedding quality from an API
(Qwen text-embedding-v4).  To make on-device corpus embedding
(BASELINE.md config 4) self-contained, the encoder trains on the corpus
itself with no labels and no external service — the same chunked-report
JSONs that feed the index feed training, with global-batch InfoNCE
(models/train.py) supplying the negatives.

Two pair constructions, mixed per example:

* **independent cropping** (``crop_prob`` of examples): query and passage
  are two random overlapping crops of the same chunk.  Crops share tokens
  (company names, years, metric terms), so the model learns that
  lexically/semantically overlapping texts embed together — the property
  question-style retrieval actually needs.
* **Inverse Cloze Task** (the remainder): a sampled span is the query and
  the chunk is the passage; with probability ``keep_span_prob`` the span
  stays inside the passage, otherwise it is removed.  Pure span-removal
  ICT teaches *complementary*-content matching only; measured on the
  config-4 quality eval it collapses question-style retrieval to ~0 hit@10
  (eval/encoder_quality.py), which is why removal-only is not the default.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import make_mesh
from .encoder import EmbeddingModel, EncoderConfig, tokenize_batch
from .train import TrainConfig, init_training


@dataclasses.dataclass
class PretrainConfig:
    steps: int = 200
    batch_size: int = 64
    max_len: int = 64
    min_span: int = 4
    seed: int = 0
    # pair-construction mix (see module docstring); crop_prob=0,
    # keep_span_prob=0 reproduces the original removal-only ICT.
    # Defaults = best of the measured ablation on the config-4 quality
    # eval: crop75/keep50 0.285 hit@10 vs
    # 0.255 pure-crop, 0.24 crop50/keep20, 0.01 removal-only.
    crop_prob: float = 0.75
    keep_span_prob: float = 0.5
    # BM25 distillation (no labels): with this probability an example's
    # positive is the top BM25 neighbor of the query crop (self excluded)
    # instead of the source chunk — the dense model learns the sparse
    # path's lexical-graph structure and, through embedding transitivity,
    # associations BM25 itself cannot score (a glossary chunk that shares
    # a metric term with fact chunks pulls its alias tokens toward them).
    # Default = the measured-best label-free mix on the config-4 quality
    # eval: 0.8/1.0 scores 0.47 hit@10 vs
    # 0.385 for 0.5/0.5, 0.305 random init, 0.18 crop+ICT alone — and
    # 0.73 with the default alias swap on top (see alias_swap_prob).
    # Ablated non-winners: 3× steps 0.455, idf-weighted chunk sampling
    # 0.43, listwise soft targets 0.21.  Set both to 0 for pure crop+ICT.
    bm25_neighbor_prob: float = 0.8
    bm25_vocab_bits: int = 18
    # with this probability a step's batch is one seed crop's top BM25
    # neighborhood — in-batch negatives become lexically-close hard
    # negatives (same company/other year, same metric/other company)
    hard_batch_prob: float = 1.0
    # LISTWISE BM25 distillation: with weight w > 0 each step also emits a
    # [B, B] soft target matrix (1-w)·I + w·softmax(S/τ) where S is the
    # corpus-CSR BM25 score of every query crop against every passage
    # chunk in the batch — the dense score distribution is pulled toward
    # the sparse teacher's RANKING, not just its argmax (the
    # bm25_neighbor_prob mode).  Single-positive InfoNCE over crops
    # teaches template-level similarity and smooths away the
    # discriminative tokens (company/year/value); the listwise target
    # keeps their relative weights.
    soft_target_weight: float = 0.0
    soft_target_temp: float = 2.0
    # corpus-mined synonym substitution: real filings DEFINE their terms
    # ("营业收入（亦称营收）指……") and those definitional sentences are the
    # only label-free source of synonym knowledge in a corpus.  With this
    # probability a query view has each known term replaced by one of its
    # mined aliases (and vice versa) AFTER teacher mining, so InfoNCE
    # aligns alias wording with term wording — the regime where lexical
    # matching fails and an embedding model must carry the quality.
    # Mining = mine_alias_pairs() over the training corpus itself; no
    # labels, no external vocabulary.  Default = the measured-best
    # label-free setting on the config-4 quality eval: 0.8 scores 0.73
    # hit@10 at 5k steps
    # (2.4× random init, 0.67 at seed 1) and 0.765 at 15k — unlike plain
    # distill, this recipe keeps improving with steps — vs 0.66 at 1.0
    # (always-swapped queries lose the literal-wording anchor), 0.47 with
    # the swap off; question wrapping on top measured no gain (0.70).
    alias_swap_prob: float = 0.8
    # BOTH-SIDES alias alignment: with this probability the PASSAGE view
    # also has its terms alias-substituted (independently of the query
    # swap).  The query-only swap teaches alias→term retrieval; swapping
    # the passage too makes the positive pair span (term wording, alias
    # wording) in BOTH directions — the multi-positive-view form of the
    # same label-free lever.  0 = query-side only (the r3 default).
    alias_swap_passage_prob: float = 0.0
    # doc2query-style question wrapping: serving queries are QUESTIONS
    # while corpus crops are declarative statements — a distribution gap
    # ICT/crops never bridge.  With this probability the query view is
    # wrapped in a generic interrogative frame (static templates — the
    # degenerate no-generator form of doc2query), so InfoNCE aligns
    # question-shaped text with statement-shaped passages.  Label-free:
    # the frames carry no corpus or eval knowledge.
    question_wrap_prob: float = 0.0
    # inverse-document-frequency chunk sampling: source chunks are drawn
    # ∝ (mean idf of their unique terms)^idf_sampling instead of
    # uniformly.  Rare-vocabulary chunks — definitional/glossary text,
    # the only places a corpus states synonym links — are a sliver of
    # any real corpus and uniform sampling starves the model of exactly
    # the pairs that teach synonymy; idf weighting oversamples them
    # without knowing anything about the eval.  0 = uniform.
    idf_sampling: float = 0.0
    # train steps fused into ONE device dispatch (lax.scan in
    # models/train.make_chunked_train_step): the per-dispatch host cost is
    # paid once per K steps, with a bitwise-identical update trajectory
    # (same sampler stream, same order — verified in tests/test_models.py).
    # A final partial chunk scans the remainder (one extra compile for
    # that length, absorbed by the persistent compile cache).
    steps_per_dispatch: int = 250
    # mining-teacher placement: the host scorer (ops/bm25.HostBM25Scorer)
    # matches the device kernel to f32 rounding, so near-tied neighbor
    # argmaxes can break differently — statistically equivalent training,
    # not bitwise-reproducing runs made with the device teacher.  False
    # forces the device scorer.
    host_teacher: bool = True


# Generic interrogative frames for PretrainConfig.question_wrap_prob.
# Deliberately worded UNLIKE eval/encoder_quality._QUERY_TEMPLATES (no
# 是多少/什么水平/情况如何/查询…数据) so the lever stays label-free: the
# frames teach question-shape invariance, not the eval's phrasing.
_QUESTION_FRAMES = [
    "请告诉我{}",
    "想了解一下{}",
    "{}？",
    "关于{}的问题",
    "能否说明{}",
    "帮我看看{}",
]

# Chinese definitional patterns: "X（亦称Y）", "X（又称Y、Z）",
# "X（以下简称Y）", half- or full-width parens.  Terms are CJK/word runs;
# the alias group may list several separated by 、/,/，.
_ALIAS_RE = re.compile(
    r"([A-Za-z0-9一-鿿]{2,16})"
    r"[（(]\s*(?:以下)?(?:亦称|又称|也称|或称|简称|别称)"
    r"([A-Za-z0-9一-鿿、，,\s]{1,48}?)[)）]"
)

# The term group has no reliable left boundary in unsegmented Chinese, so
# it can absorb preceding context ("本公司2023年营业收入（亦称营收）" mines
# term 本公司2023年营业收入); strip possessive boilerplate and anything up
# to a year/的 boundary.  Alias lists likewise capture appositive
# boilerplate ("（亦称营收，下同）") — drop it, or the bidirectional swap
# map would rewrite queries into junk.
_TERM_PREFIX_RE = re.compile(
    r"^(?:.*?20\d{2}年|.*?的|本公司|本集团|本行|该公司|即"
    r"|本报告中|本报告期内?|报告期内|本年度|本期)")
_JUNK_ALIASES = {"下同", "同上", "下文同", "以下同", "以下简称", "见下文"}


def mine_alias_pairs(texts: List[str]) -> List[Tuple[str, str]]:
    """Mine (term, alias) synonym pairs from definitional sentences in the
    corpus itself — the label-free path to synonym knowledge
    (PretrainConfig.alias_swap_prob).  Returns deduplicated pairs in first-
    seen order; every alias in a 、-separated list yields its own pair."""
    seen = set()
    pairs: List[Tuple[str, str]] = []
    for t in texts:
        for m in _ALIAS_RE.finditer(t):
            term = m.group(1)
            while True:      # strip context prefixes to a fixpoint
                stripped = _TERM_PREFIX_RE.sub("", term, count=1)
                if stripped == term:
                    break
                term = stripped
            if len(term) < 2:
                continue
            for alias in re.split(r"[、，,\s]+", m.group(2)):
                alias = alias.strip()
                if (not alias or alias == term
                        or alias in _JUNK_ALIASES or len(alias) < 2):
                    continue
                key = (term, alias)
                if key not in seen:
                    seen.add(key)
                    pairs.append(key)
    return pairs


def ict_pairs(
    chunk_texts: List[str],
    n: int,
    rng: np.random.Generator,
    min_span: int = 4,
) -> Tuple[List[str], List[str]]:
    """Sample (query span, remaining passage) pairs from chunks
    (removal-only ICT; kept for comparison experiments)."""
    return contrastive_pairs(
        chunk_texts, n, rng, min_span=min_span, crop_prob=0.0, keep_span_prob=0.0
    )


def contrastive_pairs(
    chunk_texts: List[str],
    n: int,
    rng: np.random.Generator,
    min_span: int = 4,
    crop_prob: float = 0.75,
    keep_span_prob: float = 0.5,
) -> Tuple[List[str], List[str]]:
    """Sample self-supervised (query, passage) pairs from chunks.

    Per example: with ``crop_prob`` an independent-crop pair (two random
    crops of the same chunk, each ≥ half the chunk so they overlap);
    otherwise an ICT pair whose span survives in the passage with
    ``keep_span_prob``."""
    texts = [t for t in chunk_texts if len(t) >= 2 * min_span]
    if not texts:
        raise ValueError("corpus has no chunks long enough for pretraining")
    queries, passages = [], []
    for _ in range(n):
        t = texts[rng.integers(0, len(texts))]
        if rng.random() < crop_prob:
            def crop():
                span = int(rng.integers(max(min_span, len(t) // 2), len(t) + 1))
                start = int(rng.integers(0, len(t) - span + 1))
                return t[start : start + span]
            queries.append(crop())
            passages.append(crop())
        else:
            span_len = int(rng.integers(min_span, max(min_span + 1, len(t) // 2)))
            start = int(rng.integers(0, len(t) - span_len + 1))
            queries.append(t[start : start + span_len])
            if rng.random() < keep_span_prob:
                passages.append(t)
            else:
                passages.append(t[:start] + t[start + span_len :])
    return queries, passages


class PairSampler:
    """Per-step (query, passage) batch construction, incl. the BM25-mined
    modes.  The corpus CSR is built ONCE; per step the query crops score
    against it on device (ops/bm25) — mining cost is one [B, N] sparse
    scoring per step, negligible next to the train step."""

    def __init__(
        self,
        chunk_texts: List[str],
        cfg: PretrainConfig,
        teacher_score_fn=None,
    ):
        """``teacher_score_fn(texts) -> [n, n_chunks]`` replaces BM25 as
        the mining teacher for the neighbor/hard-batch/listwise modes —
        SELF-TRAINING: a previously distilled dense model re-mines its own
        positives/negatives, bootstrapping past the lexical teacher's
        reach (still label-free)."""
        self.cfg = cfg
        self.texts = [t for t in chunk_texts if len(t) >= 2 * cfg.min_span]
        if not self.texts:
            raise ValueError("corpus has no chunks long enough for pretraining")
        self._teacher = teacher_score_fn
        self._sparse = None
        self._mine = teacher_score_fn is not None
        if teacher_score_fn is None and (
                cfg.bm25_neighbor_prob > 0 or cfg.hard_batch_prob > 0
                or cfg.soft_target_weight > 0):
            from ..index.build import _build_sparse

            n_pad = -(-len(self.texts) // 128) * 128
            self._sparse = _build_sparse(
                self.texts, n_pad, vocab_bits=cfg.bm25_vocab_bits
            )
            self._n_pad = n_pad
            self._mine = True
        # small corpora score the BM25 teacher ON THE HOST: the mining
        # loop needs the [B, N] matrix back host-side every step
        # (ops/bm25.HostBM25Scorer docstring)
        self._host_scorer = None
        if (cfg.host_teacher and self._sparse is not None
                and len(self.texts) <= 200_000):
            from ..ops.bm25 import HostBM25Scorer

            self._host_scorer = HostBM25Scorer(self._sparse)
        self._chunk_p = None
        if cfg.idf_sampling > 0:
            self._chunk_p = self._idf_weights(cfg)
        self._alias_map: Dict[str, List[str]] = {}
        self._alias_re: Optional[re.Pattern] = None
        if cfg.alias_swap_prob > 0 or cfg.alias_swap_passage_prob > 0:
            for term, alias in mine_alias_pairs(self.texts):
                self._alias_map.setdefault(term, []).append(alias)
                self._alias_map.setdefault(alias, []).append(term)
            if self._alias_map:
                # longest-first alternation so 归母净利润 wins over 净利润
                keys = sorted(self._alias_map, key=len, reverse=True)
                self._alias_re = re.compile(
                    "|".join(re.escape(k) for k in keys))

    def _alias_swap(self, text: str, rng: np.random.Generator) -> str:
        """Replace each known term occurrence with a mined synonym."""
        if self._alias_re is None:
            return text
        return self._alias_re.sub(
            lambda m: (lambda al: al[int(rng.integers(0, len(al)))])(
                self._alias_map[m.group(0)]),
            text,
        )

    def _idf_weights(self, cfg: PretrainConfig) -> np.ndarray:
        """Per-chunk sampling distribution ∝ (mean unique-term idf)^power
        (PretrainConfig.idf_sampling doc)."""
        from ..utils import tokenize as tok

        # document frequency per term over the training texts
        df: Dict[int, int] = {}
        per_chunk: List[List[int]] = []
        for t in self.texts:
            ids = set(tok.token_ids(t, cfg.bm25_vocab_bits))
            per_chunk.append(list(ids))
            for i in ids:
                df[i] = df.get(i, 0) + 1
        n = max(len(self.texts), 1)
        w = np.ones((len(self.texts),), np.float64)
        for ci, ids in enumerate(per_chunk):
            if ids:
                idf = [np.log1p((n - df[i] + 0.5) / (df[i] + 0.5)) for i in ids]
                w[ci] = max(float(np.mean(idf)), 1e-9)
        w = w ** cfg.idf_sampling
        return w / w.sum()

    def _draw_chunk(self, rng: np.random.Generator) -> int:
        if self._chunk_p is not None:
            return int(rng.choice(len(self.texts), p=self._chunk_p))
        return int(rng.integers(0, len(self.texts)))

    def _crop(self, t: str, rng: np.random.Generator) -> str:
        span = int(rng.integers(max(self.cfg.min_span, len(t) // 2), len(t) + 1))
        start = int(rng.integers(0, len(t) - span + 1))
        return t[start : start + span]

    def _teacher_scores(self, queries: List[str]) -> np.ndarray:
        """[n, n_chunks] mining scores from the active teacher."""
        if self._teacher is not None:
            return np.asarray(self._teacher(queries))
        if self._host_scorer is not None:
            from ..ops.bm25 import encode_queries_host

            qt = encode_queries_host(
                queries, max_terms=48, vocab_bits=self.cfg.bm25_vocab_bits
            )
            s = self._host_scorer.scores(qt, self._n_pad)
            return s[:, : len(self.texts)]
        from ..ops.bm25 import bm25_scores, encode_queries

        qt = encode_queries(
            queries, max_terms=48, vocab_bits=self.cfg.bm25_vocab_bits
        )
        s = np.asarray(bm25_scores(self._sparse, qt, self._n_pad))
        return s[:, : len(self.texts)]

    def sample(
        self, rng: np.random.Generator
    ) -> Tuple[List[str], List[str], Optional[np.ndarray]]:
        """One step's batch: (queries, passages, soft_targets).

        ``soft_targets`` is None unless ``cfg.soft_target_weight > 0``, in
        which case it is the [B, B] row-stochastic listwise matrix for
        models/train.py ``contrastive_loss(targets=...)``."""
        cfg = self.cfg
        B = cfg.batch_size
        if self._mine and rng.random() < cfg.hard_batch_prob:
            # hard-negative batch: one seed crop's BM25 neighborhood
            seed_t = self.texts[self._draw_chunk(rng)]
            s = self._teacher_scores([self._crop(seed_t, rng)])[0]
            nbr = np.argsort(-s, kind="stable")[:B]
            chunk_ids = [int(i) for i in nbr]
            # pad tiny corpora by resampling
            while len(chunk_ids) < B:
                chunk_ids.append(int(rng.integers(0, len(self.texts))))
        else:
            chunk_ids = [self._draw_chunk(rng) for _ in range(B)]

        queries, passages, want_nbr = [], [], []
        passage_ids = list(chunk_ids)          # source chunk per passage
        for i, ci in enumerate(chunk_ids):
            t = self.texts[ci]
            if self._mine and rng.random() < cfg.bm25_neighbor_prob:
                queries.append(self._crop(t, rng))
                passages.append(None)          # filled from BM25 below
                want_nbr.append((i, ci))
            elif rng.random() < cfg.crop_prob:
                queries.append(self._crop(t, rng))
                passages.append(self._crop(t, rng))
            else:
                span_len = int(rng.integers(
                    cfg.min_span, max(cfg.min_span + 1, len(t) // 2)
                ))
                start = int(rng.integers(0, len(t) - span_len + 1))
                queries.append(t[start : start + span_len])
                if rng.random() < cfg.keep_span_prob:
                    passages.append(t)
                else:
                    passages.append(t[:start] + t[start + span_len :])
        need_scores = bool(want_nbr) or cfg.soft_target_weight > 0
        s = self._teacher_scores(queries) if need_scores else None
        for i, ci in want_nbr:
            sc = s[i].copy()
            sc[ci] = -np.inf                   # distill NEIGHBORS, not self
            best = int(np.argmax(sc))
            # a crop with no lexical neighbor falls back to its source
            if sc[best] > 0:
                passages[i], passage_ids[i] = self.texts[best], best
            else:
                passages[i] = self.texts[ci]
        targets = None
        if cfg.soft_target_weight > 0:
            # teacher distribution over the batch's passages: softmax of
            # the query's corpus-BM25 score AT each passage's source chunk
            # (duplicated sources legitimately split the teacher's mass)
            sub = s[:, passage_ids] / max(cfg.soft_target_temp, 1e-6)
            sub = sub - sub.max(axis=1, keepdims=True)
            p = np.exp(sub)
            p /= p.sum(axis=1, keepdims=True)
            w = cfg.soft_target_weight
            targets = ((1.0 - w) * np.eye(B, dtype=np.float32)
                       + w * p.astype(np.float32))
        # synonym substitution happens LAST: the teacher mined on the
        # original (lexically matching) crop, the model trains on the
        # alias wording — aligning alias ↔ term embeddings
        if self._alias_re is not None:
            queries = [
                self._alias_swap(q, rng)
                if rng.random() < cfg.alias_swap_prob else q
                for q in queries
            ]
            if cfg.alias_swap_passage_prob > 0:
                passages = [
                    self._alias_swap(p, rng)
                    if rng.random() < cfg.alias_swap_passage_prob else p
                    for p in passages
                ]
        # question wrapping likewise happens AFTER mining: the teacher
        # scored the raw (statement-shaped) crop, the model trains on the
        # interrogative framing — statement ↔ question alignment
        if cfg.question_wrap_prob > 0:
            queries = [
                _QUESTION_FRAMES[int(rng.integers(0, len(_QUESTION_FRAMES)))]
                .format(q)
                if rng.random() < cfg.question_wrap_prob else q
                for q in queries
            ]
        return queries, passages, targets


def pretrain_encoder(
    chunk_texts: List[str],
    enc_cfg: Optional[EncoderConfig] = None,
    pre_cfg: PretrainConfig = PretrainConfig(),
    train_cfg: TrainConfig = TrainConfig(lr=3e-4),
    mesh=None,
    log_every: int = 50,
    teacher_score_fn=None,
    init_params=None,
) -> Tuple[EmbeddingModel, Dict]:
    """Train from scratch on the corpus; returns the ready EmbeddingModel.

    ``teacher_score_fn`` swaps the BM25 mining teacher for a custom one
    (PairSampler docstring — dense self-training).  ``init_params``
    continues from an existing checkpoint instead of random init."""
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()  # the scan-chunked train step is a long compile
    enc_cfg = enc_cfg or EncoderConfig()
    if mesh is None:
        n = len(jax.devices())
        mesh = make_mesh({"data": n, "model": 1})
    module, params, opt_state, step = init_training(enc_cfg, train_cfg, mesh, seed=pre_cfg.seed)
    if init_params is not None:
        params = init_params
    rng = np.random.default_rng(pre_cfg.seed)
    history = []
    sampler = PairSampler(chunk_texts, pre_cfg, teacher_score_fn=teacher_score_fn)
    # token sequences must stay inside the encoder's position table
    max_len = min(pre_cfg.max_len, enc_cfg.max_len)
    K = max(1, int(pre_cfg.steps_per_dispatch))
    multi = getattr(step, "chunked", None)
    # stacked per-chunk metrics, read AFTER the loop: forcing a float()
    # every chunk would re-serialize host and device (the dispatch is
    # async — sampling chunk i+1 overlaps the device running chunk i)
    chunk_metrics = []
    i = 0
    while i < pre_cfg.steps:
        K_eff = min(K, pre_cfg.steps - i)
        if multi is not None and K_eff > 1:
            qs, ps, ts = [], [], []
            for _ in range(K_eff):
                q_texts, p_texts, targets = sampler.sample(rng)
                qs.append(tokenize_batch(q_texts, max_len, enc_cfg.vocab_bits))
                ps.append(tokenize_batch(p_texts, max_len, enc_cfg.vocab_bits))
                ts.append(targets)
            q = jnp.asarray(np.stack(qs))
            p = jnp.asarray(np.stack(ps))
            if ts[0] is None:
                params, opt_state, metrics = multi(params, opt_state, q, p)
            else:
                params, opt_state, metrics = multi(
                    params, opt_state, q, p,
                    jnp.asarray(np.stack(ts).astype(np.float32)))
            chunk_metrics.append((i, K_eff, metrics))
            i += K_eff
        else:
            q_texts, p_texts, targets = sampler.sample(rng)
            q = jnp.asarray(tokenize_batch(q_texts, max_len, enc_cfg.vocab_bits))
            p = jnp.asarray(tokenize_batch(p_texts, max_len, enc_cfg.vocab_bits))
            if targets is None:
                params, opt_state, metrics = step(params, opt_state, q, p)
            else:
                params, opt_state, metrics = step(
                    params, opt_state, q, p, jnp.asarray(targets))
            chunk_metrics.append((i, 1, metrics))
            i += 1
    for base, width, metrics in chunk_metrics:
        loss = np.atleast_1d(np.asarray(metrics["loss"]))
        acc = np.atleast_1d(np.asarray(metrics["accuracy"]))
        for k in range(width):
            s_idx = base + k
            if s_idx % log_every == 0 or s_idx == pre_cfg.steps - 1:
                history.append({
                    "step": s_idx,
                    "loss": float(loss[k]),
                    "accuracy": float(acc[k]),
                })
    model = EmbeddingModel(enc_cfg, params=jax.device_get(params))
    return model, {"history": history, "final": history[-1] if history else {}}


def ensemble_teacher(
    chunk_texts: List[str],
    dense_model: EmbeddingModel,
    alpha: float = 0.5,
    vocab_bits: int = 18,
):
    """A mining teacher mixing BM25 with a distilled dense model.

    Stage-2 self-training with a dense-only teacher REGRESSES (measured:
    0.47 → 0.325 in the encoder_selftrain run — the dense
    teacher's errors compound without lexical grounding).  The ensemble
    keeps BM25 as the anchor: ``score = alpha·bm25_norm + (1−alpha)·dense``
    with each component max-normalized per query, so the dense co-teacher
    can only PROMOTE candidates the lexical teacher already ranks, the
    same failure-containment argument as the serving fusion.  Pass the
    returned callable as ``pretrain_encoder(teacher_score_fn=...)``.
    """
    import jax.numpy as jnp

    from ..index.build import _build_sparse
    from ..ops.bm25 import bm25_scores, encode_queries

    texts = [t for t in chunk_texts if len(t) >= 2 * 4]
    n_pad = -(-len(texts) // 128) * 128
    sparse = _build_sparse(texts, n_pad, vocab_bits=vocab_bits)
    chunk_emb = np.asarray(dense_model.embed(texts), np.float32)

    def teacher(queries: List[str]) -> np.ndarray:
        qt = encode_queries(queries, max_terms=48, vocab_bits=vocab_bits)
        bm = np.asarray(bm25_scores(sparse, qt, n_pad))[:, : len(texts)]
        bm = bm / np.maximum(bm.max(axis=1, keepdims=True), 1e-9)
        qe = np.asarray(dense_model.embed(queries), np.float32)
        dn = qe @ chunk_emb.T
        dn = dn / np.maximum(dn.max(axis=1, keepdims=True), 1e-9)
        return alpha * bm + (1.0 - alpha) * dn

    return teacher


# ------------------------------------------------------------ persistence

def save_params(model: EmbeddingModel, path: Path) -> None:
    """Flatten the param tree into an npz keyed by tree paths."""
    flat = jax.tree_util.tree_flatten_with_path(model.params)[0]
    arrays = {
        "/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
        for p, v in flat
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_params(model: EmbeddingModel, path: Path) -> EmbeddingModel:
    """Restore params saved by save_params into a fresh model."""
    z = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(model.params)
    restored = []
    for p, v in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in p)
        arr = z[key]
        assert arr.shape == v.shape, f"shape mismatch at {key}"
        restored.append(jnp.asarray(arr, v.dtype))
    params = jax.tree_util.tree_unflatten(treedef, restored)
    return EmbeddingModel(model.cfg, params=params)

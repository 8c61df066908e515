"""Hit aggregation + bonus scoring as sorted-segment ops.

Replaces the reference's lock-guarded Python dict loop
(reference src/retrieval.py:1552-1599) and its scoring rule
(reference src/retrieval.py:1639-1661):

    final = max(similarities)
            * (1 + 0.2 * (distinct_query_hits - 1))      # query-hit bonus
            * (1 + 0.1 * (distinct_methods - 1))          # method diversity

with the same dedup semantics: a query is counted once per key even if
several of its hits land on the key (parent-page dedup,
reference src/retrieval.py:1596-1599), and a method is counted once per key
(reference src/retrieval.py:1585-1593).

Device formulation: every (query, method, rank) hit becomes one row of flat
arrays ``(key, sim, qid, mid)``; we sort by composite integer keys and use
first-occurrence flags + segment reductions — static shapes, O(L log L),
no host round-trips.  Keys are aggregation targets: ``page_seg`` row values
when ``return_parent_pages`` else chunk row ids.
"""

from __future__ import annotations

import dataclasses
import functools
import jax
import jax.numpy as jnp

from .topk import NEG_INF

_BIG = 2**30  # a Python int: importing this module creates no device array

QUERY_BONUS = 0.2   # reference src/retrieval.py:1645
METHOD_BONUS = 0.1  # reference src/retrieval.py:1655


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FusedCandidates:
    """Top-n aggregated candidates, sorted by final score descending."""

    key: jax.Array        # i32 [top_n] — page_seg or chunk row (-1 = empty slot)
    score: jax.Array      # f32 [top_n] — final (bonused) score
    base_sim: jax.Array   # f32 [top_n] — max similarity AS FUSED: when the
                          # engine runs with dense_weight != 1.0 the
                          # non-BM25 arms' sims are pre-scaled by it before
                          # fusion, so dense-only keys report the weighted
                          # (e.g. halved) score here and in materialize()'s
                          # "distance"/"base_similarity" fields (DESIGN.md
                          # "Sum-fusion")
    n_queries: jax.Array  # i32 [top_n] — distinct queries hitting the key
    n_methods: jax.Array  # i32 [top_n] — distinct retrieval methods
    rep_row: jax.Array    # i32 [top_n] — chunk row achieving the max sim


def _first_occurrence(sorted_vals: jax.Array) -> jax.Array:
    prev = jnp.concatenate([jnp.full((1,), -1, sorted_vals.dtype), sorted_vals[:-1]])
    return sorted_vals != prev


@functools.partial(jax.jit, static_argnames=("top_n", "mode"))
def fuse_hits(
    key: jax.Array,
    sim: jax.Array,
    qid: jax.Array,
    mid: jax.Array,
    row: jax.Array,
    valid: jax.Array,
    *,
    top_n: int,
    mode: str = "max",
) -> FusedCandidates:
    """Aggregate flat hit lists into bonus-scored, deduped top-n candidates.

    All inputs are ``[L]`` flat arrays (L = queries × methods × k, static).

    ``mode`` selects the cross-method base score:

    - ``"max"`` (reference parity, src/retrieval.py:1639-1661):
      ``base = max(sims over the key)``.
    - ``"sum"``: ``base = Σ over methods of max(0, per-method max sim)``
      — each retrieval arm contributes its best (clamped-nonnegative)
      score for the key instead of competing winner-takes-all.  Measured
      on the config-4 quality eval (scripts/fusion_sweep.py, DESIGN.md
      "Sum-fusion"): with the engine's 0.5 dense weight this lifts the
      served hybrid from 0.89 to 0.945 hit@10 (BM25-alone 0.905) and is
      far more robust to a weak dense arm (0.885 vs 0.75 at random
      init).  Bonuses, dedup, and every output field keep identical
      semantics; ``base_sim``/``rep_row`` still report the raw max hit.

    Formulation note: everything is sorts + per-position scans, with no
    scatter: per-key reductions ride the sorted order (cumsum-difference
    for counts, a segmented max scan for the base similarity) and the
    top-n selection is one multi-operand sort that carries every output
    field.
    """
    L = key.shape[0]
    key_s = jnp.where(valid, key, _BIG)

    # ---- lexicographic sort by (key, qid): count distinct queries per key ----
    # multi-operand lax.sort avoids composite-integer keys (which overflow
    # int32 once key * max_queries exceeds 2**31)
    ck, cq, sim_s, row_s = jax.lax.sort(
        (key_s, qid, sim, row), num_keys=2
    )
    new_key = _first_occurrence(ck)
    new_pair = new_key | _first_occurrence(cq)
    # distinct (key, qid) pairs inside each segment: cumsum difference —
    # the running pair count minus its value just before the segment
    # started (propagated by cummax over the nondecreasing cumsum)
    pair_cum = jnp.cumsum(new_pair.astype(jnp.int32))
    pair_base = jax.lax.cummax(
        jnp.where(new_key, pair_cum - new_pair.astype(jnp.int32), 0)
    )
    nq = pair_cum - pair_base                    # per-position; valid at seg last

    # segmented max of sim (+ the row achieving it): one associative scan
    # with the standard segmented-max operator — flags reset at key starts
    sim_masked = jnp.where(ck < _BIG, sim_s, NEG_INF)

    def _seg_max(a, b):
        f1, v1, r1 = a
        f2, v2, r2 = b
        v = jnp.where(f2, v2, jnp.maximum(v1, v2))
        # ties keep the larger row id (matches the old segment_max(rep))
        r = jnp.where(
            f2, r2,
            jnp.where(v1 > v2, r1, jnp.where(v2 > v1, r2, jnp.maximum(r1, r2))),
        )
        return f1 | f2, v, r

    _, base, rep = jax.lax.associative_scan(
        _seg_max, (new_key, sim_masked, row_s)
    )

    # ---- lexicographic sort by (key, mid): count distinct methods per key ----
    # ck_m equals ck elementwise (same key multiset), so per-position
    # values align with the first sort's segments
    ck_m, cm, sim_m = jax.lax.sort((key_s, mid, sim), num_keys=2)
    new_pm = new_key | _first_occurrence(cm)
    pm_cum = jnp.cumsum(new_pm.astype(jnp.int32))
    pm_base = jax.lax.cummax(
        jnp.where(new_key, pm_cum - new_pm.astype(jnp.int32), 0)
    )
    nm = pm_cum - pm_base

    # per-key values live at segment-LAST positions
    last = jnp.concatenate([ck[1:] != ck[:-1], jnp.ones((1,), bool)])
    live = last & (ck < _BIG)

    if mode == "sum":
        # per-(key, mid) segmented max of sim, in the (key, mid) order
        simm_masked = jnp.where(ck_m < _BIG, sim_m, NEG_INF)

        def _pair_max(a, b):
            f1, v1 = a
            f2, v2 = b
            return f1 | f2, jnp.where(f2, v2, jnp.maximum(v1, v2))

        _, pair_max = jax.lax.associative_scan(
            _pair_max, (new_pm, simm_masked)
        )
        pair_last = jnp.concatenate(
            [new_pm[1:], jnp.ones((1,), bool)]
        )
        # each method's best hit contributes once, clamped to >= 0 so the
        # running key-sum stays nondecreasing (lets cummax recover the
        # segment base) and a negatively-scored arm never *drags down* a
        # key another arm found (absent arm == worthless arm == 0)
        contrib = jnp.where(
            pair_last & (pair_max > NEG_INF / 2),
            jnp.maximum(pair_max, 0.0), 0.0,
        )
        csum = jnp.cumsum(contrib)
        sum_base = jax.lax.cummax(jnp.where(new_key, csum - contrib, 0.0))
        base_c = csum - sum_base            # valid at key-last positions
    elif mode == "max":
        base_c = base
    else:
        raise ValueError(f"unknown fuse mode {mode!r}")

    qb = 1.0 + QUERY_BONUS * jnp.maximum(nq - 1, 0).astype(jnp.float32)
    mb = 1.0 + METHOD_BONUS * jnp.maximum(nm - 1, 0).astype(jnp.float32)
    final = jnp.where(live, base_c * qb * mb, NEG_INF)

    # ---- top-n: one descending sort carrying every output field ----
    k = min(top_n, L)
    neg, ukey_o, base_o, nq_o, nm_o, rep_o = jax.lax.sort(
        (-final, ck, base, nq, nm, rep), num_keys=1
    )
    top_scores = -neg[:k]
    empty = top_scores <= NEG_INF / 2
    return FusedCandidates(
        key=jnp.where(empty, -1, ukey_o[:k]),
        score=jnp.where(empty, 0.0, top_scores),
        base_sim=jnp.where(empty, 0.0, base_o[:k]),
        n_queries=jnp.where(empty, 0, nq_o[:k]),
        n_methods=jnp.where(empty, 0, nm_o[:k]),
        rep_row=jnp.where(empty, -1, rep_o[:k]),
    )

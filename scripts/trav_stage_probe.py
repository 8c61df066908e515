"""Stage-piece timings for the 1M-row traversal hop (bench_traversal_1m
shape): what dominates — the [G,A,W] matmul (and at which precision), the
W-wide lax.top_k, or approx_max_k?  Writes runs/trav_stage.json.

Usage (on the GPU): ``PYTHONPATH=. python scripts/trav_stage_probe.py``.
No result recorded on the GPU yet.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

N_DOCS, CPD, D = 6, 170_000, 1024
N = N_DOCS * CPD
key = jax.random.PRNGKey(11)


@jax.jit
def gen(key):
    e = jax.random.normal(key, (N, D), jnp.float32)
    return e / jnp.linalg.norm(e, axis=1, keepdims=True)


emb = gen(key)
np.asarray(jnp.sum(emb[:2]))
window = -(-CPD // 128) * 128
ws = jnp.arange(3, dtype=jnp.int32) * CPD
emb_w = jax.jit(
    lambda e: jax.vmap(
        lambda s: jax.lax.dynamic_slice(e, (s, jnp.int32(0)), (window, D))
    )(ws)
)(emb)
np.asarray(jnp.sum(emb_w[:, :2, :2]))

out = {}


def timeit(label, fn, reps=5):
    fn()  # compile
    np.asarray(jnp.sum(jnp.asarray(0.0)))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / reps
    out[label] = round(dt * 1e3, 1)
    print(f"{label}: {dt * 1e3:.1f} ms", flush=True)


G, A = 3, 160  # triangulation shape (the wider one)
qk = jax.random.fold_in(key, 1)
qv = jax.random.normal(qk, (G, A, D), jnp.float32)

# every operand passed as an argument — a closure capture turns the 4 GB
# window into a per-executable captured CONSTANT (slow upload per jit)
mm_hi = jax.jit(lambda v, e: jnp.einsum(
    "gad,gwd->gaw", v, e, preferred_element_type=jnp.float32,
    precision=jax.lax.Precision.HIGHEST))
mm_def = jax.jit(lambda v, e: jnp.einsum(
    "gad,gwd->gaw", v, e, preferred_element_type=jnp.float32))
mm_bf16 = jax.jit(lambda v, e: jnp.einsum(
    "gad,gwd->gaw", v.astype(jnp.bfloat16), e.astype(jnp.bfloat16),
    preferred_element_type=jnp.float32))
tk = jax.jit(lambda v, e: jax.lax.top_k(mm_hi(v, e), 31))
tk_only = jax.jit(lambda s: jax.lax.top_k(s, 31))
ax = jax.jit(lambda v, e: jax.lax.approx_max_k(mm_hi(v, e), 31))
ax_only = jax.jit(lambda s: jax.lax.approx_max_k(s, 31))
tk_bf = jax.jit(lambda v, e: jax.lax.top_k(mm_bf16(v, e), 31))
ax_bf = jax.jit(lambda v, e: jax.lax.approx_max_k(mm_bf16(v, e), 31))

scores = mm_hi(qv, emb_w)
np.asarray(jnp.sum(scores[:, :2, :2]))

timeit("mm_f32_highest", lambda: mm_hi(qv, emb_w))
timeit("mm_f32_default", lambda: mm_def(qv, emb_w))
timeit("mm_bf16", lambda: mm_bf16(qv, emb_w))
timeit("topk_only", lambda: tk_only(scores))
timeit("approx_only", lambda: ax_only(scores))
timeit("mm_hi+topk", lambda: tk(qv, emb_w))
timeit("mm_hi+approx", lambda: ax(qv, emb_w))
timeit("mm_bf16+topk", lambda: tk_bf(qv, emb_w))
timeit("mm_bf16+approx", lambda: ax_bf(qv, emb_w))

os.makedirs("runs", exist_ok=True)
json.dump(out, open("runs/trav_stage.json", "w"), indent=1)
print(json.dumps(out))

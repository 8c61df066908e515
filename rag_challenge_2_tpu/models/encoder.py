"""On-device text embedding encoder.

Replaces the reference's remote embedding API (Qwen ``text-embedding-v4``,
dim 1024, batches of 10 over HTTP — reference src/api_requests.py:55-127,
src/ingestion.py:56-77) with a batched transformer encoder forward on the
accelerator: corpus embedding becomes a data-parallel sweep of matmuls
instead of a rate-limited network loop (BASELINE.md config 4).

The model is plain ``jax.numpy`` over a nested-dict parameter tree whose
key paths are ``params/tok_embed/embedding``, ``params/block{i}/ln1``,
``attn/{query,key,value,out}/{kernel,bias}``, ``mlp_in``, ``mlp_out``,
``moe/{router,w_in,w_out}``, ``ln_f`` and ``proj`` — the layout every
saved ``encoder_params.npz`` uses (models/pretrain.save_params).

Design notes:
  * bf16 activations / f32 params, f32 layer-norm statistics;
  * fixed max_len with padding masks — static shapes under jit;
  * hashed-vocab token ids from utils/tokenize.py — no vocab file, any
    corpus maps into the same id space as the BM25 path;
  * mean-pool + linear projection + L2 norm → unit vectors, so inner
    product == cosine, matching how the reference uses IndexFlatIP on
    unit-norm API embeddings.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils import tokenize as tok

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_bits: int = 15          # 32k hashed vocab (embedding table rows)
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 512
    out_dim: int = 1024           # matches the reference embedding dim
    dtype: Any = jnp.bfloat16
    moe_experts: int = 0          # >0 → odd blocks use a top-2 MoE FFN (ep)

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits

    def use_moe(self, layer: int) -> bool:
        return self.moe_experts > 0 and layer % 2 == 1


# ---------------------------------------------------------------- init

_lecun = jax.nn.initializers.lecun_normal()


def _embed_init(key, n, d):
    return jax.random.normal(key, (n, d), jnp.float32) * np.float32(1.0 / np.sqrt(d))


def _dense_init(key, d_in, d_out):
    return {"kernel": _lecun(key, (d_in, d_out), jnp.float32),
            "bias": jnp.zeros((d_out,), jnp.float32)}


def _ln_init(d):
    return {"scale": jnp.ones((d,), jnp.float32),
            "bias": jnp.zeros((d,), jnp.float32)}


def init_block_params(cfg: EncoderConfig, key, use_moe: bool = False):
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    ks = jax.random.split(key, 8)
    attn = {}
    for i, name in enumerate(("query", "key", "value")):
        attn[name] = {
            "kernel": _lecun(ks[i], (d, d), jnp.float32).reshape(d, h, hd),
            "bias": jnp.zeros((h, hd), jnp.float32),
        }
    attn["out"] = {
        "kernel": _lecun(ks[3], (d, d), jnp.float32).reshape(h, hd, d),
        "bias": jnp.zeros((d,), jnp.float32),
    }
    p = {"ln1": _ln_init(d), "attn": attn, "ln2": _ln_init(d)}
    if use_moe:
        from .moe import init_moe_params

        p["moe"] = init_moe_params(ks[4], cfg.moe_experts, d, cfg.d_ff)
    else:
        p["mlp_in"] = _dense_init(ks[5], d, cfg.d_ff)
        p["mlp_out"] = _dense_init(ks[6], cfg.d_ff, d)
    return p


def init_params(cfg: EncoderConfig, key) -> dict:
    """Random encoder parameters: ``{"params": {...}}`` (f32 leaves)."""
    ks = jax.random.split(key, cfg.n_layers + 3)
    p = {
        "tok_embed": {"embedding": _embed_init(ks[0], cfg.vocab_size, cfg.d_model)},
        "pos_embed": {"embedding": _embed_init(ks[1], cfg.max_len, cfg.d_model)},
        "ln_f": _ln_init(cfg.d_model),
        "proj": _dense_init(ks[2], cfg.d_model, cfg.out_dim),
    }
    for i in range(cfg.n_layers):
        p[f"block{i}"] = init_block_params(cfg, ks[3 + i], cfg.use_moe(i))
    return {"params": p}


# ---------------------------------------------------------------- forward

def layer_norm(p, x, dtype):
    """LayerNorm with f32 statistics, output in ``dtype``."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, axis=-1, keepdims=True) - mean * mean, 0.0)
    y = (xf - mean) * jax.lax.rsqrt(var + LN_EPS)
    return (y * p["scale"] + p["bias"]).astype(dtype)


def dense(p, x, dtype):
    return x.astype(dtype) @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


def attention(p, x, pad, dtype):
    """Multi-head self-attention; ``pad`` [B, L] bool marks real tokens."""
    x = x.astype(dtype)

    def proj(name):
        w = p[name]
        return (jnp.einsum("bld,dhk->blhk", x, w["kernel"].astype(dtype))
                + w["bias"].astype(dtype))

    q, k, v = proj("query"), proj("key"), proj("value")
    q = q / jnp.sqrt(jnp.float32(q.shape[-1])).astype(dtype)
    w = jnp.einsum("bqhd,bkhd->bhqk", q, k)
    mask = pad[:, None, :, None] & pad[:, None, None, :]
    w = jnp.where(mask, w, jnp.finfo(dtype).min)
    w = jax.nn.softmax(w).astype(dtype)
    o = jnp.einsum("bhqk,bkhd->bqhd", w, v)
    out = p["out"]
    return (jnp.einsum("blhk,hkd->bld", o, out["kernel"].astype(dtype))
            + out["bias"].astype(dtype))


def _seq_parallel(x, mesh: Optional[Mesh]):
    # sequence parallelism (GSPMD formulation): activations between blocks
    # shard their sequence axis over the ``model`` mesh axis, so norms,
    # residuals and elementwise ops run sequence-sharded and XLA inserts the
    # all-gather/reduce-scatter pair around attention — the Megatron-SP
    # communication pattern without hand-written collectives.
    if mesh is not None and "model" in mesh.shape:
        x = jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P("data", "model", None)))
    return x


def block(p, x, pad, cfg: EncoderConfig, mesh: Optional[Mesh] = None):
    """One pre-norm transformer block → ``(x, moe_aux)``; the FFN is the
    top-2 MoE when ``p`` carries a ``moe`` subtree."""
    dtype = cfg.dtype
    x = _seq_parallel(x, mesh)
    x = x + attention(p["attn"], layer_norm(p["ln1"], x, dtype), pad, dtype)
    h = layer_norm(p["ln2"], x, dtype)
    aux = jnp.float32(0.0)
    if "moe" in p:
        from .moe import moe_ffn

        h, aux = moe_ffn(p["moe"], h, dtype=dtype, mesh=mesh)
    else:
        h = jax.nn.gelu(dense(p["mlp_in"], h, dtype))
        h = dense(p["mlp_out"], h, dtype)
    return _seq_parallel(x + h, mesh), aux


def embed_tokens_in(p, token_ids, cfg: EncoderConfig):
    """Token + position embeddings → ``(x [B, L, d], pad [B, L])``."""
    pad = token_ids >= 0
    ids = jnp.maximum(token_ids, 0)
    x = jnp.take(p["tok_embed"]["embedding"], ids, axis=0).astype(cfg.dtype)
    pos = p["pos_embed"]["embedding"][: token_ids.shape[1]].astype(cfg.dtype)
    return x + pos[None], pad


def pool_head(p, x, pad, cfg: EncoderConfig):
    """Final norm, masked mean-pool, projection, L2 normalisation."""
    x = layer_norm(p["ln_f"], x, cfg.dtype)
    denom = jnp.maximum(jnp.sum(pad, axis=1, keepdims=True), 1)
    pooled = jnp.sum(x * pad[..., None], axis=1) / denom
    out = dense(p["proj"], pooled.astype(jnp.float32), jnp.float32)
    return out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-9)


def encode(params, token_ids, cfg: EncoderConfig, mesh: Optional[Mesh] = None,
           with_aux: bool = False):
    """token_ids: i32 [B, L], padded with -1 → f32 [B, out_dim] unit-norm.

    ``mesh`` turns on sequence parallelism.  ``with_aux=True`` returns
    ``(embeddings, moe_aux)``, the summed MoE load-balance loss of every
    MoE block (0 for a dense encoder)."""
    p = params["params"]
    x, pad = embed_tokens_in(p, token_ids, cfg)
    aux = jnp.float32(0.0)
    for i in range(cfg.n_layers):
        x, a = block(p[f"block{i}"], x, pad, cfg, mesh)
        aux = aux + a
    out = pool_head(p, x, pad, cfg)
    return (out, aux) if with_aux else out


def tokenize_batch(
    texts, max_len: int, vocab_bits: int, bucket_len: bool = False
) -> np.ndarray:
    """Host-side: texts → padded i32 [B, L] hashed-token batch.

    ``bucket_len=True`` pads L to the next power of two ≥ the batch's
    longest text (min 32, cap max_len) instead of always max_len: a
    300-token chunk corpus then runs 256-wide attention instead of
    512-wide — ~2× the FLOPs saved, log-many compiled shapes.

    Tokenization runs through the C++ tokenizer when available (ids are
    byte-identical to the Python path, tested in test_native); the
    pure-Python tokenizer is slow enough to hold back corpus embedding."""
    from ..utils.native import tokenize_queries_native

    texts = list(texts)
    out = tokenize_queries_native(texts, vocab_bits, max_len)
    if out is None:  # pure-Python fallback (no toolchain)
        id_lists = [tok.token_ids(t, vocab_bits)[:max_len] for t in texts]
        out = np.full((len(texts), max_len), -1, np.int32)
        for i, ids in enumerate(id_lists):
            out[i, : len(ids)] = ids
    if bucket_len:
        lens = (out >= 0).sum(axis=1)
        longest = int(lens.max()) if len(texts) else 1
        L = 32
        while L < max(longest, 1):
            L *= 2
        out = out[:, : min(L, max_len)]
    return np.ascontiguousarray(out)


class EmbeddingModel:
    """Bundled config + params + jitted batched forward.

    The drop-in replacement for ``BaseQwenProcessor.get_embeddings``
    (reference src/api_requests.py:101-127): call ``.embed(texts)`` and get
    ``[B, out_dim]`` unit-norm float32 embeddings, computed on device.
    """

    def __init__(self, cfg: EncoderConfig = EncoderConfig(), params=None, seed: int = 0):
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, jax.random.PRNGKey(seed))
        self.params = params
        self._fwd = jax.jit(functools.partial(encode, cfg=cfg))

    def embed_tokens(self, token_ids: jax.Array) -> jax.Array:
        return self._fwd(self.params, token_ids)

    @staticmethod
    def _bucket(n: int, batch_size: int) -> int:
        """Pad to the next power of two (min 8) up to batch_size: small
        query batches stop paying the full corpus-batch compute while the
        number of compiled shapes stays logarithmic."""
        b = 8
        while b < min(n, batch_size):
            b *= 2
        return min(b, batch_size)

    def _embed_pending(self, texts, batch_size: int):
        # dispatch every batch before pulling any result: device compute
        # overlaps host tokenization of the next batch
        pending = []
        for s in range(0, len(texts), batch_size):
            chunk = texts[s : s + batch_size]
            ids = tokenize_batch(
                chunk, self.cfg.max_len, self.cfg.vocab_bits, bucket_len=True
            )
            bucket = self._bucket(len(chunk), batch_size)
            if len(chunk) < bucket:
                ids = np.pad(ids, ((0, bucket - len(chunk)), (0, 0)), constant_values=-1)
            pending.append((self.embed_tokens(jnp.asarray(ids)), len(chunk)))
        return pending

    def embed(self, texts, batch_size: int = 512, max_in_flight: int = 8) -> np.ndarray:
        # bounded pipeline: dispatch overlaps host tokenization, but only
        # ``max_in_flight`` device output buffers coexist — an unbounded
        # pending list holds the ENTIRE corpus embedding matrix on device
        # at once (≈4 GB f32 at 1M chunks) before the first pull
        outs: list = []
        window: list = []
        for s in range(0, len(texts), batch_size):
            chunk = texts[s : s + batch_size]
            ids = tokenize_batch(
                chunk, self.cfg.max_len, self.cfg.vocab_bits, bucket_len=True
            )
            bucket = self._bucket(len(chunk), batch_size)
            if len(chunk) < bucket:
                ids = np.pad(ids, ((0, bucket - len(chunk)), (0, 0)), constant_values=-1)
            window.append((self.embed_tokens(jnp.asarray(ids)), len(chunk)))
            if len(window) >= max_in_flight:
                o, n = window.pop(0)
                outs.append(np.asarray(o)[:n])
        outs.extend(np.asarray(o)[:n] for o, n in window)
        return np.concatenate(outs) if outs else np.zeros((0, self.cfg.out_dim), np.float32)

    def embed_device(self, texts, batch_size: int = 256) -> jax.Array:
        """`embed` without the device→host pull: embeddings stay resident
        for a consumer that runs on device anyway (QueryEngine.search
        accepts them directly), saving a host round trip per query on
        the serving path.  Meant for QUERY-scale batches — the full result
        lives on device, so corpus-scale embedding should use `embed`
        (bounded in-flight window)."""
        pending = self._embed_pending(texts, batch_size)
        outs = [o[:n] for o, n in pending]
        if not outs:
            return jnp.zeros((0, self.cfg.out_dim), jnp.float32)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs)

"""Time the two gathers of the retrieval path as XLA compiles them.

1. The IVF probe (index/ivf.ivf_search): 127 queries, nprobe 8, over a
   clustered 1M × 1024 corpus with K = 4096 lists (BASELINE config 3),
   for f32, bf16 and int8 stores.
2. The BM25 posting gather (ops/bm25): B·T·W = 8·64·512 over a synthetic
   CSR of ~67M postings (2^18 terms, lists of 1..512 postings).

For each it prints the host-clock time per call (after warm-up, ended by
``block_until_ready``), the device time per call summed from a profiler
trace, the bytes the gather has to read, and the achieved bytes/s against
the card's published memory bandwidth.  For the probe it also says whether
the gathered ``[B, W, D]`` rows reach device memory: any instruction of
that shape outside a fusion in the compiled program is a buffer XLA
writes and reads back.

Usage (on the GPU)::

    PYTHONPATH=. python scripts/probe_profile.py [--rows 1000000] [--trace-dir DIR]

The last line of standard output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import re
import subprocess
import time
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np

from rag_challenge_2_tpu.index.ivf import build_ivf, ivf_search, quantize_ivf
from rag_challenge_2_tpu.index.schema import SparseIndex
from rag_challenge_2_tpu.ops.bm25 import _gather_contributions, bm25_topk

# Published memory bandwidth per device kind (NVIDIA data sheets, SXM).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def timed(fn, reps: int = 20) -> float:
    """Median seconds per call over 3 windows of ``reps`` calls."""
    jax.block_until_ready(fn())
    per = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / reps)
    return float(np.median(per))


def device_seconds(fn, trace_dir: str, reps: int = 10) -> tuple[float, dict]:
    """Device-busy seconds per call from a profiler trace of ``reps`` calls,
    and the busiest kernels (name → ms per call)."""
    jax.block_until_ready(fn())
    with jax.profiler.trace(trace_dir):
        out = None
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
    paths = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(paths[-1])
    per_kernel = defaultdict(float)
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or plane.lines:
            for ev in line.events:
                per_kernel[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):       # union of the kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return busy * 1e-9 / reps, {k: round(v * 1e-6 / reps, 4) for k, v in top}


def materialized(hlo: str, shape: str) -> list[str]:
    """Instructions producing ``shape`` that sit in a non-fused computation
    (their result is a device-memory buffer)."""
    hits, comp = [], ""
    for line in hlo.splitlines():
        if line and not line.startswith(" ") and line.rstrip().endswith("{"):
            comp = line.split()[0] if not line.startswith("ENTRY") else "ENTRY"
        elif re.search(r"= \w+\[" + shape + r"\]", line) and "fused" not in comp:
            hits.append(f"{comp}: {line.strip()[:160]}")
    return hits


def profile_probe(rows: int, dim: int, k_lists: int, nq: int, nprobe: int,
                  peak: float, trace_dir: str) -> dict:
    key = jax.random.PRNGKey(0)
    kc, ka, kn, kr, kq = jax.random.split(key, 5)

    @functools.partial(jax.jit, static_argnames=("n",))
    def gen(n):
        centers = jax.random.normal(kc, (1024, dim), jnp.float32)
        centers /= jnp.linalg.norm(centers, axis=1, keepdims=True)
        a = jax.random.randint(ka, (n,), 0, 1024)
        e = centers[a] + (0.35 / np.sqrt(dim)) * jax.random.normal(kn, (n, dim))
        return e / jnp.linalg.norm(e, axis=1, keepdims=True)

    emb = gen(rows)
    r = jax.random.randint(kr, (nq,), 0, rows)
    q = emb[r] + (0.25 / np.sqrt(dim)) * jax.random.normal(kq, (nq, dim))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    t0 = time.perf_counter()
    ivf = build_ivf(emb, n_clusters=k_lists, iters=8,
                    max_list_size=max(2 * rows // k_lists, 16))
    jax.block_until_ready(ivf.emb_perm)
    build_s = time.perf_counter() - t0
    del emb
    W = ivf.max_list
    out = {"rows": rows, "dim": dim, "k_lists": ivf.k_clusters, "nq": nq,
           "nprobe": nprobe, "window": W, "build_s": build_s}
    for store in ("f32", "bf16", "int8"):
        if store == "bf16":
            idx = dataclasses.replace(
                ivf, emb_perm=ivf.emb_perm.astype(jnp.bfloat16))
        elif store == "int8":
            idx = quantize_ivf(ivf)
        else:
            idx = ivf
        fn = functools.partial(ivf_search, idx, q, 10, nprobe=nprobe)
        item = jnp.dtype(idx.emb_perm.dtype).itemsize
        gathered = nq * nprobe * W * dim * item
        host_s = timed(fn)
        dev_s, top = device_seconds(fn, f"{trace_dir}/probe_{store}")
        hlo = ivf_search.lower(idx, q, 10, nprobe=nprobe).compile().as_text()
        hits = materialized(hlo, f"{nq},{W},{dim}")
        out[store] = {
            "host_ms": host_s * 1e3, "device_ms": dev_s * 1e3,
            "gathered_bytes": gathered,
            "achieved_bytes_per_s": gathered / dev_s,
            "share_of_peak_bandwidth": gathered / dev_s / peak,
            "gather_materialized": bool(hits), "materialized_ops": hits[:3],
            "top_kernels_ms": top,
        }
        print(f"probe {store}: host {host_s * 1e3:.3f} ms, device "
              f"{dev_s * 1e3:.3f} ms/call, {gathered / 1e9:.3f} GB gathered "
              f"→ {gathered / dev_s / 1e12:.3f} TB/s "
              f"({100 * gathered / dev_s / peak:.1f}% of peak); "
              f"[B,W,D] in device memory: {bool(hits)}", flush=True)
        for h in hits[:3]:
            print("   ", h, flush=True)
        for name, ms in top.items():
            print(f"    {ms:9.4f} ms  {name[:100]}", flush=True)
    return out


def profile_bm25(n_rows: int, B: int, T: int, W: int, v_bits: int,
                 peak: float, trace_dir: str) -> dict:
    rng = np.random.default_rng(3)
    V = 1 << v_bits
    counts = rng.integers(1, W + 1, size=V).astype(np.int64)
    indptr = np.zeros(V + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    kc, kt, kq = jax.random.split(jax.random.PRNGKey(3), 3)
    sp = SparseIndex(
        indptr=jnp.asarray(indptr, jnp.int32),
        chunk_ids=jax.random.randint(kc, (nnz,), 0, n_rows, jnp.int32),
        tf=jax.random.randint(kt, (nnz,), 1, 5, jnp.int32).astype(jnp.float32),
        df=jnp.asarray(counts, jnp.float32),
        chunk_len=jnp.full((n_rows,), 300.0, jnp.float32),
        avgdl=jnp.float32(300.0),
        dl=jnp.full((nnz,), 300.0, jnp.float32),
        vocab_bits=v_bits, max_postings=W,
    )
    q_terms = jax.random.randint(kq, (B, T), 0, V, jnp.int32)

    @jax.jit
    def gather(q_terms):
        rows, contrib = _gather_contributions(
            sp.indptr, sp.chunk_ids, sp.tf, sp.df, sp.chunk_len, sp.avgdl,
            q_terms, window=W, k1=1.5, b=0.75, dl=sp.dl)
        return rows, contrib

    n_docs = 6
    doc_masks = jnp.stack([(jnp.arange(n_rows) * n_docs // n_rows) == d
                           for d in range(n_docs)])
    topk = functools.partial(bm25_topk, sp, q_terms, doc_masks, 10, window=W)
    gathered = B * T * W * 12            # chunk id + tf + dl, 4 bytes each
    out = {"nnz": nnz, "B": B, "T": T, "W": W, "gathered_bytes": gathered}
    for name, fn in (("gather", lambda: gather(q_terms)), ("bm25_topk", topk)):
        host_s = timed(fn)
        dev_s, top = device_seconds(fn, f"{trace_dir}/bm25_{name}")
        out[name] = {"host_ms": host_s * 1e3, "device_ms": dev_s * 1e3,
                     "achieved_bytes_per_s": gathered / dev_s,
                     "share_of_peak_bandwidth": gathered / dev_s / peak,
                     "top_kernels_ms": top}
        print(f"bm25 {name}: host {host_s * 1e3:.3f} ms, device "
              f"{dev_s * 1e3:.3f} ms/call over nnz={nnz}; "
              f"{gathered / 1e6:.1f} MB gathered → "
              f"{gathered / dev_s / 1e9:.1f} GB/s", flush=True)
        for k, ms in top.items():
            print(f"    {ms:9.4f} ms  {k[:100]}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--lists", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=127)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--bm25-rows", type=int, default=10_000_000)
    ap.add_argument("--trace-dir", default="runs/probe_profile")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    if dev.device_kind not in PEAK_BYTES_PER_S:
        raise SystemExit(f"no published bandwidth for {dev.device_kind!r}")
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev.device_kind}; nvidia-smi: {smi}", flush=True)

    report = {"device": dev.device_kind, "nvidia_smi": smi,
              "peak_bytes_per_s": peak}
    report["bm25"] = profile_bm25(args.bm25_rows, 8, 64, 512, 18, peak,
                                  args.trace_dir)
    report["probe"] = profile_probe(args.rows, args.dim, args.lists,
                                    args.queries, args.nprobe, peak,
                                    args.trace_dir)
    print(json.dumps(report, default=float))


if __name__ == "__main__":
    main()

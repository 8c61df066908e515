"""FAISS IVF-Flat parity harness (BASELINE config 3's literal bar).

BASELINE.md config 3 asks the device IVF to "match faiss IVF-Flat at the
same (K, nprobe)".  faiss is not installed in the build image, so every
recall figure in the benchmark is measured against the *exact* oracle
instead — a strictly harder reference, but one that never pins the claim
to faiss's own recall curve.  This harness closes that gap wherever
faiss IS available: it builds `faiss.IndexIVFFlat` and `index.ivf.
build_ivf` on the SAME corpus at the SAME (K, nprobe) and equal memory
(both sides store the full f32 rows; any extra rows the device side
stores are reported), and prints one JSON line
with both recall@k curves so the two can be compared point-by-point.

Reference role: src/ingestion.py:79-84 builds the faiss index the
reference serves from; src/retrieval.py:1140 searches it.  The device IVF
(index/ivf.py) replaces it per SURVEY §2.2.

Usage:  python scripts/faiss_parity.py [N] [D] [K] [k]
Without faiss the script exits 0 after printing {"skipped": ...} — the
harness is part of the repo contract even where the dep is absent.
"""
import json
import sys

import numpy as np


def make_corpus(n: int, d: int, seed: int = 0):
    """Clustered (non-isotropic) corpus: IVF recall curves on pure
    Gaussian noise are flat and tell nothing; a mixture with per-cluster
    scale reproduces the list-imbalance regime the balancer targets."""
    rng = np.random.default_rng(seed)
    n_true = max(8, int(np.sqrt(n)))
    centers = rng.standard_normal((n_true, d)).astype(np.float32)
    assign = rng.integers(0, n_true, size=n)
    scale = rng.uniform(0.05, 0.4, size=n_true).astype(np.float32)
    x = centers[assign] + scale[assign, None] * rng.standard_normal(
        (n, d)
    ).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    return x


def exact_topk(x: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    out = np.empty((q.shape[0], k), np.int64)
    for s in range(0, q.shape[0], 128):
        sims = q[s : s + 128] @ x.T
        part = np.argpartition(-sims, k, axis=1)[:, :k]
        row = np.take_along_axis(sims, part, axis=1)
        out[s : s + 128] = np.take_along_axis(
            part, np.argsort(-row, axis=1), axis=1
        )
    return out


def recall(ids: np.ndarray, oracle: np.ndarray) -> float:
    k = oracle.shape[1]
    return float(
        np.mean(
            [len(set(ids[i]) & set(oracle[i])) / k for i in range(len(ids))]
        )
    )


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 512
    k = int(sys.argv[4]) if len(sys.argv) > 4 else 10
    nprobes = (1, 2, 4, 8, 16)

    try:
        import faiss
    except ImportError:
        print(json.dumps({"skipped": "faiss not installed in this image; "
                          "recall is pinned to the exact oracle in bench.py "
                          "instead"}))
        return

    x = make_corpus(n, d)
    rng = np.random.default_rng(1)
    nq = 256
    qi = rng.integers(0, n, size=nq)
    q = x[qi] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
    oracle = exact_topk(x, q, k)

    # --- faiss IVF-Flat, same K ---
    quant = faiss.IndexFlatIP(d)
    fidx = faiss.IndexIVFFlat(quant, d, K, faiss.METRIC_INNER_PRODUCT)
    fidx.train(x)
    fidx.add(x)
    faiss_curve = {}
    for npr in nprobes:
        fidx.nprobe = npr
        _, ids = fidx.search(q, k)
        faiss_curve[npr] = round(recall(ids, oracle), 4)

    # --- device IVF at the same (K, nprobe) ---
    import jax.numpy as jnp

    from rag_challenge_2_tpu.index.ivf import build_ivf, ivf_search

    idx = build_ivf(jnp.asarray(x), n_clusters=K, seed=0)
    jq = jnp.asarray(q)
    device_curve = {}
    for npr in nprobes:
        _, ids = ivf_search(idx, jq, k, nprobe=npr)
        device_curve[npr] = round(recall(np.asarray(ids), oracle), 4)

    pad_rows = int(idx.emb_perm.shape[0]) - n
    print(json.dumps({
        "config": {"N": n, "D": d, "K": K, "k": k,
                   "device_pad_rows": pad_rows,
                   "device_extra_mem_pct": round(100.0 * pad_rows / n, 2)},
        "faiss_recall_at_k": faiss_curve,
        "device_recall_at_k": device_curve,
    }))


if __name__ == "__main__":
    main()

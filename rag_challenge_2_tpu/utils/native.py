"""ctypes bridge to the native CSR builder (native/csr_builder.cpp).

The shared library is built from the tracked source with g++ on first use
and named after a hash of that source (``native/libcsr_builder-<hash>.so``,
ignored by git), so an edited source always gets a fresh build and a
checkout never loads a stale binary.  Every entry point falls back to the
pure-Python implementation when the toolchain or library is unavailable,
so the native path is a speed-up, never a hard dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE_DIR / "csr_builder.cpp"

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
# csr_build/csr_collect share process-global state inside the library; the
# two-phase call must not interleave across threads (concurrent builds
# would read each other's buffers — use-after-free or corrupted CSRs)
_build_lock = threading.Lock()


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _NATIVE_DIR / f"libcsr_builder-{digest}.so"


def _build(lib_path: Path) -> None:
    """Compile into a temporary file, then rename: concurrent builders
    (test workers, pipeline processes) never load a half-written file."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib_path = library_path()
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.csr_build.restype = ctypes.c_int64
        lib.csr_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.csr_collect.restype = None
        lib.csr_collect.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.tokenize_queries.restype = None
        lib.tokenize_queries.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        # no compiler, a failed build or an unloadable library: the
        # pure-Python path takes over
        _load_failed = True
    return _lib


def native_available() -> bool:
    return _ensure_built() is not None


def _pack(texts: List[str]) -> Tuple[bytes, np.ndarray]:
    """Normalized texts → one UTF-8 buffer + int64 offsets[n+1]."""
    from . import tokenize as tok

    encoded = [tok.normalize(t).encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def build_csr_native(
    texts: List[str], vocab_bits: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(indptr i64[V+1], chunk_ids i32[nnz], tf f32[nnz], df f32[V],
    chunk_len f32[n]) or None when the native library is unavailable."""
    lib = _ensure_built()
    if lib is None:
        return None
    buf, offsets = _pack(texts)
    n = len(texts)
    V = 1 << vocab_bits
    with _build_lock:  # covers BOTH phases and the allocations between
        nnz = lib.csr_build(
            buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            np.int32(n), np.int32(vocab_bits),
        )
        indptr = np.zeros(V + 1, np.int64)
        chunk_ids = np.zeros(max(nnz, 1), np.int32)
        tf = np.zeros(max(nnz, 1), np.float32)
        df = np.zeros(V, np.float32)
        chunk_len = np.zeros(max(n, 1), np.float32)
        lib.csr_collect(
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            chunk_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            chunk_len.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return indptr, chunk_ids[:nnz], tf[:nnz], df, chunk_len[:n]


def tokenize_queries_native(
    texts: List[str], vocab_bits: int, max_terms: int
) -> Optional[np.ndarray]:
    """[B, max_terms] i32 hashed term ids (-1 padded), or None."""
    lib = _ensure_built()
    if lib is None:
        return None
    buf, offsets = _pack(texts)
    out = np.full((len(texts), max_terms), -1, np.int32)
    lib.tokenize_queries(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int32(len(texts)), np.int32(vocab_bits), np.int32(max_terms),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out

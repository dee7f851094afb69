"""ctypes bindings of the C++ ingestion fast path (``native/thr_native.cpp``).

The port of the JAX package's ``native.py``, with its names and signatures:

- :class:`NativeAnalyzer` — the tokenizer and vocabulary with ``analyzer.Analyzer``
  and ``analyzer.Vocabulary`` semantics,
- :func:`native_postings_count` / :func:`native_postings_fill` — the CSR and
  term-table assembly of ``index/bm25_index.py``'s Python loops.

:func:`build_library` compiles the repository's own source with ``g++`` and the
flags of ``native/Makefile`` into ``build/native/`` at the root of the checkout
(never into ``native/``), under a file lock, with a hash of the source in the
library's name so that a stale build is never loaded. :func:`available` loads an
already built library, from there or from ``native/libthr_native.so`` (``make -C
native``); it builds nothing. Without a library :func:`available` is False and the
BM25 build takes the pure-Python path, which gives the same arrays. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .analyzer import Analyzer
from .config import RAGConfig, get_settings

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "thr_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
MAKE_LIB = _ROOT / "native" / "libthr_native.so"  # what ``make -C native`` writes
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None
_LOCK = threading.Lock()  # builds and loads within a process; the file lock across processes


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where :func:`build_library` puts the library: the source's hash in its name."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return Path(build_dir or BUILD_DIR) / f"libthr_native-{digest}.so"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.thr_analyzer_new.restype = ctypes.c_void_p
    lib.thr_analyzer_new.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.thr_analyzer_free.argtypes = [ctypes.c_void_p]
    lib.thr_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.thr_vocab_size.restype = ctypes.c_int32
    lib.thr_vocab_size.argtypes = [ctypes.c_void_p]
    lib.thr_vocab_dump.restype = ctypes.c_int64
    lib.thr_vocab_dump.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.thr_postings_count.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.thr_postings_fill.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _load(path: Optional[Path] = None) -> Optional[ctypes.CDLL]:
    """The loaded library: ``path``, else the first built one found (once per process)."""
    global _lib, _load_error
    with _LOCK:
        if path is None and (_lib is not None or _load_error is not None):
            return _lib
        if path is None:
            built = [library_path()] if SOURCE.exists() else []
            path = next((p for p in built + [MAKE_LIB] if p.exists()), None)
        if path is None:
            _load_error = "libthr_native.so not built (run: native.build_library())"
            return None
        try:
            _lib, _load_error = _declare(ctypes.CDLL(str(path))), None
        except (OSError, AttributeError) as e:
            _lib, _load_error = None, f"{path}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _load_error


def build_library(build_dir: Optional[Path] = None) -> bool:
    """Compile ``native/thr_native.cpp`` into ``build_dir`` (default
    ``build/native/``) unless that build exists, and load it. Builds of several
    processes wait on a lock file there. Returns :func:`available`; on a failed
    build :func:`load_error` holds the compiler's output."""
    global _load_error
    out = library_path(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True,
                )
            except OSError as e:
                _load_error = f"{cxx}: {e}"
                return False
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                _load_error = f"{cxx} exit {proc.returncode}:\n{proc.stdout}{proc.stderr}"
                return False
            tmp.replace(out)
    return _load(out) is not None


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


class NativeAnalyzer:
    """C++ tokenizer + vocabulary with the Python Analyzer's semantics."""

    def __init__(self, config: Optional[RAGConfig] = None) -> None:
        lib = self._lib = _require()
        self.config = config or get_settings()
        stop = sorted(Analyzer(self.config)._stopwords)
        blob = b"\0".join(s.encode() for s in stop) + b"\0"
        self._h = lib.thr_analyzer_new(
            blob, len(stop), self.config.analyzer_min_token_len,
            1 if self.config.analyzer_stemming == "light" else 0,
        )
        # ctypes releases the interpreter lock for the C call, and the handle's
        # vocabulary (an unordered_map) is not thread-safe: one call at a time
        self._lock = threading.Lock()

    def __del__(self):  # pragma: no cover
        if getattr(self, "_h", None):
            self._lib.thr_analyzer_free(self._h)

    def tokenize_batch(
        self, texts: Sequence[str], add_to_vocab: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(token_ids i32[total], offsets i64[n+1]); ids index the internal vocab."""
        encoded = [t.encode("utf-8") for t in texts]
        blob = b"".join(encoded)
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        out_tok = ctypes.POINTER(ctypes.c_int32)()
        out_off = ctypes.POINTER(ctypes.c_int64)()
        n_tok = ctypes.c_int64()
        with self._lock:
            self._lib.thr_tokenize(
                self._h, blob, _i64_ptr(offsets), len(texts), 1 if add_to_vocab else 0,
                ctypes.byref(out_tok), ctypes.byref(out_off), ctypes.byref(n_tok),
            )
            tokens = np.ctypeslib.as_array(out_tok, shape=(n_tok.value,)).copy()
            offs = np.ctypeslib.as_array(out_off, shape=(len(texts) + 1,)).copy()
        return tokens, offs

    def token_lists(self, texts: Sequence[str], add: bool = True) -> List[List[int]]:
        tokens, offs = self.tokenize_batch(texts, add_to_vocab=add)
        return [tokens[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))]

    def vocab_terms(self) -> List[str]:
        with self._lock:
            need = self._lib.thr_vocab_dump(self._h, None, 0)
            buf = ctypes.create_string_buffer(int(need))
            self._lib.thr_vocab_dump(self._h, buf, need)
        raw = buf.raw[: int(need)]
        return [s.decode("utf-8") for s in raw.split(b"\0")[:-1]]

    @property
    def vocab_size(self) -> int:
        return int(self._lib.thr_vocab_size(self._h))


def native_postings_count(
    tokens: np.ndarray, offsets: np.ndarray, vocab_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pass 1: (df i64[V], doc_lengths f32[n_docs])."""
    lib = _require()
    n_docs = len(offsets) - 1
    tokens = np.ascontiguousarray(tokens, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    df = np.zeros(vocab_size, np.int64)
    doc_len = np.zeros(n_docs, np.float32)
    total_pairs = np.zeros(1, np.int64)
    lib.thr_postings_count(
        _i32_ptr(tokens), _i64_ptr(offsets), n_docs, vocab_size,
        _i64_ptr(df), _f32_ptr(doc_len), _i64_ptr(total_pairs),
    )
    return df, doc_len


def native_postings_fill(
    tokens: np.ndarray,
    offsets: np.ndarray,
    vocab_size: int,
    df: np.ndarray,
    idf: np.ndarray,
    denom: np.ndarray,  # f32[n_docs]
    k1_plus1: float,
    doc_term_cap: int,
) -> dict:
    """Pass 2: CSR + term table (top-weight selection on overflow, as the Python build)."""
    lib = _require()
    n_docs = len(offsets) - 1
    tokens = np.ascontiguousarray(tokens, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    idf = np.ascontiguousarray(idf, np.float32)
    denom = np.ascontiguousarray(denom, np.float32)
    csr_offsets = np.zeros(vocab_size + 1, np.int64)
    np.cumsum(df, out=csr_offsets[1:])
    nnz = int(csr_offsets[-1])
    postings_doc = np.zeros(nnz, np.int32)
    postings_tf = np.zeros(nnz, np.float32)
    table_ids = np.full((n_docs, doc_term_cap), -2, np.int32)
    table_tfs = np.zeros((n_docs, doc_term_cap), np.float32)
    overflow = np.zeros(1, np.int32)
    lib.thr_postings_fill(
        _i32_ptr(tokens), _i64_ptr(offsets), n_docs, vocab_size,
        _i64_ptr(csr_offsets), _i32_ptr(postings_doc), _f32_ptr(postings_tf),
        doc_term_cap, _f32_ptr(idf), _f32_ptr(denom), ctypes.c_float(k1_plus1),
        _i32_ptr(table_ids), _f32_ptr(table_tfs), _i32_ptr(overflow),
    )
    return {
        "csr_offsets": csr_offsets,
        "postings_doc": postings_doc,
        "postings_tf": postings_tf,
        "table_ids": table_ids,
        "table_tfs": table_tfs,
        "overflow_docs": int(overflow[0]),
    }

"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface under ``build/kernels/`` at the root of the checkout, and is loaded
with ``ctypes``. The library's file name carries a hash of its source and of the
shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a stale build
is never loaded. A failed build raises with
the compiler's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every exported function: (argtypes), all return cudaError_t as int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "fused_topk": {
        "fused_bucket_maxima_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "fused_bucket_maxima_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "fused_bucket_maxima_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "fused_bucket_maxima_int4": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "maxsim": {
        "maxsim_scores_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "maxsim_scores_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "termtable": {
        "termtable_scores_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "termtable_scores_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "dense_scores": {
        "dense_scores_bf16": [_P, _P, _P, _I, _I, _I, _P],
        "dense_scores_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
}

# query-tile widths of the f32-row bodies (csrc/simt_f32.cuh, template kQ)
F32_QUERY_TILES = (16, 128)


def f32_query_tile(b: int) -> int:
    """Query-tile width of the f32-row bodies for a batch of ``b`` queries: 16 up
    to 16 queries (the rows' bytes bound the call, and a wider tile would spend
    its products on absent queries), else 128 (each row read once per 128)."""
    return F32_QUERY_TILES[0] if b <= F32_QUERY_TILES[0] else F32_QUERY_TILES[1]


_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # source name -> nvcc's output (register / spill report)
# Serializes builds and loads within a process. Kernels are launched from several
# threads of the HTTP server (``server.py``): the micro-batcher's dispatcher
# ("thr-microbatcher") runs the engine, and the request handler threads run the
# staged queries and ``/rerank``. Without the lock two first calls could both run
# nvcc into the same temporary file, or both load the library. (Separate processes
# write temporary files of their own pid and rename them into place.)
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one ``nvcc`` each, all
    started together. Returns name -> library path; raises if any build fails."""
    with _LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with the
    argument and return types of its functions declared."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = _build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

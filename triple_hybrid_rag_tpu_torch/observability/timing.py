"""Debug timing decorator with per-op aggregation.

A copy of the JAX package's ``observability/timing.py``: ``@debug_timed(op)``
aggregates count / total / min / max / avg wall ms per operation name, gated by the
``LOG_TIMING`` environment variable or :func:`enable_timing` (no cost when off).
Standard library only.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Callable, Dict

_enabled = os.environ.get("LOG_TIMING", "").strip().lower() in ("1", "true", "yes")
_stats: Dict[str, Dict[str, float]] = {}
_lock = threading.Lock()


def enable_timing(on: bool = True) -> None:
    global _enabled
    _enabled = on


def debug_timed(op: str) -> Callable:
    """Decorator: aggregate wall time under ``op`` when timing is enabled."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not _enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = (time.perf_counter() - t0) * 1e3
                with _lock:
                    s = _stats.setdefault(
                        op, {"count": 0, "total_ms": 0.0, "min_ms": float("inf"), "max_ms": 0.0}
                    )
                    s["count"] += 1
                    s["total_ms"] += dt
                    s["min_ms"] = min(s["min_ms"], dt)
                    s["max_ms"] = max(s["max_ms"], dt)

        return wrapper

    return deco


def timing_stats() -> Dict[str, Dict[str, float]]:
    with _lock:
        out = {}
        for op, s in _stats.items():
            out[op] = {**s, "avg_ms": s["total_ms"] / max(s["count"], 1)}
        return out


def reset_timing_stats() -> None:
    with _lock:
        _stats.clear()

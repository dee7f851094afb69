"""Structured trace events.

The port of the JAX package's ``observability/trace.py``: typed records keyed by
(query id, event) with a monotonically increasing sequence number and field
truncation caps (120 / 200 characters), kept in a bounded in-memory ring with an
optional sink callable. The staged retriever emits one ``stage`` event per timing.
Standard library only.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

MAX_FIELD_CHARS = 200
MAX_NAME_CHARS = 120


def _truncate(v: Any) -> Any:
    if isinstance(v, str) and len(v) > MAX_FIELD_CHARS:
        return v[: MAX_FIELD_CHARS - 1] + "…"
    return v


@dataclass
class Trace:
    event: str
    query_id: str
    seq: int
    ts: float
    fields: Dict[str, Any] = field(default_factory=dict)


class TraceRecorder:
    """Bounded in-memory trace ring with optional sink."""

    def __init__(
        self, capacity: int = 4096, sink: Optional[Callable[[Trace], None]] = None
    ) -> None:
        self._ring: Deque[Trace] = deque(maxlen=capacity)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.sink = sink
        self.enabled = True

    def emit(self, event: str, query_id: str = "-", **fields: Any) -> Optional[Trace]:
        if not self.enabled:
            return None
        t = Trace(
            event=event[:MAX_NAME_CHARS],
            query_id=query_id,
            seq=next(self._seq),
            ts=time.time(),
            fields={k: _truncate(v) for k, v in fields.items()},
        )
        with self._lock:
            self._ring.append(t)
        if self.sink is not None:
            try:
                self.sink(t)
            except Exception:
                pass
        return t

    # convenience typed emitters
    def query_begin(self, query_id: str, query: str) -> None:
        self.emit("query_begin", query_id, query=query)

    def stage(self, query_id: str, stage: str, duration_ms: float, **extra: Any) -> None:
        self.emit("stage", query_id, stage=stage, duration_ms=round(duration_ms, 3), **extra)

    def query_end(self, query_id: str, n_results: int, refused: bool) -> None:
        self.emit("query_end", query_id, n_results=n_results, refused=refused)

    def events(self, event: Optional[str] = None) -> List[Trace]:
        with self._lock:
            items = list(self._ring)
        return [t for t in items if event is None or t.event == event]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# module-level default recorder
tracer = TraceRecorder()

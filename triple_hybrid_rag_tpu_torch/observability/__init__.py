"""Observability: the metrics registry and structured trace events.

The port of the JAX package's ``observability`` exports of ``metrics.py`` and
``trace.py``. Its debug timing, latency visualisation, profiling and logging
helpers are not ported yet (ROADMAP.md, Queue 1).
"""

from .metrics import MetricsRegistry, rag_metrics
from .trace import Trace, TraceRecorder

__all__ = ["MetricsRegistry", "rag_metrics", "Trace", "TraceRecorder"]

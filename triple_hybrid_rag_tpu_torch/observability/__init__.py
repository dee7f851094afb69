"""Observability: metrics, debug timing, structured trace events.

The port of the JAX package's ``observability`` package, with the same exports:
the ``rag_metrics`` registry with Prometheus text exposition (``metrics.py``), the
``@debug_timed`` aggregating decorator (``timing.py``) and typed trace events
(``trace.py``). ``latency_viz.py``, ``logging_config.py`` and ``profiling.py``
(``torch.profiler``) are imported from their modules.
"""

from .metrics import MetricsRegistry, rag_metrics
from .timing import debug_timed, reset_timing_stats, timing_stats
from .trace import Trace, TraceRecorder

__all__ = [
    "MetricsRegistry",
    "rag_metrics",
    "debug_timed",
    "timing_stats",
    "reset_timing_stats",
    "Trace",
    "TraceRecorder",
]

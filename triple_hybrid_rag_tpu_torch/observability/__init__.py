"""Observability: metrics, debug timing, structured trace events.

The port of the JAX package's ``observability`` package, with the same exports:
the ``rag_metrics`` registry with Prometheus text exposition (``metrics.py``), the
``@debug_timed`` aggregating decorator (``timing.py``) and typed trace events
(``trace.py``). ``latency_viz.py``, ``logging_config.py`` and ``profiling.py``
(``torch.profiler``) are imported from their modules. ``profiling.annotate`` opens
the query paths' ``engine.*`` ranges (``engine.staged.*`` in
``Retriever.retrieve``; ``engine.batch``, ``engine.prep`` and its parts and the
program's stages in ``Engine``), and only while a profiler records: otherwise a
range costs a flag read.
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

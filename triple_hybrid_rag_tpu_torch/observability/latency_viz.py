"""Latency visualization: stage timings from the trace ring rendered as text.

A copy of the JAX package's ``observability/latency_viz.py``: per-stage latency
bars (p50 / p95 / max over the ``stage`` trace events) and a waterfall of one
query's ``RetrievalResult.timings``, for the CLI (``query --verbose``) or logs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .trace import Trace, TraceRecorder, tracer as default_tracer

BAR = "▏▎▍▌▋▊▉█"


def _bar(frac: float, width: int = 24) -> str:
    frac = max(0.0, min(1.0, frac))
    full = int(frac * width)
    rem = frac * width - full
    partial = BAR[int(rem * (len(BAR) - 1))] if full < width and rem > 0 else ""
    return "█" * full + partial


def stage_summary(recorder: Optional[TraceRecorder] = None) -> Dict[str, Dict[str, float]]:
    """Aggregate stage events: count/p50/p95/max milliseconds per stage."""
    recorder = recorder or default_tracer
    by_stage: Dict[str, List[float]] = {}
    for t in recorder.events("stage"):
        stage = str(t.fields.get("stage", "?"))
        by_stage.setdefault(stage, []).append(float(t.fields.get("duration_ms", 0.0)))
    out = {}
    for stage, vals in by_stage.items():
        arr = np.asarray(vals)
        out[stage] = {
            "count": float(len(vals)),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
        }
    return out


def render_summary(recorder: Optional[TraceRecorder] = None, width: int = 24) -> str:
    """Per-stage p50 bars, scaled to the slowest stage."""
    summary = stage_summary(recorder)
    if not summary:
        return "(no stage traces recorded)"
    scale = max(s["p50_ms"] for s in summary.values()) or 1.0
    lines = [f"{'stage':<16} {'p50':>9} {'p95':>9} {'n':>5}"]
    for stage, s in sorted(summary.items(), key=lambda kv: -kv[1]["p50_ms"]):
        lines.append(
            f"{stage:<16} {s['p50_ms']:>7.2f}ms {s['p95_ms']:>7.2f}ms {int(s['count']):>5} "
            f"{_bar(s['p50_ms'] / scale, width)}"
        )
    return "\n".join(lines)


def render_waterfall(timings: Dict[str, float], width: int = 32) -> str:
    """Waterfall for one query's RetrievalResult.timings dict."""
    stages = [(k, v) for k, v in timings.items() if k != "total_ms"]
    if not stages:
        return "(no timings)"
    total = sum(v for _, v in stages) or 1.0
    lines = []
    offset = 0.0
    for name, ms in stages:
        pad = int(offset / total * width)
        lines.append(f"{name:<16} {ms:>8.2f}ms {' ' * pad}{_bar(ms / total, width)}")
        offset += ms
    lines.append(f"{'total':<16} {timings.get('total_ms', total):>8.2f}ms")
    return "\n".join(lines)

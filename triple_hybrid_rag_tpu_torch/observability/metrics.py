"""Thread-safe metrics registry with Prometheus text exposition.

The port of the JAX package's ``observability/metrics.py``: counters, gauges and
histograms (latency buckets 10 ms - 30 s) in one registry with idempotent getters,
labels as sorted key-value tuples, a timing context manager, and the module-level
``rag_metrics`` registry that the retriever and the ingestor count into. Standard
library only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

LabelKV = Tuple[Tuple[str, str], ...]

# latency bucket ladder: 10ms .. 30s
DEFAULT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
DEFAULT_MS_BUCKETS = tuple(b * 1000 for b in DEFAULT_BUCKETS)


def _labels_kv(labels: Optional[Dict[str, str]]) -> LabelKV:
    return tuple(sorted((labels or {}).items()))


def _esc(v: str) -> str:
    # Prometheus exposition escaping: an unescaped quote/backslash/newline in ONE
    # label value makes the scraper reject the WHOLE /metrics payload
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(kv: LabelKV) -> str:
    if not kv:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in kv) + "}"


class Counter:
    def __init__(self, name: str, help_: str = "") -> None:
        self.name, self.help = name, help_
        self._values: Dict[LabelKV, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        kv = _labels_kv(labels)
        with self._lock:
            self._values[kv] = self._values.get(kv, 0.0) + amount

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_kv(labels), 0.0)

    def series(self) -> Dict[LabelKV, float]:
        """A snapshot of every series: its sorted labels -> its value."""
        with self._lock:
            return dict(self._values)

    def expose(self) -> List[str]:
        lines = [f"# TYPE {self.name} counter"]
        with self._lock:  # scrapes race concurrent first-seen label inserts
            items = sorted(self._values.items())
        for kv, v in items:
            lines.append(f"{self.name}{_fmt_labels(kv)} {v}")
        if len(lines) == 1:
            lines.append(f"{self.name} 0")
        return lines


class Gauge:
    def __init__(self, name: str, help_: str = "") -> None:
        self.name, self.help = name, help_
        self._values: Dict[LabelKV, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_labels_kv(labels)] = value

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        kv = _labels_kv(labels)
        with self._lock:
            self._values[kv] = self._values.get(kv, 0.0) + amount

    def dec(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        self.inc(-amount, labels)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_kv(labels), 0.0)

    def expose(self) -> List[str]:
        lines = [f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for kv, v in items:
            lines.append(f"{self.name}{_fmt_labels(kv)} {v}")
        if len(lines) == 1:
            lines.append(f"{self.name} 0")
        return lines


class Histogram:
    def __init__(
        self, name: str, help_: str = "", buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> None:
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKV, List[int]] = {}
        self._sums: Dict[LabelKV, float] = {}
        self._totals: Dict[LabelKV, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        kv = _labels_kv(labels)
        with self._lock:
            counts = self._counts.setdefault(kv, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[kv] = self._sums.get(kv, 0.0) + value
            self._totals[kv] = self._totals.get(kv, 0) + 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return self._totals.get(_labels_kv(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._sums.get(_labels_kv(labels), 0.0)

    def expose(self) -> List[str]:
        lines = [f"# TYPE {self.name} histogram"]
        with self._lock:  # consistent snapshot: no torn bucket/sum/count triples
            snap = [
                (kv, list(self._counts[kv]), self._sums[kv], self._totals[kv])
                for kv in sorted(self._totals)
            ]
        for kv, counts, total_sum, total in snap:
            base = dict(kv)
            for i, b in enumerate(self.buckets):
                lbl = _fmt_labels(_labels_kv({**base, "le": str(b)}))
                lines.append(f"{self.name}_bucket{lbl} {counts[i]}")
            lbl_inf = _fmt_labels(_labels_kv({**base, "le": "+Inf"}))
            lines.append(f"{self.name}_bucket{lbl_inf} {total}")
            lines.append(f"{self.name}_sum{_fmt_labels(kv)} {total_sum}")
            lines.append(f"{self.name}_count{_fmt_labels(kv)} {total}")
        return lines


class _Timer:
    def __init__(self, hist: Histogram, labels: Optional[Dict[str, str]]) -> None:
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.perf_counter() - self._t0) * 1e3, self._labels)
        return False


class MetricsRegistry:
    """Named metric factory/registry (idempotent getters) + exposition."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._noop: Dict[type, object] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        if not self.enabled:
            # honor enabled=False with shared no-op instances (the flag was
            # previously stored and never consulted — collection still ran)
            m = self._noop.get(cls)
            if m is None:
                m = cls(name, help_, **kw)
                self._noop[cls] = m
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(
        self, name: str, help_: str = "", buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def time(self, name: str, labels: Optional[Dict[str, str]] = None) -> _Timer:
        """Context manager recording milliseconds into a histogram
        (the stage timers of a search or a rerank)."""
        return _Timer(self.histogram(name), labels)

    def prometheus_text(self) -> str:
        """Prometheus exposition format (what a /metrics endpoint serves)."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.expose())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# module-level registry the query and ingest paths count into
rag_metrics = MetricsRegistry()

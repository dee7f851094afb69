"""Readers over the program's own ranges: the idle device time of a traced window
that fell while the host was inside a range, whatever ranges were open around or
inside it."""

from __future__ import annotations

from typing import Optional

from .trace import TraceSummary


def idle_ms_per_unit(t: TraceSummary, name: str) -> Optional[float]:
    """Idle device ms a unit over the gaps whose label (the ranges open at the gap's
    midpoint, joined by ``>``) holds the range ``name``; None where no label holds
    it (a program without the range)."""
    hits = [s for label, s in t.idle_s if name in label.split(">")]
    if not hits or t.units == 0:
        return None
    return 1e3 * sum(hits) / t.units

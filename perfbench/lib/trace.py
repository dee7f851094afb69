"""What a traced window leaves for the per-layer readers: device time by engine
stage and by kernel, device busy and idle time, and the benchmark's own spans.

A stage's device time is the device's busy time inside the device-side intervals
of the stage's range (``engine.lexical`` ... ``engine.tail``): the profiler
records each range a second time on the device, from the first to the last
operation launched inside it. A kernel launched through ``ctypes`` is tied to no
range, so a hand-written kernel of the port that falls outside its stage's
intervals is added to that stage by name (``OWN_KERNELS``, a frozen copy of
``chip_smoke.py``'s ``stage_profile`` table, and in a cell whose model plug-ins
export their own, those too). The reduction reads the profiler's raw events: its
own device total of a range read the BM25 stage at a hundred times the device's
whole busy time, and building its event tree took minutes. Busy time is the union
of the device operations' intervals; idle gaps are labelled with the benchmark
span and engine range the host was inside when the device went idle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# substrings of the hand-written kernels' names, by the engine stage that launches them
OWN_KERNELS = {"engine.dense": ("bucket_max",), "engine.lexical": ("termtable_kernel",),
               "engine.tail": ("maxsim_kernel",)}
RANGE_PREFIXES = ("bench.", "engine.")


class Spans:
    """Host spans recorded from the benchmark's files: wall seconds by name, and a
    profiler range of the same name so the trace can label idle gaps."""

    def __init__(self, device_sync) -> None:
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.device_sync = device_sync  # waits for the device's queued work

    @contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the body; with ``sync`` the device is synchronized at both ends, so
        the span holds the body's device work and no one else's."""
        from torch.profiler import record_function

        if sync:
            self.device_sync()
        t0 = time.perf_counter()
        with record_function(name):
            yield
            if sync:
                self.device_sync()
        self.seconds[name].append(time.perf_counter() - t0)


@dataclass
class TraceSummary:
    """A traced window, reduced."""

    unit: str  # "batch" or "query"
    units: int  # units run in the traced window
    queries: int
    window_s: float
    busy_s: float
    device_ops: int  # device operations (kernels, copies, sets) in the window
    stage_s: Dict[str, float]  # engine stage -> device seconds in the window
    op_s: List[Tuple[str, float]]  # device operation name -> seconds, longest first
    idle_s: List[Tuple[str, float]]  # host label -> idle device seconds, longest first
    spans: Dict[str, List[float]] = field(default_factory=dict)
    work: Dict[str, object] = field(default_factory=dict)  # shapes for the work counts
    config: Dict[str, object] = field(default_factory=dict)  # the configuration file, as loaded
    # how much each counter series of the program's rag_metrics grew over the units
    counters: Dict[str, float] = field(default_factory=dict)
    op_n: Dict[str, int] = field(default_factory=dict)  # device operation name -> launches


def _interval_us(ev) -> Tuple[float, float]:
    """(start, end) of a raw profiler event, in microseconds."""
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() / 1e3
        return start, start + ev.duration_ns() / 1e3
    start = float(ev.start_us())
    return start, start + float(ev.duration_us())


def _union(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _overlap(ivs: List[Tuple[float, float]], s: float, t: float) -> float:
    """Length of [s, t] inside the sorted, disjoint intervals ``ivs``."""
    i = max(bisect.bisect_right(ivs, (s, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(ivs) and ivs[i][0] < t:
        total += max(0.0, min(t, ivs[i][1]) - max(s, ivs[i][0]))
        i += 1
    return total


def merge_kernels(*tables: Dict[str, Tuple[str, ...]]) -> Dict[str, Tuple[str, ...]]:
    """One table of hand-written kernels by stage from several (``OWN_KERNELS`` and
    those of a cell's model plug-ins): each stage's name parts, in order, once."""
    out: Dict[str, Tuple[str, ...]] = {}
    for table in tables:
        for stage, words in table.items():
            have = out.get(stage, ())
            out[stage] = have + tuple(w for w in words if w not in have)
    return out


def summarize(prof, unit: str, units: int, queries: int, window_s: float,
              spans: Dict[str, List[float]], work: dict, config: Optional[dict] = None,
              counters: Optional[Dict[str, float]] = None,
              own_kernels: Optional[Dict[str, Tuple[str, ...]]] = None) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` over ``units`` units; kernels
    are tied to stages by ``own_kernels`` (default ``OWN_KERNELS``)."""
    from torch.autograd import DeviceType

    own_kernels = OWN_KERNELS if own_kernels is None else own_kernels

    dev, host = [], []
    ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)  # device-side ranges
    own: Dict[str, List[Tuple[float, float]]] = defaultdict(list)  # hand-written kernels
    op_total: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for ev in prof.profiler.kineto_results.events():  # raw events: no event tree is built
        name = ev.name()
        on_device = ev.device_type() == DeviceType.CUDA
        if not on_device and not name.startswith(RANGE_PREFIXES):
            continue
        s, t = _interval_us(ev)
        if not on_device:
            host.append((s, t, name))
        elif name.startswith(RANGE_PREFIXES):
            ranges[name].append((s, t))
        else:
            dev.append((s, t))
            op_total[name] += (t - s) / 1e6
            op_n[name] += 1
            for stage, words in own_kernels.items():
                if any(w in name for w in words):
                    own[stage].append((s, t))
    op_s = sorted(op_total.items(), key=lambda x: -x[1])
    host.sort()
    dev.sort()
    busy, gaps, merged = 0.0, [], []
    cur_s = cur_e = None
    for s, t in dev:
        if cur_e is None:
            cur_s, cur_e = s, t
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            merged.append((cur_s, cur_e))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
        merged.append((cur_s, cur_e))
    stage_s = {}
    for stage, ivs in ranges.items():
        if not stage.startswith("engine."):
            continue
        ivs = _union(ivs)
        extra = sum(t - s for s, t in own.get(stage, ()) if _overlap(ivs, s, t) == 0.0)
        stage_s[stage] = (sum(_overlap(merged, s, t) for s, t in ivs) + extra) / 1e6
    # one sweep over range starts, gap midpoints and range ends in time order
    marks = [(s, 0, i) for i, (s, _, _) in enumerate(host)]
    marks += [(0.5 * (a + b), 1, i) for i, (a, b) in enumerate(gaps)]
    marks += [(t, 2, i) for i, (_, t, _) in enumerate(host)]
    marks.sort()
    active: Dict[int, None] = {}  # open ranges, in the order they opened
    idle: Dict[str, float] = defaultdict(float)
    for _, kind, i in marks:
        if kind == 0:
            active[i] = None
        elif kind == 2:
            active.pop(i, None)
        else:
            label = ">".join(host[j][2] for j in active) or "harness"
            idle[label] += (gaps[i][1] - gaps[i][0]) / 1e6
    return TraceSummary(
        unit=unit, units=units, queries=queries, window_s=window_s, busy_s=busy / 1e6,
        device_ops=len(dev), stage_s=stage_s, op_s=op_s,
        idle_s=sorted(idle.items(), key=lambda x: -x[1]), spans=dict(spans), work=work,
        config=dict(config or {}), counters=dict(counters or {}), op_n=dict(op_n),
    )


def breakdown(t: TraceSummary, top: int = 10, width: int = 160) -> dict:
    """The longest device operations by name (cut to ``width`` characters) and the
    idle device time by what the host was inside, in seconds over the window."""
    return {"device_ops": [[n[:width], s] for n, s in t.op_s[:top]],
            "idle_gaps": [[n[:width], s] for n, s in t.idle_s[:top]]}


def stage_ms_per_unit(t: TraceSummary, stage: str) -> Optional[float]:
    if not t.stage_s.get(stage) or t.units == 0:  # no device time read for the stage
        return None
    return 1e3 * t.stage_s[stage] / t.units


def kernel_ms_per_launch(t: TraceSummary, word: str) -> Optional[float]:
    """Device ms of one launch, on average, of the operations whose name holds
    ``word``; None where none ran."""
    n = sum(c for name, c in t.op_n.items() if word in name)
    s = sum(v for name, v in t.op_s if word in name)
    return 1e3 * s / n if n and s else None

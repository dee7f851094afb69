"""One run of one cell: inputs from the seed, the system placed over them, a warm-up
of the cell's own shapes, the measured window, the reduction of a traced window,
and the comparison with the plain reference that decides ``correct``.

The window is a closed loop: each unit (a batch, or one query) starts when the
last has returned, until ``seconds`` have passed since the first started. A rate
is the work of the whole window over its whole length; a tail is the tail of all
its units. With ``trace`` the first ``trace_units`` units run under
``torch.profiler`` with the benchmark's spans, and the rest of the window runs as
usual; the result then carries the per-layer metrics instead of the end-to-end
ones.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..reference import judge
from ..reference.pipeline import Reference
from . import trace as tr
from .cell import Cell
from .generator import build_corpus, make_texts
from .system import build_system, counters
from .work import percentile

FORBIDDEN = ("jax", "jaxlib", "flax", "triple_hybrid_rag_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_start() -> float:
    """The process's start as an epoch time (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end(name: str, w: dict) -> Optional[float]:
    """An end-to-end metric of a finished window."""
    if name == "queries_per_s":
        return w["queries"] / w["window_s"]
    if name == "batch_p95_ms" and w["unit"] == "batch":
        return 1e3 * percentile(w["latencies"], 95)
    if name == "query_p95_ms" and w["unit"] == "query":
        return 1e3 * percentile(w["latencies"], 95)
    if name == "peak_gb":
        return w["peak_bytes"] / 1e9
    if name == "setup_s":
        return w["setup_s"]
    return None


class Window:
    """The measured loop over a driver."""

    def __init__(self, driver, texts: List[str], reserve: int) -> None:
        self.driver = driver
        self.texts = texts
        self.limit = len(texts) - reserve  # the tail is the warm-up's
        self.next = 0
        self.latencies: List[float] = []
        self.done: List[object] = []  # the RetrievalResults of finished queries
        self.attempted = self.failed = 0

    def unit(self) -> None:
        w = self.driver.width
        if self.next + w > self.limit:
            log("the window used every text; texts repeat from here")
            self.next = 0
        batch = self.texts[self.next:self.next + w]
        self.next += w
        self.attempted += len(batch)
        t0 = time.perf_counter()
        try:
            res = self.driver.step(batch)
        except Exception:  # a failed unit counts as failed answers; the window goes on
            traceback.print_exc()
            self.failed += len(batch)
            res = None
        self.latencies.append(time.perf_counter() - t0)
        if res is not None:
            self.done += res


def pin_cores(count: int) -> None:
    """Keep this process (and the threads it starts from now on) on ``count`` fixed
    cores: the first of those it may use."""
    cores = sorted(os.sched_getaffinity(0))[:count]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))


def warm(driver, texts: List[str], units: int) -> None:
    """Run ``units`` units of ``texts`` (none of them the window's), so that the
    program's kernels are loaded and its host caches hold what the traffic asks
    for; log the units' median ms by fifths, which shows whether they settled."""
    w = driver.width
    times = []
    for i in range(units):
        t0 = time.perf_counter()
        driver.step(texts[i * w:(i + 1) * w])
        times.append(time.perf_counter() - t0)
    fifths = [times[i * units // 5:(i + 1) * units // 5] for i in range(5)]
    log("set-up: warm-up units' median ms by fifths: " + ", ".join(
        f"{1e3 * percentile(f, 50):.2f}" for f in fifths if f))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, fault: Optional[Callable] = None,
        variant: Optional[dict] = None, cores: Optional[int] = None) -> Tuple[dict, Dict[str, dict]]:
    """One run. Returns (the result line's object, the checks). ``fault``, given
    the driver, breaks the timed path underneath, and ``variant`` overrides the
    program's configuration (the lower-precision control); both serve the
    harness's own checks, never a benchmark run. With ``cores`` the process keeps
    to that many cores once the inputs are made."""
    t_start = process_start() if t_start is None else t_start
    on_gpu = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    t = time.time()
    corpus = build_corpus(cell.config["corpus"], seed, device)
    sync()
    log(f"set-up: inputs from seed {seed} in {time.time() - t:.2f} s ({corpus.n} chunks, {corpus.n_pad} rows)")
    t = time.time()
    texts, _ = make_texts(corpus, cell.traffic, seed)
    log(f"set-up: {len(texts)} query texts in {time.time() - t:.2f} s")
    if cores:
        pin_cores(cores)
    t = time.time()
    system = build_system(corpus, cell.config, device, variant, seed, cell.models)
    if system.config.embedding_dtype != "bfloat16":  # the program keeps its own rows
        corpus.rows, corpus.tokens = corpus.rows.cpu(), corpus.tokens.cpu()
    sync()
    log(f"set-up: the program placed its index in {time.time() - t:.2f} s "
        f"(device GB {({k: round(v / 1e9, 4) for k, v in system.state.nbytes().items() if v})})")
    t = time.time()
    driver = cell.driver.Driver(system, cell.traffic)
    row_dtype = system.config.embedding_dtype
    del system
    units = int(cell.traffic["warm_units"])
    reserve = (units + 1) * driver.width
    warm(driver, texts[-reserve:], units)
    if trace:  # the profiler's own start-up stays out of the traced window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            driver.step(texts[-driver.width:])
    if fault is not None:
        fault(driver)
    sync()
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    log(f"set-up: warm-up in {time.time() - t:.2f} s")

    win = Window(driver, texts, reserve)
    traced: Optional[tr.TraceSummary] = None
    gc0, cpu0 = [g["collections"] for g in gc.get_stats()], time.process_time()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    deadline = t0 + seconds
    if trace:
        from torch.profiler import ProfilerActivity, profile

        spans = tr.Spans(sync)
        n_units = int(cell.traffic["trace_units"])
        counted = counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with driver.traced(spans):
                tt = time.perf_counter()
                for _ in range(n_units):
                    win.unit()
                sync()
                traced_s = time.perf_counter() - tt
        traced_queries = len(win.done)
        counted = {k: v - counted.get(k, 0.0) for k, v in counters().items()}
    while time.perf_counter() < deadline:
        win.unit()
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    gc.unfreeze()
    if trace:
        work = {"rows": corpus.n_pad, "dim": int(corpus.rows.shape[1]), "batch": driver.width,
                "row_dtype": row_dtype}
        own = tr.merge_kernels(tr.OWN_KERNELS, *(getattr(m.program, "OWN_KERNELS", {})
                                                 for m in cell.models.values()))
        traced = tr.summarize(prof, cell.driver.UNIT, n_units, traced_queries, traced_s,
                              spans.seconds, work, config=cell.config, counters=counted,
                              own_kernels=own)
        log(f"trace: {n_units} units in {traced_s:.3f} s, device busy {traced.busy_s:.4f} s; "
            f"device s by stage {traced.stage_s}")
        del prof
    refused = sum(r.refused for r in win.done)
    log(f"window: {len(win.latencies)} units, {len(win.done)} answers in {window_s:.3f} s "
        f"({refused} refused); {win.failed} failed; host CPU "
        f"{time.process_time() - cpu0:.2f} s; collections by generation "
        f"{[g['collections'] - c for g, c in zip(gc.get_stats(), gc0)]}")
    quarters = [win.latencies[i * len(win.latencies) // 4:(i + 1) * len(win.latencies) // 4]
                for i in range(4)]
    log("window by quarter (units, median ms, p95 ms): " + "; ".join(
        f"{len(q)}, {1e3 * percentile(q, 50):.2f}, {1e3 * percentile(q, 95):.2f}" for q in quarters if q))

    # ---- correctness: a sample of the finished answers against the reference ----
    t = time.time()
    pick = judge.sample(len(win.done), int(cell.traffic["check_answers"]), seed)
    served = [judge.served(win.done[i]) for i in pick]
    texts_done = len(win.done)
    del driver, win.driver, win.done
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    ref = Reference(corpus, cell.config, device, seed, cell.models)
    answers = ref.answers([s.text for s in served], cell.driver.PATH)
    numbers = judge.judge(served, answers)
    limits = cell.config["limits"]
    checks = {k: {"value": numbers[k]["value"], "limit": float(v)} for k, v in limits.items()}
    for k in judge.NUMBERS:
        log(f"check detail: {k} {numbers[k]['value']!r} at {numbers[k]['at']!r}")
    log(f"reference: {len(served)} answers compared in {time.time() - t:.2f} s")
    correct = (win.failed == 0 and texts_done > 0 and len(served) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    w = {"unit": cell.driver.UNIT, "latencies": win.latencies, "queries": texts_done,
         "window_s": window_s, "peak_bytes": peak, "setup_s": setup_s}
    if trace:
        metrics = {}
        for name, (m, reader) in cell.per_layer.items():
            v = reader.read(traced)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {m["name"]: (end_to_end(m["name"], w), m["unit"]) for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": u} for k, (v, u) in values.items() if v is not None}
    dev = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    out = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = tr.breakdown(traced)
    out["checks"] = checks
    return out, checks


"""Device profiling hooks: a ``torch.profiler`` trace, named regions and a host
stage timer.

The port of the JAX package's ``observability/profiling.py``, with the same
interface over ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str | Path] = None) -> Iterator[Path]:
    """Trace the CPU and, where there is one, the CUDA device around a block and
    export a Chrome trace (viewable in Perfetto) into ``log_dir`` (default: a new
    temporary directory)::

        with device_trace("./trace") as d:
            engine.retrieve_batch(queries)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.mkdtemp(prefix="thr_profile-"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / f"trace-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Wall-clock stage timer mirroring RetrievalResult.timings aggregation for
    arbitrary host code paths."""

    def __init__(self) -> None:
        self.timings: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3

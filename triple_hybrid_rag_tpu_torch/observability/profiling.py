"""Device profiling hooks: a ``torch.profiler`` trace, named regions and a host
stage timer.

The port of the JAX package's ``observability/profiling.py``, with the same
interface over ``torch.profiler`` in place of ``jax.profiler``. The query paths
mark their stages with :func:`annotate` (the ``engine.*`` ranges), which costs a
flag read while no profiler records.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import ContextManager, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()  # reusable: entering it does nothing


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


def annotate(name: str) -> ContextManager[None]:
    """Named region inside a device trace (``torch.profiler.record_function``),
    entered only while a profiler records; otherwise a null context.

    The profiler records the range on the host and again on the device, from the
    first to the last device operation launched while it was the innermost range
    open."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class StageTimer:
    """Wall-clock stage timer mirroring RetrievalResult.timings aggregation for
    arbitrary host code paths."""

    def __init__(self) -> None:
        self.timings: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, span: Optional[str] = None) -> Iterator[None]:
        """Time the block into ``timings[f"{name}_ms"]`` (host milliseconds); with
        ``span`` the block is also the profiler range ``span`` (:func:`annotate`)."""
        with annotate(span) if span is not None else _OFF:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.timings[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3

"""Driver ``batch``: one caller in a closed loop, back-to-back batches of query texts
through ``Engine.retrieve_batch`` (host prep, one device program, the copy back,
the decode into ``RetrievalResult``s). A unit is one batch."""

from __future__ import annotations

from contextlib import contextmanager

UNIT = "batch"
PATH = "batch"  # the reference's entry semantics


class Driver:
    def __init__(self, system, traffic: dict) -> None:
        self.engine = system.engine()
        self.width = int(traffic["batch"])

    def step(self, texts):
        return self.engine.retrieve_batch(texts)

    @contextmanager
    def traced(self, spans):
        """Spans around each layer the window crosses: ``bench.prep`` around the
        engine's host prep (synchronized at its ends), ``bench.batch`` around the
        whole call."""
        prepare = self.engine.prepare_queries
        step = self.step

        def prep(*a, **k):
            with spans.span("bench.prep", sync=True):
                return prepare(*a, **k)

        def traced_step(texts):
            with spans.span("bench.batch"):
                return step(texts)

        self.engine.prepare_queries, self.step = prep, traced_step
        try:
            yield
        finally:
            del self.engine.prepare_queries
            self.step = step

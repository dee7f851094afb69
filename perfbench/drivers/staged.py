"""Driver ``staged``: one client in a closed loop, one query text at a time through
``Retriever.retrieve`` over ``Retriever.from_state`` on the placed state (the
path ``RAG.query`` takes with ``use_sharded_engine=False``). A unit is one query."""

from __future__ import annotations

from contextlib import contextmanager

UNIT = "query"
PATH = "staged"  # the reference's entry semantics
STAGES = ("_lexical_search", "_semantic_search", "_graph_search", "_expand_to_parents")


class Driver:
    def __init__(self, system, traffic: dict) -> None:
        self.retriever = system.retriever()
        self.width = 1

    def step(self, texts):
        return [self.retriever.retrieve(t) for t in texts]

    @contextmanager
    def traced(self, spans):
        """Spans ``bench.query`` around each call and ``bench.staged.<stage>`` around
        the planner, each channel, the expansion and the rerank; none synchronizes,
        so the path's own waits stay where it has them."""
        ret = self.retriever
        wrapped = []

        def wrap(obj, name, label):
            fn = getattr(obj, name)

            def inner(*a, **k):
                with spans.span(label):
                    return fn(*a, **k)

            setattr(obj, name, inner)
            wrapped.append((obj, name))

        wrap(ret.planner, "plan", "bench.staged.plan")
        for name in STAGES:
            wrap(ret, name, "bench.staged." + name.strip("_").split("_")[0])
        wrap(ret.reranker, "score", "bench.staged.rerank")
        step = self.step

        def traced_step(texts):
            out = []
            for t in texts:
                with spans.span("bench.query"):
                    out += step([t])
            return out

        self.step = traced_step
        try:
            yield
        finally:
            self.step = step
            for obj, name in wrapped:
                delattr(obj, name)

"""The port's profiler ranges: every stage of the staged query and of the batched
path opens its ``engine.*`` range under a profiler, nested as documented, and no
range is entered while no profiler records. ``StageTimer.stage`` keeps writing
``<name>_ms`` with or without a range."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.models.maxsim_reranker import MaxSimReranker
from triple_hybrid_rag_tpu_torch.observability import profiling
from triple_hybrid_rag_tpu_torch.retrieval import Retriever
from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, make_query_texts

# range -> the range it lies in
STAGED = {
    "engine.staged.plan": "engine.staged.query",
    "engine.staged.channels": "engine.staged.query",
    "engine.staged.lexical": "engine.staged.channels",
    "engine.staged.semantic": "engine.staged.channels",
    "engine.staged.embed": "engine.staged.semantic",
    "engine.staged.graph": "engine.staged.channels",
    "engine.staged.counts": "engine.staged.channels",
    "engine.staged.fusion": "engine.staged.query",
    "engine.staged.expand": "engine.staged.query",
    "engine.staged.rerank": "engine.staged.query",
    "engine.staged.tokens": "engine.staged.rerank",
    "engine.staged.maxsim": "engine.staged.rerank",
    "engine.staged.gate": "engine.staged.query",
    "engine.staged.decode": "engine.staged.query",
}
BATCH = {
    "engine.prep": "engine.batch",
    "engine.plan": "engine.prep",
    "engine.terms": "engine.prep",
    "engine.encode": "engine.prep",
    "engine.encode.vectors": "engine.encode",
    "engine.encode.tokens": "engine.encode",
    "engine.encode.weights": "engine.encode",
    "engine.seeds": "engine.prep",
    "engine.upload": "engine.prep",
    "engine.lexical": "engine.batch",
    "engine.dense": "engine.batch",
    "engine.graph": "engine.batch",
    "engine.tail": "engine.batch",
    "engine.fetch": "engine.batch",
    "engine.decode": "engine.batch",
}


@pytest.fixture(scope="module")
def corpus():
    n, dim, n_ent = 2048, 64, 200
    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=dim, embedding_dim_full=dim,
        maxsim_doc_tokens=16, maxsim_dim=32, maxsim_query_tokens=8,
        graph_max_entities_per_chunk=4, lexical_backend="sorted", bm25_df_cap=256,
        embedder_backend="bowhash",
    )
    syn = build_synthetic(cfg, n, dim, n_ent, seed=0, device="cpu")
    rows = np.array([0, 5, 10, 15])
    plain, _ = make_query_texts(rows[:2], syn.term_ids, np.random.default_rng(0), 0.0, n_ent)
    relation, _ = make_query_texts(rows[2:], syn.term_ids, np.random.default_rng(1), 1.0, n_ent)
    return syn, plain + relation


def _ranges(fn):
    """The host-side user ranges a call opens under a CPU profiler: [(name, start,
    end)], with the call's result."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return spans, out


def _check_tree(spans, tree, root):
    names = {n for n, _, _ in spans}
    assert all(n.startswith("engine.") for n in names), names
    assert set(tree) | {root} <= names, set(tree) - names
    for child, parent in tree.items():
        for _, s, t in (x for x in spans if x[0] == child):
            assert any(ps <= s and t <= pt for n, ps, pt in spans if n == parent), (child, parent)
    if root == "engine.staged.query":  # every staged stage lies inside the query's range
        for name, s, t in spans:
            assert any(ps <= s and t <= pt for n, ps, pt in spans if n == root), name


def test_staged_query_opens_every_range(corpus):
    syn, texts = corpus
    ret = Retriever.from_state(syn.state, embedder=syn.embedder)
    assert isinstance(ret.reranker, MaxSimReranker)
    spans, res = _ranges(lambda: [ret.retrieve(t) for t in texts])
    _check_tree(spans, STAGED, "engine.staged.query")
    assert sum(n == "engine.staged.query" for n, _, _ in spans) == len(texts)
    assert any(r.plan.requires_graph for r in res)


def test_staged_timings_keep_their_keys(corpus):
    syn, texts = corpus
    ret = Retriever.from_state(syn.state, embedder=syn.embedder)
    for traced in (False, True):
        if traced:
            _, res = _ranges(lambda: ret.retrieve(texts[0]))
        else:
            res = ret.retrieve(texts[0])
        assert list(res.timings) == ["planning_ms", "retrieval_ms", "fusion_ms", "expansion_ms",
                                     "rerank_ms", "safety_ms", "decode_ms", "total_ms"]
        assert res.timings["total_ms"] >= sum(v for k, v in res.timings.items() if k != "total_ms")


def test_batch_opens_every_range(corpus):
    syn, texts = corpus
    eng = Engine(syn.state, embedder=syn.embedder, device="cpu")
    spans, res = _ranges(lambda: eng.retrieve_batch(texts))
    _check_tree(spans, BATCH, "engine.batch")
    assert len(res) == len(texts)


def test_ranges_change_no_answer(corpus):
    syn, texts = corpus
    ret = Retriever.from_state(syn.state, embedder=syn.embedder)
    eng = Engine(syn.state, embedder=syn.embedder, device="cpu")
    for run in (lambda: [ret.retrieve(t) for t in texts], lambda: eng.retrieve_batch(texts)):
        plain = run()
        _, traced = _ranges(run)
        for a, b in zip(plain, traced):
            assert [r.chunk_id for r in a.results] == [r.chunk_id for r in b.results]
            assert [r.final_score for r in a.results] == [r.final_score for r in b.results]
            assert a.refused == b.refused


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def test_annotate_enters_no_range_without_a_profiler(corpus, monkeypatch):
    syn, texts = corpus
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    ret = Retriever.from_state(syn.state, embedder=syn.embedder)
    eng = Engine(syn.state, embedder=syn.embedder, device="cpu")
    with profiling.annotate("engine.x"):
        pass
    ret.retrieve(texts[2])
    eng.retrieve_batch(texts)
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("engine.x"):
            pass
        ret.retrieve(texts[2])
    assert _Counting.entered == 1 + 1 + len(STAGED)


@pytest.mark.parametrize("span", [None, "engine.x"])
def test_stage_timer_writes_ms(span):
    timer = profiling.StageTimer()
    with timer.stage("planning", span=span):
        pass
    with timer.stage("rerank"):
        pass
    assert list(timer.timings) == ["planning_ms", "rerank_ms"]
    assert all(v >= 0.0 for v in timer.timings.values())

    def fusion():
        with timer.stage("fusion", span=span):
            pass

    spans, _ = _ranges(fusion)
    assert [n for n, _, _ in spans] == ([] if span is None else [span])
    assert list(timer.timings)[-1] == "fusion_ms"

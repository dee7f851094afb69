"""The port's quality evaluation (``eval.py``, the harvest, ``thr-torch eval``)
against the JAX reference's, on the CPU.

Same inputs through both packages: the metrics functions give equal values; the
labeled corpora (``make_eval_corpus``, the docstring cloze corpora, the
code-structure graph corpus) equal chunk ids, texts, entities, queries and relevant
sets; the docstring harvests equal documents. Run through both packages' staged
retrievers (and batched engines), each query's ranked chunk ids must be equal; a
slot may differ only where its final score lies within ``NEAR_TIE`` (1e-5, the f32
sums of the dense and MaxSim products in another order) of a neighbour's, and the
metrics must then be equal within ``METRIC_ATOL`` (1e-12: means of the same
per-query values). The BowHash embedder and small widths keep each run to seconds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from triple_hybrid_rag_tpu import eval as ref_eval
from triple_hybrid_rag_tpu.config import RAGConfig
from triple_hybrid_rag_tpu.models import pretrain as ref_pretrain
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh
from triple_hybrid_rag_tpu.retrieval import Retriever as RefRetriever

from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch import eval as port_eval
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.models import pretrain as port_pretrain
from triple_hybrid_rag_tpu_torch.retrieval import Retriever

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "triple_hybrid_rag_tpu")
NEAR_TIE = 1e-5
METRIC_ATOL = 1e-12
BASE = dict(
    capacity_round=64, embedding_dim=64, embedding_dim_full=128, embedding_dtype="float32",
    safety_threshold=0.0, final_top_k=10, rerank_top_k=20, denoise_alpha=0.0,
    embedder_backend="bowhash",
)


def same_ranking(want, got):
    """Equal ranked chunk ids per query, up to near ties (see the module docstring)."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.query == b.query and a.refused == b.refused, a.query
        ids_a = [r.chunk_id for r in a.results]
        ids_b = [r.chunk_id for r in b.results]
        assert len(ids_a) == len(ids_b), a.query
        s = np.array([r.final_score for r in a.results])
        np.testing.assert_allclose([r.final_score for r in b.results], s, atol=NEAR_TIE, rtol=0)
        for i, (x, y) in enumerate(zip(ids_a, ids_b)):
            if x != y:
                gaps = [abs(s[i] - s[j]) for j in (i - 1, i + 1) if 0 <= j < len(s)]
                assert min(gaps) <= NEAR_TIE, (a.query, i, x, y)


def same_metrics(want, got):
    assert want.keys() == got.keys()
    for name in want:
        assert want[name].keys() == got[name].keys(), name
        for key, v in want[name].items():
            assert got[name][key] == pytest.approx(v, abs=METRIC_ATOL), (name, key)


def recording_evaluate(monkeypatch, results):
    """Make the reference's ``evaluate`` append each query's result to
    ``results[config]``, the configs named in the order its callers evaluate them."""
    orig = ref_eval.evaluate
    names = iter(results)

    def evaluate(fn, queries, k=10):
        out = results[next(names)]
        return orig(lambda q: out.append(fn(q)) or out[-1], queries, k=k)

    monkeypatch.setattr(ref_eval, "evaluate", evaluate)


def same_corpus(want, got):
    assert [c.chunk_id for c in want.corpus.children] == [c.chunk_id for c in got.corpus.children]
    assert [c.text for c in want.corpus.children] == [c.text for c in got.corpus.children]
    assert [p.parent_id for p in want.corpus.parents] == [p.parent_id for p in got.corpus.parents]
    assert [(q.text, q.relevant_chunk_ids, q.kind) for q in want.queries] == [
        (q.text, q.relevant_chunk_ids, q.kind) for q in got.queries]
    ents = lambda d: sorted(  # noqa: E731
        (e.entity_id, e.canonical_name, e.entity_type.value) for e in d.entity_store.entities.values()
    )
    assert ents(want) == ents(got)
    mentions = lambda d: sorted((m.entity_id, m.chunk_id) for m in d.entity_store.mentions)  # noqa: E731
    assert mentions(want) == mentions(got)
    rels = lambda d: sorted(  # noqa: E731
        (r.subject_id, r.relation_type.value, r.object_id) for r in d.entity_store.relations
    )
    assert rels(want) == rels(got)
    assert want.extraction_metrics == got.extraction_metrics


# ------------------------------------------------------------------ metrics and corpora


def test_metrics_functions_equal():
    rng = np.random.default_rng(0)
    ids = [f"c{i}" for i in range(30)]
    for _ in range(200):
        ranked = list(rng.choice(ids, size=rng.integers(0, 15), replace=False))
        relevant = set(rng.choice(ids, size=rng.integers(0, 6), replace=False))
        k = int(rng.integers(1, 12))
        assert port_eval.recall_at_k(ranked, relevant, k) == ref_eval.recall_at_k(ranked, relevant, k)
        assert port_eval.ndcg_at_k(ranked, relevant, k) == ref_eval.ndcg_at_k(ranked, relevant, k)
        assert port_eval.mrr(ranked, relevant) == ref_eval.mrr(ranked, relevant)


@pytest.mark.parametrize("hard_negatives", [0, 3])
def test_make_eval_corpus_equal(hard_negatives):
    cfg = RAGConfig(**BASE)
    same_corpus(ref_eval.make_eval_corpus(cfg, hard_negatives=hard_negatives),
                port_eval.make_eval_corpus(torch_config(cfg), hard_negatives=hard_negatives))


def test_baseline_configs_equal(monkeypatch):
    want_res = {n: [] for n in ("1_lexical_only", "2_dense_only", "3_dual_hybrid_rrf",
                                "4_triple_hybrid", "5_full_pipeline")}
    recording_evaluate(monkeypatch, want_res)
    cfg = RAGConfig(**BASE)
    want = ref_eval.evaluate_baseline_configs(cfg, k=10, distractors=5, hard_negatives=1)
    got_res = {}
    got = port_eval.evaluate_baseline_configs(
        torch_config(cfg), k=10, distractors=5, hard_negatives=1, device="cpu", results=got_res)
    assert list(got_res) == list(want_res)
    for name in want_res:
        same_ranking(want_res[name], got_res[name])
    same_metrics(want, got)
    assert got["5_full_pipeline"]["recall@10"] > 0.3


def test_evaluate_batched_equal():
    """``evaluate_batched`` over the port's ``Engine`` against the reference's over
    ``ShardedEngine`` (one device), and both against the staged ``evaluate``."""
    cfg = RAGConfig(**dict(BASE, embedding_dim=32, embedding_dim_full=64))
    data = ref_eval.make_eval_corpus(cfg, docs_per_topic=2, distractors=10)
    queries = data.queries[:15]
    ret = RefRetriever(data.corpus, cfg, graph_index=ref_eval.build_graph_index(
        data.entity_store, data.corpus, cfg))
    eng = ShardedEngine(ret, single_device_mesh())
    want = ref_eval.evaluate_batched(eng, queries, k=10, batch_size=8)
    want_res = [r for lo in range(0, len(queries), 8)
                for r in eng.retrieve_batch([q.text for q in queries[lo:lo + 8]], top_k=10)]

    tcfg = torch_config(cfg)
    pdata = port_eval.make_eval_corpus(tcfg, docs_per_topic=2, distractors=10)
    pret = Retriever(pdata.corpus, tcfg, graph_index=port_eval.build_graph_index(
        pdata.entity_store, pdata.corpus, tcfg), device="cpu")
    got_res = []
    got = port_eval.evaluate_batched(Engine.from_retriever(pret), pdata.queries[:15], k=10,
                                     batch_size=8, results=got_res)
    same_ranking(want_res, got_res)
    same_metrics({"b": want}, {"b": got})
    staged = port_eval.evaluate(lambda q: pret.retrieve(q, top_k=10), pdata.queries[:15], k=10)
    for key in ("recall@10", "ndcg@10"):
        assert got[key] == pytest.approx(staged[key], abs=1e-9)


# ------------------------------------------------------------------ harvest


@pytest.mark.parametrize("sources,max_docs", [(("stdlib",), 25), (("einops",), 12),
                                              (("chex",), 12), (("einops", "stdlib"), 20)])
def test_stdlib_documents_equal(sources, max_docs):
    want = ref_eval._stdlib_documents(max_docs=max_docs, sources=sources)
    assert want
    assert port_eval._stdlib_documents(max_docs=max_docs, sources=sources) == want


def test_jax_family_harvest_leaves_jax_out():
    """Harvesting ``chex`` (a JAX package) loads none of JAX into the port's process."""
    code = (
        "import json, sys\n"
        "from triple_hybrid_rag_tpu_torch.eval import _stdlib_documents\n"
        "docs = _stdlib_documents(max_docs=8, sources=('chex',))\n"
        f"bad = [n for n in sys.modules if n.split('.')[0] in {FORBIDDEN + ('chex',)!r}]\n"
        "print(json.dumps([len(docs), bad]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [8, []]


def test_ast_documents_equal():
    want_cls, got_cls = {}, {}
    want = ref_eval._ast_documents(include_top=("einops",), collect_classes=want_cls)
    got = port_eval._ast_documents(include_top=("einops",), collect_classes=got_cls)
    assert want and got == want and got_cls == want_cls
    excl = {t for _, t in want[:5]}
    assert port_eval._ast_documents(include_top=("einops",), exclude_texts=excl) == \
        ref_eval._ast_documents(include_top=("einops",), exclude_texts=excl)


def test_realtext_documents_equal():
    assert port_pretrain.TRAIN_TEXT_SOURCES == ref_pretrain.TRAIN_TEXT_SOURCES
    assert port_pretrain.TRAIN_TEXT_SOURCES_DEEP == ref_pretrain.TRAIN_TEXT_SOURCES_DEEP
    want = ref_pretrain.realtext_documents(max_docs=15, sources=("toolz",))
    assert want and port_pretrain.realtext_documents(max_docs=15, sources=("toolz",)) == want
    assert port_pretrain.realtext_documents_deep(max_docs=15, sources=("toolz",)) == \
        ref_pretrain.realtext_documents_deep(max_docs=15, sources=("toolz",))


# ------------------------------------------------------------------ independent corpora


def test_stdlib_eval_equal(monkeypatch):
    cfg = RAGConfig(**dict(BASE, graph_enabled=False))
    same_corpus(ref_eval.make_stdlib_eval(cfg, n_docs=30, n_queries=12, seed=3),
                port_eval.make_stdlib_eval(torch_config(cfg), n_docs=30, n_queries=12, seed=3))
    want_res = {n: [] for n in ("lexical_only", "dense_only", "hybrid_rrf", "full_pipeline")}
    recording_evaluate(monkeypatch, want_res)
    want = ref_eval.evaluate_stdlib(cfg, n_docs=30, n_queries=12, seed=3)
    got_res = {}
    got = port_eval.evaluate_stdlib(torch_config(cfg), n_docs=30, n_queries=12, seed=3,
                                    device="cpu", results=got_res)
    for name in want_res:
        same_ranking(want_res[name], got_res[name])
    same_metrics(want, got)


@pytest.mark.parametrize("graph_source", ["oracle", "extracted"])
def test_code_graph_eval_equal(monkeypatch, graph_source):
    cfg = RAGConfig(**dict(BASE, graph_enabled=True))
    kw = dict(n_modules=10, n_graph_queries=8, n_cloze_queries=6, seed=1,
              graph_source=graph_source, include_api_docs=graph_source == "extracted")
    want_data = ref_eval.make_code_graph_eval(cfg, **kw)
    got_data = port_eval.make_code_graph_eval(torch_config(cfg), **kw)
    assert [q.kind for q in got_data.queries].count("graph") > 0
    same_corpus(want_data, got_data)
    want_res = {n: [] for n in ("graph_off", "graph_on", "graph_only")}
    recording_evaluate(monkeypatch, want_res)
    want = ref_eval.evaluate_code_graph(cfg, **kw)
    got_res = {}
    got = port_eval.evaluate_code_graph(torch_config(cfg), **kw, device="cpu", results=got_res)
    for name in want_res:
        same_ranking(want_res[name], got_res[name])
    same_metrics(want, got)


def test_bigcorpus_eval_equal():
    """The corpus-scale cloze and graph corpora at a few dozen documents, the
    training-content exclusion on (its harvest cut to one package)."""
    cfg = RAGConfig(**dict(BASE, graph_enabled=True))
    for mod in (ref_pretrain, port_pretrain):  # the exclusion harvest's cache, by argument set
        mod._REALTEXT_CACHE[(100000, tuple(mod.TRAIN_TEXT_SOURCES))] = \
            mod.realtext_documents(max_docs=30, sources=("toolz",))
        mod._REALTEXT_CACHE[("deep", 200000, tuple(mod.TRAIN_TEXT_SOURCES_DEEP), 300)] = \
            mod.realtext_documents_deep(max_docs=30, sources=("toolz",))
    try:
        same_corpus(ref_eval.make_bigcorpus_eval(cfg, n_docs=40, n_queries=10),
                    port_eval.make_bigcorpus_eval(torch_config(cfg), n_docs=40, n_queries=10))
        want = ref_eval.make_bigcorpus_graph_eval(cfg, n_docs=40, n_queries=10, n_graph_queries=8)
        got = port_eval.make_bigcorpus_graph_eval(
            torch_config(cfg), n_docs=40, n_queries=10, n_graph_queries=8)
        for m in (want, got):
            m.extraction_metrics.pop("extract_s"), m.extraction_metrics.pop("link_s")
        same_corpus(want, got)
    finally:
        for mod in (ref_pretrain, port_pretrain):
            mod._REALTEXT_CACHE.clear()


# ------------------------------------------------------------------ CLI


def test_cli_eval_without_jax(tmp_path):
    """``thr-torch eval --device cpu --json`` in a process where importing JAX or
    the JAX package fails: the five configurations (the default RAGConfig, the
    packaged encoder) with tests/test_eval.py's gates. The process runs on one CPU
    thread, so that it does not contend with the other test workers; its metrics
    against the in-process call are held equal on the card (``chip_smoke.py``
    10(i))."""
    poison = tmp_path / "poison"
    for name in FORBIDDEN:
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{poison}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "triple_hybrid_rag_tpu_torch", "eval", "--device", "cpu", "--json",
         "--distractors", "2"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert list(got) == ["1_lexical_only", "2_dense_only", "3_dual_hybrid_rrf", "4_triple_hybrid",
                         "5_full_pipeline"]
    r = {name: m["recall@10"] for name, m in got.items()}
    assert all(m["n_queries"] == 20.0 for m in got.values())
    assert min(r["1_lexical_only"], r["3_dual_hybrid_rrf"], r["5_full_pipeline"]) > 0.3
    assert r["3_dual_hybrid_rrf"] >= min(r["1_lexical_only"], r["2_dense_only"]) - 1e-6

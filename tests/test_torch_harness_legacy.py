"""The port's tool harness, RAG 1.0 searcher and the index methods they stand on,
against the JAX reference's, on the CPU.

- The harness: the scenarios of ``tests/test_harness.py`` and
  ``default_scenarios()`` over the same small RAG in both packages give the same
  outcomes (pass/fail and failure reasons per scenario).
- The legacy path: ``FlatChunker`` gives equal chunks; ``HybridSearcher`` over the
  corpus of ``tests/test_tools_legacy.py`` gives equal chunk ids and channels, RRF
  scores within ``RRF_ATOL`` (1e-6) and per-channel scores within ``SCORE_ATOL``.
- ``BM25Index.encode_query`` / ``encode_query_tiered`` equal; ``score`` over the
  CSR bit for bit and over the term table within ``SCORE_ATOL`` (1e-5: sums of up
  to 16 weights in another slot order); ``search`` / ``search_sorted`` equal ids and
  scores within ``SCORE_ATOL``; ``DenseIndex.score`` / ``search`` for f32, bf16,
  int8 and int4 rows within ``SCORE_ATOL`` with equal ids up to near ties.
"""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.corpus import CorpusStore as RefCorpusStore
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.harness import HarnessRunner as RefHarnessRunner
from triple_hybrid_rag_tpu.harness import default_scenarios as ref_default_scenarios
from triple_hybrid_rag_tpu.index.bm25_index import build_bm25_index as ref_build_bm25
from triple_hybrid_rag_tpu.index.dense_index import build_dense_index as ref_build_dense
from triple_hybrid_rag_tpu.legacy import FlatChunker as RefFlatChunker
from triple_hybrid_rag_tpu.legacy import HybridSearcher as RefHybridSearcher
from triple_hybrid_rag_tpu.legacy import LegacySearchConfig as RefLegacySearchConfig
from triple_hybrid_rag_tpu.tools import make_knowledge_tools as ref_tools

from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.corpus import CorpusStore
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.harness import (
    HarnessRunner,
    Scenario,
    default_scenarios,
    expect_refusal,
    expect_sources,
    expect_success,
    expect_text_contains,
)
from triple_hybrid_rag_tpu_torch.index.bm25_index import build_bm25_index
from triple_hybrid_rag_tpu_torch.index.dense_index import build_dense_index
from triple_hybrid_rag_tpu_torch.legacy import FlatChunker, HybridSearcher, LegacySearchConfig
from triple_hybrid_rag_tpu_torch.tools import make_knowledge_tools

RRF_ATOL = 1e-6
SCORE_ATOL = 1e-5
NEAR_TIE = 1e-5


# ------------------------------------------------------------------ harness


@pytest.fixture
def registries(small_config):
    cfg = small_config.replace(
        graph_enabled=True, embedding_dtype="float32", safety_threshold=0.6,
        rerank_backend="maxsim",
    )
    out = []
    for rag in (RefRAG(config=cfg), RAG(config=torch_config(cfg), device="cpu")):
        rag.ingest_text(
            "Acme Corp settles invoices within thirty days. Maria Silva works for Acme Corp.",
            name="pay.md",
        )
        out.append(rag)
    return ref_tools(out[0]), make_knowledge_tools(out[1])


def _scenarios(expect):
    """The scenarios of tests/test_harness.py, with either package's validators."""
    success, sources, contains, refusal = expect
    return [
        Scenario("hit", "search_knowledge_base", {"query": "invoice settlement days"},
                 [success, sources(1), contains("invoices")]),
        Scenario("refusal", "search_knowledge_base", {"query": "qqq zzz gibberish"}, [refusal]),
        Scenario("entity", "lookup_entity", {"name": "Acme Corp"}, [success]),
        Scenario("wrong_expectation", "search_knowledge_base",
                 {"query": "invoice settlement days"}, [refusal]),
        Scenario("nope", "no_such_tool", {}, [success]),
    ]


def _outcomes(summary):
    return (summary["total"], summary["passed"], summary["failed"],
            [(r["scenario"], r["tool"], r["ok"], r["failures"]) for r in summary["results"]])


def test_harness_scenarios_match_reference(registries):
    from triple_hybrid_rag_tpu import harness as ref_harness

    ref_reg, reg = registries
    ref_sc = [ref_harness.Scenario(s.name, s.tool, s.args, s.validators) for s in _scenarios((
        ref_harness.expect_success, ref_harness.expect_sources,
        ref_harness.expect_text_contains, ref_harness.expect_refusal))]
    want = RefHarnessRunner(ref_reg).run(ref_sc)
    got = HarnessRunner(reg).run(_scenarios(
        (expect_success, expect_sources, expect_text_contains, expect_refusal)))
    assert _outcomes(got) == _outcomes(want)
    assert got["passed"] == 3 and got["failed"] == 2  # the reference test's outcomes
    assert all(r["duration_ms"] >= 0 for r in got["results"])


def test_default_scenarios_match_reference(registries):
    ref_reg, reg = registries
    want = RefHarnessRunner(ref_reg).run(ref_default_scenarios())
    got = HarnessRunner(reg).run(default_scenarios())
    assert _outcomes(got) == _outcomes(want)
    assert got["passed"] == got["total"] == 4


# ------------------------------------------------------------------ legacy path


def test_flat_chunker_equal():
    texts = [
        "Sentence one here. " * 200,
        "# Title\n\nIntro text.\n\n| a | b |\n|---|---|\n| 1 | 2 |\n\nMore prose after. " * 20,
        "short",
    ]
    for text in texts:
        doc_id = hashlib.sha256(text.encode()).hexdigest()
        want = RefFlatChunker().chunk_document(text, doc_id)
        got = FlatChunker().chunk_document(text, doc_id)
        fields = lambda chunks: [dataclasses.asdict(x) for x in chunks]  # noqa: E731
        assert fields(got[0]) == fields(want[0]) and fields(got[1]) == fields(want[1])
    assert len(FlatChunker().chunk_document(texts[0], "a" * 64)[1]) > 1


LEGACY_DOCS = {
    "a": "payment invoice settlement billing quarterly penalty terms",
    "b": "forest foxes wildlife habitat bears hibernation winter",
    "c": "password security portal authentication rotation access",
}
LEGACY_QUERIES = ["invoice payment", "bears in the forest", "rotate the password", "zzz qqq",
                  "billing access winter"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_hybrid_searcher_matches_reference(small_config, dtype):
    cfg = small_config.replace(graph_enabled=True, embedding_dtype=dtype, safety_threshold=0.2)
    stores = (RefCorpusStore(), CorpusStore())
    for store, chunker in zip(stores, (RefFlatChunker(), FlatChunker())):
        for name, text in LEGACY_DOCS.items():
            p, c = chunker.chunk_document(text * 3, hashlib.sha256(name.encode()).hexdigest())
            store.add_chunks(p, c)
    for top_k in (2, 5):
        ref = RefHybridSearcher(stores[0], cfg, RefLegacySearchConfig(top_k=top_k))
        port = HybridSearcher(stores[1], torch_config(cfg), LegacySearchConfig(top_k=top_k),
                              device="cpu")
        for q in LEGACY_QUERIES:
            want, got = ref.search_query(q), port.search_query(q)
            assert [r.chunk_id for r in got] == [r.chunk_id for r in want], q
            assert [r.source_channels for r in got] == [r.source_channels for r in want], q
            for field, atol in (("rrf_score", RRF_ATOL), ("final_score", RRF_ATOL),
                                ("lexical_score", SCORE_ATOL), ("semantic_score", SCORE_ATOL)):
                np.testing.assert_allclose([getattr(r, field) for r in got],
                                           [getattr(r, field) for r in want], atol=atol, rtol=0,
                                           err_msg=f"{field} of {q!r}")
    assert "invoice" in port.search_query("invoice payment")[0].text


# ------------------------------------------------------------------ index methods


def _words_corpus(n_docs, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    return words, [" ".join(rng.choice(words, size=rng.integers(3, 40))) for _ in range(n_docs)]


@pytest.mark.parametrize("n_docs,backends", [
    (300, ("postings", "termtable", "sorted", "auto")),
    (4100, ("auto",)),  # the "auto" rule's other side: term table and sorted search
])
def test_bm25_index_methods_match_reference(small_config, n_docs, backends):
    words, texts = _words_corpus(n_docs)
    cfg = small_config.replace(max_query_terms=16, capacity_round=64, bm25_df_cap=64,
                               use_native=False)
    rng = np.random.default_rng(1)
    mask = np.arange(cfg.round_capacity(n_docs)) % 3 != 0
    for backend in backends:
        c = cfg.replace(lexical_backend=backend)
        ref, port = ref_build_bm25(texts, c), build_bm25_index(texts, torch_config(c))
        for trial in range(6):
            kws = list(rng.choice(words, size=rng.integers(1, 20))) + ["unknownword"]
            qt = ref.encode_query(kws)
            np.testing.assert_array_equal(port.encode_query(kws), qt)
            for a, b in zip(port.encode_query_tiered(kws), ref.encode_query_tiered(kws)):
                np.testing.assert_array_equal(a, b)
            for sb in ("postings", "termtable", None if backend != "sorted" else "auto"):
                want = np.asarray(ref.score(jnp.asarray(qt), backend=sb))
                got = port.score(qt, backend=sb, device="cpu").numpy()
                eff = sb or backend
                if eff == "auto":
                    eff = "termtable" if n_docs >= 4096 else "postings"
                if eff == "postings":  # the CSR scan: the reference's bits
                    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
                np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
            row_mask = None if trial % 2 else mask
            want_ids, want_vals = ref.search(kws, 10, None if row_mask is None else jnp.asarray(row_mask))
            got_ids, got_vals = port.search(
                kws, 10, None if row_mask is None else torch.from_numpy(row_mask), device="cpu")
            np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
            np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals), atol=SCORE_ATOL)
            want_ids, want_vals = ref.search_sorted(jnp.asarray(qt), 7)
            got_ids, got_vals = port.search_sorted(torch.from_numpy(qt), 7)
            np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
            np.testing.assert_array_equal(got_vals.numpy().view(np.int32),
                                          np.asarray(want_vals).view(np.int32))
    with pytest.raises(ValueError):
        port.score(qt, backend="nonsense", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_dense_index_methods_match_reference(small_config, dtype):
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((45, small_config.embedding_dim_full)).astype(np.float32)
    cfg = small_config.replace(embedding_dtype=dtype, capacity_round=16, semantic_top_k=12)
    ref = ref_build_dense(vecs, cfg)
    port = build_dense_index(vecs, torch_config(cfg), device="cpu")
    assert port.is_int4 == ref.is_int4 == (dtype == "int4")
    mask = np.arange(ref.n_pad) % 4 != 1
    for trial in range(8):
        q = rng.standard_normal(cfg.embedding_dim).astype(np.float32)
        q /= np.linalg.norm(q)
        want = np.asarray(ref.score(jnp.asarray(q)))
        np.testing.assert_allclose(port.score(q).numpy(), want, atol=SCORE_ATOL, rtol=0)
        row_mask = None if trial % 2 else mask
        want_ids, want_vals = ref.search(q, None, None if row_mask is None else jnp.asarray(row_mask))
        got_ids, got_vals = port.search(
            torch.from_numpy(q), None, None if row_mask is None else torch.from_numpy(row_mask))
        want_vals = np.asarray(want_vals)
        np.testing.assert_allclose(got_vals.numpy(), want_vals, atol=SCORE_ATOL, rtol=0)
        diff = got_ids.numpy() != np.asarray(want_ids)
        for i in np.flatnonzero(diff):  # only near ties may swap
            gaps = [abs(want_vals[i] - want_vals[j]) for j in (i - 1, i + 1) if 0 <= j < len(want_vals)]
            assert min(gaps) <= NEAR_TIE

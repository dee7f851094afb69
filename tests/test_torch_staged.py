"""The port's staged single-query path against the JAX reference's, on the CPU.

Both facades ingest the same texts and answer through ``RAG.query`` with the
default ``use_sharded_engine=False``: the reference's ``Retriever.retrieve`` and
the port's, six stages each. Every configuration must give equal final chunk ids,
refusals, refusal reasons, channel counts and ``timings`` keys; final, fused and
per-channel scores agree within 1e-5 (f32 sums of the dense and MaxSim products
run in another order), the lexical scores of the CSR backends bit for bit, the
term-table's within 1e-5. Per module: the term-at-a-time BM25 scan and the sorted
channel bit-equal, the k-hop chunk scores equal, and the MaxSim candidate scores
within 1e-5 of both the reference's einsum and its Pallas kernel in interpret
mode. The metrics counters a query moves are the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.index.bm25_index import build_bm25_index as ref_build_bm25
from triple_hybrid_rag_tpu.index.maxsim_index import MaxSimIndex as RefMaxSimIndex
from triple_hybrid_rag_tpu.observability import rag_metrics as ref_metrics
from triple_hybrid_rag_tpu.ops.graph import khop_chunk_scores as ref_khop_chunk_scores
from triple_hybrid_rag_tpu.retrieval import retrieve as ref_retrieve

from test_torch_facade import DOCS
from torch_port_helpers import state_from_retriever, torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.index import bm25_index as port_bm25
from triple_hybrid_rag_tpu_torch.index.maxsim_index import MaxSimIndex
from triple_hybrid_rag_tpu_torch.index.state import IndexState
from triple_hybrid_rag_tpu_torch.observability import rag_metrics
from triple_hybrid_rag_tpu_torch.ops.bm25 import score_postings_pre
from triple_hybrid_rag_tpu_torch.ops.graph import khop_chunk_scores
from triple_hybrid_rag_tpu_torch.retrieval import retrieve

ATOL = 1e-5
QUERIES = [
    "invoice payment settlement",
    "How do I reset my password?",
    "Who works for Acme Corp?",
    "contract termination notice",
    "fox habitat in the forest",
    "Globex Recife depots",
    "How is Acme Corp related to Globex Inc?",  # relational: the 0.8 rerank blend
    "link between acme corp and globex",  # relational, keyword-seeded graph
    "the of and",  # stopwords only: no keywords, and the embedder raises
]
COUNTERS = ("retrieval_queries_total", "retrieval_refusals_total", "semantic_channel_failures_total")


@pytest.fixture
def cfg(small_config):
    # short chunks, so each document yields several children and two parents
    return small_config.replace(
        safety_threshold=0.2, capacity_round=8, use_native=False, child_chunk_tokens=40,
        child_chunk_overlap_tokens=10, parent_chunk_tokens=120, parent_chunk_min_tokens=80,
    )


def _pair(cfg, rerank_fn=None):
    ref = RefRAG(cfg, rerank_fn=rerank_fn)
    port = RAG(torch_config(cfg), device="cpu", rerank_fn=rerank_fn)
    for i, text in enumerate(DOCS[:6]):
        for r in (ref, port):
            r.ingest_text(text, name=f"d{i}.md", collection="ab"[i % 2])
    return ref, port


def _compare(ref, got, lexical_atol=None):
    assert [x.chunk_id for x in ref.results] == [x.chunk_id for x in got.results], ref.query
    assert (ref.refused, ref.refusal_reason) == (got.refused, got.refusal_reason), ref.query
    assert ref.channel_counts == got.channel_counts, ref.query
    assert list(ref.timings) == list(got.timings), ref.query
    np.testing.assert_allclose(got.max_score, ref.max_score, atol=ATOL, rtol=0)
    for field in ("final_score", "rrf_score", "semantic_score", "graph_score", "rerank_score"):
        np.testing.assert_allclose(
            [getattr(x, field) for x in got.results], [getattr(x, field) for x in ref.results],
            atol=ATOL, rtol=0, err_msg=f"{field} of {ref.query!r}",
        )
    lex_ref, lex_got = ([x.lexical_score for x in r.results] for r in (ref, got))
    if lexical_atol is None:
        assert lex_got == lex_ref, ref.query
    else:
        np.testing.assert_allclose(lex_got, lex_ref, atol=lexical_atol, rtol=0)
    assert [x.source_channels for x in ref.results] == [x.source_channels for x in got.results]


def _run_both(ref, port, lexical_atol=None):
    for q in QUERIES:
        _compare(ref.query(q), port.query(q), lexical_atol)
    for coll in ("a", "b", "nope"):
        for q in QUERIES[:4]:
            _compare(ref.query(q, collection=coll), port.query(q, collection=coll), lexical_atol)
    _compare(ref.query(QUERIES[0], top_k=3), port.query(QUERIES[0], top_k=3), lexical_atol)


def _counters(reg):
    out = {name: reg.counter(name).value() for name in COUNTERS}
    for ch in ("lexical", "semantic", "graph"):
        out[ch] = reg.counter("retrieval_channel_hits_total").value({"channel": ch})
    out["latency_count"] = reg.histogram("retrieval_latency_ms").count()
    return out


@pytest.mark.parametrize("options", [
    {"lexical_backend": "auto"},
    {"lexical_backend": "sorted"},
    {"lexical_backend": "postings"},
    {"lexical_backend": "termtable"},
    {"embedding_dtype": "float32"},
    {"embedding_dtype": "int8"},
    {"embedding_dtype": "int4"},
    {"semantic_backend": "ivf", "ivf_block_rows": 8, "ivf_probes": 2},
    {"rerank_backend": "dot"},
    {"rerank_backend": "none"},
    {"rerank_enabled": False},
    {"safety_enabled": False, "denoise_enabled": False},
    {"conformal_denoise_enabled": True},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_staged_query_matches_reference(cfg, options):
    c = cfg.replace(**options)
    ref, port = _pair(c)
    assert not port.use_sharded_engine
    ref_metrics.reset()
    rag_metrics.reset()
    _run_both(ref, port, lexical_atol=ATOL if c.lexical_backend == "termtable" else None)
    assert _counters(rag_metrics) == _counters(ref_metrics)
    n = len(QUERIES) + 12 + 1
    assert rag_metrics.counter("retrieval_queries_total").value() == n
    # the stopword-only query's failed embed, counted once per staged query
    assert rag_metrics.counter("semantic_channel_failures_total").value() == 1
    ret = port.retriever
    assert ret.state.embeddings is ret.dense_index.embeddings or c.semantic_backend == "ivf"
    if c.rerank_enabled and c.rerank_backend == "maxsim":
        assert ret.reranker.index.tokens is ret.state.maxsim_tokens  # the placed store


def test_rerank_fn_and_its_fallback(cfg):
    calls = []

    def overlap(query, texts):
        calls.append(len(texts))
        words = set(query.lower().split())
        return [len(words & set(t.lower().split())) / 4.0 for t in texts]

    def broken(query, texts):
        raise RuntimeError("reranker down")

    ref, port = _pair(cfg, rerank_fn=overlap)
    for q in QUERIES[:6]:
        _compare(ref.query(q), port.query(q))
    assert calls and len(calls) == 12 and max(calls) <= cfg.rerank_max_candidates
    # the engine leaves the callable out, as the reference's does
    assert port.query_batch(QUERIES[:1])[0].results
    ref_b, port_b = _pair(cfg, rerank_fn=broken)
    ref_m, port_m = _pair(cfg)
    for q in QUERIES[:6]:
        got = port_b.query(q)
        _compare(ref_b.query(q), got)
        # a failing callable falls back to the MaxSim rerank
        assert [x.chunk_id for x in got.results] == [x.chunk_id for x in port_m.query(q).results]


def test_module_level_retrieve(cfg):
    ref, port = _pair(cfg)
    for q in QUERIES[:3]:
        want = ref_retrieve(ref.ingestor.corpus, q, top_k=4, collection="a", config=cfg)
        got = retrieve(port.ingestor.corpus, q, top_k=4, collection="a",
                       config=torch_config(cfg), device="cpu")
        _compare(want, got)


@pytest.mark.parametrize("backend", ["postings", "sorted", "auto"])
def test_lexical_channel_bit_equal(cfg, backend):
    """``score_postings_pre`` over the placed CSR's folded weights gives the reference's
    on-the-fly ``idf * tf * (k1+1) / (tf + denom)`` sums bit for bit, and each
    backend's staged search the reference's ids and score bits."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(200)]
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 50))) for _ in range(300)]
    c = cfg.replace(lexical_backend=backend, max_query_terms=16, capacity_round=64)
    ref = ref_build_bm25(texts, c)
    offs, lens, pd, _ = ref.host_csr
    arrays = {
        "parent_of": np.zeros(ref.n_pad, np.int32), "bm25_offsets": offs, "bm25_lengths": lens,
        "bm25_postings_doc": pd, "bm25_postings_weight": ref.host_weights, "bm25_idf": ref.idf,
        "bm25_term_ids": ref.term_ids, "bm25_term_weights": ref.term_weights,
    }
    st = IndexState.from_numpy({k: np.asarray(v) for k, v in arrays.items()},
                               {"vocab": ref.vocab.to_list(), "corpus": texts},
                               torch_config(c), "cpu")
    mask = np.arange(ref.n_pad) % 3 != 0
    for trial in range(25):
        kws = list(rng.choice(words, size=rng.integers(1, 16))) + ["unknownword"]
        qt = ref.encode_query(kws)
        if backend == "postings":
            want = np.asarray(ref.score(jnp.asarray(qt)))
            got = score_postings_pre(st.lex_offsets, st.lex_lengths, st.lex_pd, st.lex_pt,
                                     torch.from_numpy(qt), l_max=st.lex_l_max, n_pad=st.n_pad)
            np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        row_mask = None if trial % 2 else mask
        want_ids, want_vals = ref.search(kws, 10, None if row_mask is None else jnp.asarray(row_mask))
        got_ids, got_vals = port_bm25.lexical_search(
            st, kws, 10, None if row_mask is None else torch.from_numpy(row_mask))
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_vals.numpy().view(np.int32),
                                      np.asarray(want_vals).view(np.int32))


def test_khop_chunk_scores_equal():
    rng = np.random.default_rng(1)
    e, deg, n, m = 64, 4, 300, 3
    nbr = np.where(rng.random((e, deg)) < 0.6, rng.integers(0, e, (e, deg)), -1).astype(np.int32)
    ce = np.where(rng.random((n, m)) < 0.5, rng.integers(0, e, (n, m)), -1).astype(np.int32)
    for hops in (1, 2, 3):
        seeds = rng.random(e) < 0.05
        want = np.asarray(ref_khop_chunk_scores(jnp.asarray(nbr), jnp.asarray(ce),
                                                jnp.asarray(seeds), hops=hops))
        got = khop_chunk_scores(torch.from_numpy(nbr), torch.from_numpy(ce),
                                torch.from_numpy(seeds), hops=hops)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_score_candidates(cfg, store, path):
    c = cfg.replace(embedding_dtype=store)
    ref, _ = _pair(c)
    rx = ref.retriever.maxsim_index
    st = state_from_retriever(ref.retriever)
    mx = MaxSimIndex(tokens=st.maxsim_tokens, mask=st.maxsim_mask, n_parents=rx.n_parents,
                     config=torch_config(c))
    rng = np.random.default_rng(2)
    tq, d = c.maxsim_query_tokens, c.maxsim_dim
    for _ in range(3):
        rows = rng.integers(-1, rx.n_parents, size=c.rerank_top_k).astype(np.int32)
        q = rng.standard_normal((tq, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w = (rng.random(tq) < 0.8).astype(np.float32) * rng.choice([1.0, 0.25], tq).astype(np.float32)
        want = np.asarray(RefMaxSimIndex.score_candidates(
            rx, jnp.asarray(rows), jnp.asarray(q), jnp.asarray(w),
            use_pallas=path != "xla", interpret=True))
        got = mx.score_candidates(torch.from_numpy(rows), torch.from_numpy(q), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        assert (got.numpy()[rows < 0] == 0).all()


class _BrokenExtractor:
    def extract(self, parent, children):
        raise RuntimeError("extractor down")


def _ingest_counters(reg):
    names = ("ingest_skipped_total", "ingest_documents_total", "ingest_chunks_total",
             "ingest_failed_total", "ner_failed_parents_total")
    out = {name: reg.counter(name).value() for name in names}
    out["duration_count"] = reg.histogram("ingest_duration_ms").count()
    return out


def test_ingest_counters_match_reference(cfg):
    """Documents ingested, skipped (the same text again) and failed (invalid JSON),
    chunks stored, and parents whose entity extraction failed: the port counts
    what the reference counts."""
    ref_metrics.reset()
    rag_metrics.reset()
    rags = _pair(cfg)
    for r in rags:
        assert r.ingest_text(DOCS[0], name="d0.md", collection="a").skipped
        assert r.ingest_text("{not json", name="bad.json").error
    broken = (RefRAG(cfg, extractor=_BrokenExtractor()),
              RAG(torch_config(cfg), device="cpu", extractor=_BrokenExtractor()))
    for r in broken:
        assert r.ingest_text(DOCS[7], name="d7.md").error
    got = _ingest_counters(rag_metrics)
    assert got == _ingest_counters(ref_metrics)
    assert got["ingest_documents_total"] == 7 and got["ingest_skipped_total"] == 1
    assert got["ingest_failed_total"] == 1 and got["ner_failed_parents_total"] > 0


def test_search_by_keywords_graph(cfg):
    ref, port = _pair(cfg)
    gx, port_gx = ref.retriever.graph_index, port.retriever.graph_index
    assert port_gx.placed is port.retriever.state  # over the placed tables
    found = []
    for kws in (["Acme Corp"], ["Globex Inc", "Recife"], ["nothing here"]):
        want_ids, want_vals = gx.search_by_keywords_graph(kws, 5)
        got_ids, got_vals = port_gx.search_by_keywords_graph(kws, 5)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))
        found.append(int((got_ids >= 0).sum()))
    assert found[0] > 0 and found[2] == 0  # no seeds: the empty lists

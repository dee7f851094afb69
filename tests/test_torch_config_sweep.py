"""``RAGConfig`` fields across both query paths, port against reference, on the CPU.

Each case changes a few fields of the small test configuration that no other
``tests/test_torch_*.py`` varies (channel toggles and weights, the fusion blend and
the lexical-confidence gate, the denoisers, the rerank blends and backends, BM25 and
analyzer options, graph hops and degree, row dtypes, the lexical backend and its
tiering, chunk sizes, ``use_fused_topk``). Both facades ingest the same 8
documents; the staged ``RAG.query`` and the batched ``query_batch`` (the
reference's ``ShardedEngine`` on one device, as ``tests/test_torch_facade.py``
places it) answer the same 8 queries. Final ids, refusals and their reasons and
channel counts must be equal; scores agree within 1e-5 and the CSR backends'
lexical scores bit for bit (the term table's within 1e-5), as in
``tests/test_torch_staged.py`` and ``tests/test_torch_engine.py``.
"""

import pytest
import torch

from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh

from test_torch_engine import _compare as _compare_batch
from test_torch_facade import DOCS
from test_torch_staged import ATOL, QUERIES, _compare
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG

SWEEP_QUERIES = QUERIES[:8]
CASES = [
    {"lexical_enabled": False},
    {"semantic_enabled": False},
    {"graph_enabled": False},
    {"lexical_weight": 0.3, "semantic_weight": 1.2, "graph_weight": 0.5},
    {"rrf_k": 10},
    {"fusion_score_blend": 0.5},
    {"fusion_lex_conf_gate": 0.0},
    {"denoise_enabled": False},
    {"denoise_alpha": 0.9},
    {"conformal_denoise_enabled": True, "conformal_alpha": 0.3},
    {"rerank_blend_rrf": 0.2},
    {"rerank_blend_rrf_relational": 0.4, "planner_relational_text_scale": 1.0},
    {"rerank_backend": "dot"},
    {"rerank_backend": "none"},
    {"bm25_k1": 2.0, "bm25_b": 0.3},
    {"bm25_df_cap": 3},
    {"analyzer_stemming": "none", "analyzer_min_token_len": 3},
    {"analyzer_strip_accents": False, "analyzer_languages": ("en",)},
    {"graph_hops": 1},
    {"graph_hops": 3, "graph_max_degree": 2},
    {"embedding_dtype": "float32", "use_fused_topk": False},
    {"embedding_dtype": "int4", "use_fused_topk": True},
    {"lexical_backend": "termtable", "lexical_tiering": False},
    {"child_chunk_tokens": 30, "child_chunk_overlap_tokens": 5, "parent_chunk_tokens": 90,
     "parent_chunk_min_tokens": 60},
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cfg(small_config):
    return small_config.replace(safety_threshold=0.2, capacity_round=8, use_native=False)


@pytest.mark.parametrize("options", CASES, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_config_field_matches_reference(cfg, options):
    c = cfg.replace(**options)
    ref, port = RefRAG(c), RAG(torch_config(c), device="cpu")
    for i, text in enumerate(DOCS):
        res = [r.ingest_text(text, name=f"d{i}.md", collection="ab"[i % 2]) for r in (ref, port)]
        assert res[0].doc_id == res[1].doc_id and res[0].n_children == res[1].n_children
    assert port.stats() == ref.stats()
    lexical_atol = ATOL if c.lexical_backend == "termtable" else None
    for q in SWEEP_QUERIES:
        _compare(ref.query(q), port.query(q), lexical_atol)
    _compare(ref.query(SWEEP_QUERIES[0], collection="a"), port.query(SWEEP_QUERIES[0], collection="a"),
             lexical_atol)
    ref._engine = ShardedEngine(ref.retriever, single_device_mesh())
    want, got = ref.query_batch(SWEEP_QUERIES), port.query_batch(SWEEP_QUERIES)
    _compare_batch(want, got, lexical_atol=lexical_atol)
    for w, g in zip(want, got):
        assert (w.refusal_reason, w.channel_counts) == (g.refusal_reason, g.channel_counts), w.query
    assert any(r.results for r in got)  # the case answers, it does not only refuse

"""The port's batched query program against the JAX ShardedEngine on one device.

The JAX Retriever is built on the sharded-engine fixture and its index arrays are
carried over with ``IndexState.from_numpy``, so both programs run on identical
indexes. Chunk ids and refusals must be equal; final scores agree within 1e-5
(f32 summation order of the dense and MaxSim products), with bf16 rows (the
serving dtype), f32 rows and quantized int8 / packed-int4 rows (whose dense scores
are bit-equal to the reference's); the sorted BM25 channel's scores are
bit-identical, the term-table channel's agree within 1e-5 (its f32 sum over the
table's slots runs in another order than XLA's reduce).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.index.dense_index import dense_scores_batch as ref_dense_scores
from triple_hybrid_rag_tpu.index.dense_index import dense_scores_int4_batch as ref_int4_scores
from triple_hybrid_rag_tpu.index.dense_index import dense_scores_int8_batch as ref_int8_scores
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh
from triple_hybrid_rag_tpu.retrieval import Retriever
from triple_hybrid_rag_tpu.types import Document

from test_sharded import build_fixture
from torch_port_helpers import state_from_retriever, torch_config
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.index.dense_index import (
    dense_scores_batch,
    int_scores,
    quantize_queries_int8,
)

QUERIES = [
    "invoice payment settlement",
    "How do I reset my password?",
    "Who works for Acme Corp?",
    "contract termination notice",
    "fox habitat in the forest",
    "How is Acme Corp related to Document 3?",
]


@pytest.fixture
def cfg(small_config):
    return small_config.replace(
        embedding_dtype="float32", safety_threshold=0.2, capacity_round=8
    )


def _retriever(cfg, with_graph):
    corpus, gidx = build_fixture(cfg, with_graph=with_graph)
    for i in range(12):  # two tenants, so scoped batches mask real rows
        doc_id = hashlib.sha256(f"doc{i}".encode()).hexdigest()
        corpus.register_document(
            Document(doc_id=doc_id, filename=f"d{i}.md", collection=("a", "b")[i % 2])
        )
    return Retriever(corpus, cfg, graph_index=gidx)


def _compare(ref, got, atol=1e-5, lexical_atol=None):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert [x.chunk_id for x in r.results] == [x.chunk_id for x in g.results], r.query
        assert r.refused == g.refused, r.query
        np.testing.assert_allclose(
            [x.final_score for x in g.results], [x.final_score for x in r.results], atol=atol
        )
        np.testing.assert_allclose(g.max_score, r.max_score, atol=atol)
        lex_ref, lex_got = ([x.lexical_score for x in res.results] for res in (r, g))
        if lexical_atol is None:  # the sorted lexical channel is bit-identical
            assert lex_got == lex_ref
        else:
            np.testing.assert_allclose(lex_got, lex_ref, atol=lexical_atol, rtol=0)


def _near_tie_evidence(ret, eng, q, coll):
    """Why a dense-score rounding difference grows in the final score of ``q``.

    The dense channel's scores agree within 2e-7 (a few f32 ulps), but the final
    score min-max normalises twice: the semantic channel's scores over the fused candidates (in
    the CombSUM blend), then the fused scores (in the rerank blend). Returns the
    two spreads; their product is the inverse of the amplification."""
    _, out = eng.search_arrays([q], [coll])
    fused = out[4]
    ok = fused.ids[0] >= 0
    rows = fused.ids[0][ok]
    q_vec = eng.prepare_queries([q], [coll])[1].q_vec.float()
    got = dense_scores_batch(eng.state.embeddings, q_vec)[0][rows].numpy()
    want = np.asarray(ref_dense_scores(ret.dense_index.embeddings, jnp.asarray(q_vec.numpy())))
    np.testing.assert_allclose(got, want[0][rows.numpy()], atol=2e-7, rtol=0)
    sem, rrf = fused.semantic[0][ok], fused.rrf[0][ok]
    return float(sem.max() - sem.min()), float(rrf.max() - rrf.min())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("with_graph", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_sharded_engine(cfg, with_graph, fused, dtype):
    # 4 activated-entity slots are below this graph's worst-case reach, so (as at
    # the 1M-chunk serving shape) wide batches scan chunk_entities and batches of
    # <= graph_sparse_max_batch take the sparse mention walk
    c = cfg.replace(
        use_fused_topk=fused, graph_enabled=with_graph, graph_active_slots=4, embedding_dtype=dtype
    )
    ret = _retriever(c, with_graph)
    ref_eng = ShardedEngine(ret, single_device_mesh())
    eng = Engine(state_from_retriever(ret), device="cpu")
    assert eng.use_fused() is fused
    if with_graph:
        assert eng.state.graph_mode == ref_eng.graph_mode == "dense"
        assert eng.state.graph_small_sparse and ref_eng.graph_small_sparse
    if dtype in ("int8", "int4"):
        assert (ref_eng._use_int8, ref_eng._use_int4) == (dtype == "int8", dtype == "int4")
        rows = eng.state.embeddings
        assert rows.dtype == (torch.int8 if dtype == "int8" else torch.uint8)
        assert eng.state.dim == c.embedding_dim == rows.shape[1] * (2 if dtype == "int4" else 1)
        q_vec = eng.prepare_queries(QUERIES)[1].q_vec.float()
        score = ref_int8_scores if dtype == "int8" else ref_int4_scores
        want = score(ret.dense_index.embeddings, ret.dense_index.scales, jnp.asarray(q_vec.numpy()))
        got = int_scores(rows, eng.state.dense_scales, *quantize_queries_int8(q_vec))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # bit-equal dense scores
        assert eng.state.maxsim_tokens.dtype == torch.int8  # the reference's token store

    # B > graph_sparse_max_batch: the large-batch (dense graph) program
    assert len(QUERIES) > c.graph_sparse_max_batch
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES))
    # scoped per query: tenant a, tenant b, unscoped, unknown
    colls = ["a", "b", None, "nope", "a", "b"]
    _compare(
        ref_eng.retrieve_batch(QUERIES, collections=colls),
        eng.retrieve_batch(QUERIES, collections=colls),
    )
    # B = 1: the sparse graph override, and the graph-skip program for plain plans
    for q in QUERIES:
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]))
    for q in QUERIES[:5]:
        _compare(
            ref_eng.retrieve_batch([q], collection="a"), eng.retrieve_batch([q], collection="a")
        )
    q = QUERIES[5]
    atol = 1e-5
    if dtype == "float32":
        # with f32 rows the dot products themselves round, in another order in XLA
        # than in PyTorch; for this query in tenant a the candidates nearly tie, and
        # the two min-max spreads scale that <= 2e-7 difference by more than 100,
        # to 2e-5 - 3e-5 in the final score (ids and refusals still agree exactly).
        # bf16 rows have exact products and hold 1e-5 here too.
        sem_spread, rrf_spread = _near_tie_evidence(ret, eng, q, "a")
        print(f"near tie: semantic spread {sem_spread:.4g}, fused spread {rrf_spread:.4g}")
        assert sem_spread * rrf_spread < 1e-2
        atol = 1e-4
    _compare(
        ref_eng.retrieve_batch([q], collection="a"), eng.retrieve_batch([q], collection="a"),
        atol=atol,
    )


@pytest.mark.parametrize("dtype", ["int8", "int4", "bfloat16"])
def test_maxsim_store_keeps_the_reference_dtype(cfg, dtype):
    """The MaxSim token store arrives on the device in the reference's storage dtype:
    int8 under int8 and int4 dense rows (never widened to bf16), bf16 otherwise, with
    the reference's byte count; ids and refusals stay equal to ShardedEngine's."""
    c = cfg.replace(embedding_dtype=dtype, graph_enabled=False)
    ret = _retriever(c, False)
    ref_tokens = np.asarray(ret.maxsim_index.tokens)
    st = state_from_retriever(ret)
    assert ref_tokens.dtype == (np.int8 if dtype != "bfloat16" else jnp.bfloat16)
    assert st.maxsim_tokens.dtype == (torch.int8 if dtype != "bfloat16" else torch.bfloat16)
    assert st.maxsim_tokens.shape == ref_tokens.shape
    assert st.nbytes()["maxsim"] == ref_tokens.nbytes + np.asarray(ret.maxsim_index.mask).nbytes
    if dtype != "bfloat16":
        np.testing.assert_array_equal(st.maxsim_tokens.numpy(), ref_tokens)
    ref_eng = ShardedEngine(ret, single_device_mesh())
    eng = Engine(st, device="cpu")
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES))
    for q in QUERIES[:3]:
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]))


@pytest.mark.parametrize("backend", ["termtable", "postings"])
@pytest.mark.parametrize("with_graph", [True, False])
def test_engine_termtable_matches_sharded_engine(cfg, with_graph, backend):
    """The doc-major term-table lexical backend ("postings" selects it too, as in
    the reference): ids and refusals equal, lexical and final scores within 1e-5."""
    c = cfg.replace(lexical_backend=backend, graph_enabled=with_graph, embedding_dtype="bfloat16")
    ret = _retriever(c, with_graph)
    ref_eng = ShardedEngine(ret, single_device_mesh())
    st = state_from_retriever(ret)
    eng = Engine(st, device="cpu")
    assert st.lexical_mode == ref_eng.lexical_mode == "termtable"
    # "postings" also places the CSR, for the staged retriever's term-at-a-time scan
    assert (st.lex_offsets is None) == (backend == "termtable")
    assert st.term_ids.shape == (st.n_pad, c.doc_term_capacity)
    assert st.term_weights.dtype == torch.float32 and st.nbytes()["term_table"] > 0
    check = dict(lexical_atol=1e-5)
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES), **check)
    colls = ["a", "b", None, "nope", "a", "b"]
    _compare(
        ref_eng.retrieve_batch(QUERIES, collections=colls),
        eng.retrieve_batch(QUERIES, collections=colls), **check,
    )
    for q in QUERIES:
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]), **check)
        _compare(
            ref_eng.retrieve_batch([q], collection="b"), eng.retrieve_batch([q], collection="b"),
            **check,
        )
    # the lexical channel really contributed
    assert any(x.lexical_score > 0 for r in eng.retrieve_batch(QUERIES) for x in r.results)


def test_engine_graph_modes(cfg):
    """The port reproduces the reference's graph-backend policy: exact sparse at
    every width on this small graph, and the dense scan when forced."""
    ret = _retriever(cfg, True)
    ref = ShardedEngine(ret, single_device_mesh())
    st = state_from_retriever(ret)
    assert (st.graph_mode, st.graph_small_sparse) == (ref.graph_mode, ref.graph_small_sparse)
    assert st.graph_mode == "sparse"
    assert (st.graph_active, st.g_l_max, st.lex_l_max) == (
        ref.graph_active, ref.g_l_max, ref.lex_l_max
    )
    _compare(ref.retrieve_batch(QUERIES), Engine(st, device="cpu").retrieve_batch(QUERIES))
    dense = cfg.replace(graph_backend="dense")
    ret_d = _retriever(dense, True)
    st_d = state_from_retriever(ret_d)
    assert st_d.graph_mode == "dense" == ShardedEngine(ret_d, single_device_mesh()).graph_mode
    eng = Engine(st_d, device="cpu")
    _compare(ShardedEngine(ret_d, single_device_mesh()).retrieve_batch(QUERIES),
             eng.retrieve_batch(QUERIES))


def test_engine_refresh_and_unported_options(cfg):
    ret = _retriever(cfg, True)
    st = state_from_retriever(ret)
    eng = Engine(st, device="cpu")
    assert eng.refresh(state_from_retriever(ret))
    # config.mesh_shape is only carried, as in the reference (its engine's mesh
    # decides): a config with mesh_shape=(2,) builds and serves as the reference's
    c = cfg.replace(mesh_shape=(2,))
    ret2 = _retriever(c, True)
    two = Engine(state_from_retriever(ret2), device="cpu")
    assert two.config.mesh_shape == (2,) and two.mesh.shape == {"data": 1, "shard": 1}
    _compare(ShardedEngine(ret2, single_device_mesh()).retrieve_batch(QUERIES),
             two.retrieve_batch(QUERIES))
    assert torch.is_tensor(eng.run(eng.prepare_queries(QUERIES[:2])[1])[0])


def test_tiered_lexical_entries_count(cfg):
    """One ``retrieve_batch`` sorts exactly sum(min(df, window)) lexical entries over
    the slots ``encode_query_tiered`` keeps: the small tier's window is
    ``bm25_small_window``, the large tier's ``l_max``, and terms past
    ``bm25_large_slots`` read nothing."""
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    c = cfg.replace(bm25_small_window=3, bm25_large_slots=1)
    st = state_from_retriever(_retriever(c, False))
    eng = Engine(st, device="cpu")
    assert st.lexical_mode == "sorted" and eng.config.lexical_tiering
    df = st.stored_df
    small_read, large_read, dropped = 0, 0, 0
    for q in QUERIES:
        kws = eng.planner.plan(q).keywords
        small, _, large, _ = st.encode_query_tiered(kws)
        small_read += sum(min(int(df[t]), 3) for t in small if t >= 0)
        large_read += sum(min(int(df[t]), st.lex_l_max) for t in large if t >= 0)
        dropped += int((st.encode_query(kws) >= 0).sum() - (small >= 0).sum()
                       - (large >= 0).sum())
    assert small_read and large_read and dropped  # both tiers read, a large term left out
    entries = rag_metrics.counter("bm25_tiered_entries_total")
    before = entries.value()
    eng.retrieve_batch(QUERIES)
    assert entries.value() - before == small_read + large_read

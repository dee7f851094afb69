"""The port's ``RAG`` facade against the JAX reference's, end to end on the CPU.

Both facades ingest the same texts (``ingest_text``) and answer the same batches
(``query_batch``, through the port's ``Engine`` and the reference's
``ShardedEngine``, which the test places on one device as the port's is: the
reference facade would take every device of the test's virtual mesh, and its IVF
layout is built per shard). Every index array the port places must be bit-equal to the one
the reference's retriever places (carried over with ``IndexState.from_numpy``),
except what the tiny encoder embeds: the dense rows agree within 1e-6 (the two
packages' f32 forwards, as ``tests/test_torch_encoder_engine.py`` states) and the
MaxSim tokens, rounded to bf16 when placed, within one bf16 step (2**-8 at unit
scale: vectors 1e-7 apart can round to neighbouring bf16 values). Final ids
and refusals must be equal and scores agree within 1e-5; under the encoder a query
whose f16 wire rounds differently in the two packages is held to 1e-3 with the
evidence asserted (``_wire_split``).
"""

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.models.encoder import EncoderConfig, EncoderEmbedder
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh

from test_torch_encoder_engine import TINY, _compare as _compare_encoder, _wire_split
from test_torch_engine import _compare
from torch_port_helpers import flat_params, state_from_retriever, torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.models import encoder as enc

TOPICS = ["invoice payment terms", "password reset procedure", "fox habitat forest",
          "contract termination notice", "shipping routes and depots"]
DOCS = [
    f"# Document {i}\n\nAcme Corp publishes document {i} about {TOPICS[i % 5]}. "
    f"Globex Inc works for Acme Corp in Recife. "
    + " ".join(f"Detail sentence {j} covering {TOPICS[i % 5]} item {j}." for j in range(12))
    for i in range(8)
]
QUERIES = ["invoice payment settlement", "How do I reset my password?", "Who works for Acme Corp?",
           "contract termination notice", "fox habitat in the forest", "Globex Recife depots"]
STATE_KEYS = ("parent_of", "collection_of", "lex_offsets", "lex_lengths", "lex_pd", "lex_pt",
              "term_ids", "term_weights", "valid", "dense_scales", "nbr", "chunk_entities",
              "g_offsets", "g_lengths", "g_docs", "maxsim_tokens", "maxsim_mask", "parent_emb",
              "ivf_perm", "ivf_centroids")


@pytest.fixture
def cfg(small_config):
    return small_config.replace(safety_threshold=0.2, capacity_round=8, use_native=False)


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_same_state(port, ref, dense_atol=None):
    """Every placed array equal; with ``dense_atol`` (an encoder's rows) the dense
    rows within it and the MaxSim tokens within one bf16 step."""
    for key in STATE_KEYS:
        a, b = getattr(port, key), getattr(ref, key)
        assert (a is None) == (b is None), key
        if a is None:
            continue
        if dense_atol is not None and key == "maxsim_tokens":
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2**-8, rtol=0)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    for key in ("n_pad", "lex_l_max", "lexical_mode", "graph_mode", "graph_small_sparse",
                "graph_active", "g_l_max", "dim", "collection_ids", "row_of"):
        assert getattr(port, key) == getattr(ref, key), key
    if dense_atol is None:
        np.testing.assert_array_equal(_bits(port.embeddings), _bits(ref.embeddings))
    else:
        np.testing.assert_allclose(port.embeddings.float().numpy(), ref.embeddings.float().numpy(),
                                   atol=dense_atol, rtol=0)


def _pair(cfg, **kw):
    ref = RefRAG(cfg, use_sharded_engine=True, **{k: v[0] for k, v in kw.items()})
    port = RAG(torch_config(cfg), use_sharded_engine=True, device="cpu",
               **{k: v[1] for k, v in kw.items()})
    return ref, port


def _ingest(rags, docs, start=0):
    for i, text in enumerate(docs, start):
        res = [r.ingest_text(text, name=f"d{i}.md", collection="ab"[i % 2]) for r in rags]
        assert res[0].doc_id == res[1].doc_id and res[0].status == res[1].status
        assert res[0].n_children == res[1].n_children
    ref = rags[0]
    if ref._engine is None:  # one device; a refresh keeps the engine's mesh
        ref._engine = ShardedEngine(ref.retriever, single_device_mesh())


@pytest.mark.parametrize("backend", ["exact", "ivf"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_facade_matches_reference(cfg, dtype, backend):
    c = cfg.replace(embedding_dtype=dtype, semantic_backend=backend, ivf_block_rows=8, ivf_probes=2)
    ref, port = _pair(c)
    _ingest((ref, port), DOCS[:6])
    got = port.query_batch(QUERIES)
    _compare(ref.query_batch(QUERIES), got)
    _assert_same_state(port.retriever.state, state_from_retriever(ref.retriever))
    colls = ["a", "b", None, "nope", "a", "b"]
    _compare(ref.query_batch(QUERIES, collections=colls), port.query_batch(QUERIES, collections=colls))
    stats = port.stats()
    assert stats == ref.stats() and stats["engine_semantic_backend"] == backend
    assert any(r.results for r in got)
    # query through the engine equals its row of the batch
    for i, q in enumerate(QUERIES[:3]):
        one = port.query(q)
        assert [x.chunk_id for x in one.results] == [x.chunk_id for x in
                                                     port.query_batch([q])[0].results]
        _compare([ref.query(q)], [one])


def test_incremental_ingest_refreshes_the_engine(cfg):
    """A document that changes no static statistic (capacity, postings window, entity
    capacity) refreshes the engine in place; one that lengthens the longest postings
    window builds a new engine. Either way the answers stay the reference's."""
    ref, port = _pair(cfg.replace(capacity_round=64))
    _ingest((ref, port), DOCS[:5])
    _compare(ref.query_batch(QUERIES), port.query_batch(QUERIES))
    engine = port._engine
    memo = "# Memo\n\nZephyr Labs audits quartz turbines in Lisbon every week."
    _ingest((ref, port), [memo], start=5)
    assert port.ingestor.corpus.dirty
    _compare(ref.query_batch(QUERIES), port.query_batch(QUERIES))
    assert port._engine is engine and not port.ingestor.corpus.dirty  # refreshed, not rebuilt
    assert port._engine.state is port.retriever.state
    _assert_same_state(port.retriever.state, state_from_retriever(ref.retriever))
    new = port.query_batch(["quartz turbines audits Lisbon"], collection="b")[0]
    assert new.results[0].doc_id == port.ingestor.corpus.children[-1].doc_id
    assert port.ingest_text(memo, name="d5.md", collection="b").skipped  # the same text again
    _ingest((ref, port), DOCS[5:7], start=6)  # every common term's df grows
    _compare(ref.query_batch(QUERIES), port.query_batch(QUERIES))
    assert port._engine is not engine


def test_facade_with_the_tiny_encoder(cfg):
    c = cfg.replace(embedding_dtype="float32", embedder_backend="encoder", graph_enabled=False)
    ref_emb = EncoderEmbedder(EncoderConfig(**TINY), c)
    port_emb = enc.EncoderEmbedder(
        enc.EncoderConfig(**TINY), torch_config(c),
        params=enc.encoder_params_from_flax(flat_params(ref_emb.params)), device="cpu",
    )
    ref, port = _pair(c, embedder=(ref_emb, port_emb))
    _ingest((ref, port), DOCS[:6])
    ref_eng, eng = ref._get_engine(), port._get_engine()
    _assert_same_state(port.retriever.state, state_from_retriever(ref.retriever), dense_atol=1e-6)
    assert eng.maxsim_calibration == ref_emb.maxsim_calibration
    atol = 1e-3 if _wire_split(ref_eng, eng, QUERIES) else 1e-5
    _compare_encoder(ref.query_batch(QUERIES), port.query_batch(QUERIES), atol)


def test_unported_facade_calls_raise(cfg):
    rag = RAG(torch_config(cfg), device="cpu")
    rag.ingest_text(DOCS[0], name="d0.md")
    assert rag.query_batch(QUERIES[:2])[0].results
    # the staged query and rerank_fn are ported (tests/test_torch_staged.py)
    assert rag.query(QUERIES[0]).results and rag.retriever.retrieve(QUERIES[0]).results
    assert RAG(torch_config(cfg), device="cpu", rerank_fn=lambda *a: None)._rerank_fn
    # save and load are ported (tests/test_torch_checkpoint.py)
    for kw in ({"config": torch_config(cfg.replace(embed_api_base="http://localhost:1"))},
               {"ocr_fn": lambda *a: None}):
        kw.setdefault("config", torch_config(cfg))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RAG(device="cpu", **kw)
    assert rag.query_batch([]) == []

"""The reference's contracts that the port keeps, on the CPU, against the JAX package.

Repairs: ``Retriever.from_indexes(reranker=)`` keeps the given reranker;
``MaxSimIndex.score_candidates`` takes ``use_pallas`` and ``interpret`` (the store's
device picks the body, so every combination gives the reference's scores, atol 1e-6);
``BM25Index`` carries ``postings_tf``, ``contrib_denom_k1``, ``host_csr`` and
``host_weights`` and ``GraphIndex`` ``host_chunk_entities``, bit-equal to the
reference's build; ``score_termtable_batch(query_terms_batch=)`` and
``init_encoder(enc_cfg=)``; ``score_postings`` over term frequencies, bit for bit;
``EncoderEmbedder``'s optional config and ``seed``.

Names the port lacked: ``maxsim_scores_batch`` (atol 1e-6, bf16 and int8 tokens,
invalid and empty candidates, a query without tokens, at Tq 32 / D 128 and Tq 256 /
D 1024), ``score_postings_topk`` (ids equal, scores bit for bit),
``chunk_scores_from_entities_batch`` (bit for bit), ``save_encoder_params`` /
``load_encoder_params`` (files read by either package; the forwards within 1e-5, the
f32 tolerance of ``tests/test_torch_encoder.py``), and ``pretrain.DATA_DIR``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.index.bm25_index import build_bm25_index as ref_build_bm25
from triple_hybrid_rag_tpu.index.maxsim_index import MaxSimIndex as RefMaxSimIndex
from triple_hybrid_rag_tpu.models import encoder as ref_enc
from triple_hybrid_rag_tpu.models import pretrain as ref_pretrain
from triple_hybrid_rag_tpu.ops import bm25 as ref_bm25
from triple_hybrid_rag_tpu.ops import graph as ref_graph
from triple_hybrid_rag_tpu.ops import maxsim as ref_maxsim
from triple_hybrid_rag_tpu.retrieval import Retriever as RefRetriever

from test_torch_encoder_engine import TINY
from test_torch_facade import DOCS
from torch_port_helpers import state_from_retriever, torch_config
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.index import bm25_index as port_bm25
from triple_hybrid_rag_tpu_torch.index.maxsim_index import MaxSimIndex
from triple_hybrid_rag_tpu_torch.models import encoder as enc
from triple_hybrid_rag_tpu_torch.models import pretrain
from triple_hybrid_rag_tpu_torch.ops import bm25, graph, maxsim
from triple_hybrid_rag_tpu_torch.retrieval import Retriever

MAXSIM_ATOL = 1e-6  # tests/test_torch_maxsim.py's
QUERIES = ["invoice payment settlement", "How do I reset my password?",
           "Who works for Acme Corp?", "fox habitat in the forest"]


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


def _pair(cfg, docs=DOCS):
    ref, port = RefRAG(cfg), RAG(torch_config(cfg), device="cpu")
    for i, text in enumerate(docs):
        for r in (ref, port):
            r.ingest_text(text, name=f"d{i}.md", collection="ab"[i % 2])
    return ref, port


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


# ---------------------------------------------------------------- repairs


class _RefByRow:
    """A reranker of the reference's protocol: a score from the parent row alone."""

    def score(self, query_ctx, ids, fused_scores):
        return jnp.where(ids >= 0, ((ids * 7) % 11 + 1) / 11.0, 0.0).astype(jnp.float32)


class _PortByRow:
    def score(self, query_ctx, ids, fused_scores):
        s = ((ids * 7) % 11 + 1).float() / 11.0
        return torch.where(ids >= 0, s, torch.zeros_like(s))


def test_from_indexes_keeps_the_given_reranker(cfg):
    """Both packages' ``from_indexes`` over the same 8 documents' indexes, with a
    reranker of their own: the retriever keeps it, and the final ids and scores
    are the reference's."""
    ref, port = _pair(cfg)
    rr, pr = ref.retriever, port.retriever
    custom = _PortByRow()
    ref_ret = RefRetriever.from_indexes(
        rr.corpus, rr.config, rr.bm25_index, rr.dense_index, rr.graph_index, rr.maxsim_index,
        np.asarray(rr.parent_of), rr.embedder, rr.planner, reranker=_RefByRow())
    port_ret = Retriever.from_indexes(
        pr.corpus, pr.config, pr.bm25_index, pr.dense_index, pr.graph_index, pr.maxsim_index,
        pr.parent_of, pr.embedder, pr.planner, reranker=custom, device="cpu")
    assert port_ret.reranker is custom
    for q in QUERIES:
        want, got = ref_ret.retrieve(q), port_ret.retrieve(q)
        assert [x.chunk_id for x in got.results] == [x.chunk_id for x in want.results], q
        assert got.refused == want.refused
        np.testing.assert_allclose([x.final_score for x in got.results],
                                   [x.final_score for x in want.results], atol=1e-5, rtol=0)
        np.testing.assert_allclose([x.rerank_score for x in got.results],
                                   [x.rerank_score for x in want.results], atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("interpret", [False, True])
def test_score_candidates_takes_the_references_keywords(cfg, use_pallas, interpret):
    """Each combination of ``use_pallas`` and ``interpret`` gives the reference's
    einsum and its Pallas kernel in interpret mode, atol 1e-6, on a CPU store."""
    ref, _ = _pair(cfg, DOCS[:4])
    rx = ref.retriever.maxsim_index
    st = state_from_retriever(ref.retriever)
    mx = MaxSimIndex(tokens=st.maxsim_tokens, mask=st.maxsim_mask, n_parents=rx.n_parents,
                     config=torch_config(cfg))
    rng = np.random.default_rng(3)
    tq, d = cfg.maxsim_query_tokens, cfg.maxsim_dim
    rows = rng.integers(-1, rx.n_parents, size=cfg.rerank_top_k).astype(np.int32)
    q = rng.standard_normal((tq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = (rng.random(tq) < 0.8).astype(np.float32)
    got = mx.score_candidates(torch.from_numpy(rows), torch.from_numpy(q), torch.from_numpy(w),
                              use_pallas=use_pallas, interpret=interpret).numpy()
    for pallas in (False, True):
        want = np.asarray(RefMaxSimIndex.score_candidates(
            rx, jnp.asarray(rows), jnp.asarray(q), jnp.asarray(w), use_pallas=pallas,
            interpret=True))
        np.testing.assert_allclose(got, want, atol=MAXSIM_ATOL, rtol=0)


@pytest.mark.parametrize("df_cap", [0, 3])
def test_bm25_and_graph_records_carry_the_references_fields(cfg, df_cap):
    """The Python build's ``postings_tf``, ``contrib_denom_k1``, ``host_csr`` and
    ``host_weights`` bit-equal to the reference's, and the graph index's
    ``host_chunk_entities`` (the ingest's), with and without the df cap."""
    c = cfg.replace(bm25_df_cap=df_cap)
    ref, port = _pair(c)
    rb, pb = ref.retriever.bm25_index, port.retriever.bm25_index
    for name in ("postings_tf", "contrib_denom_k1", "host_weights"):
        mine, want = getattr(pb, name), np.asarray(getattr(rb, name))
        assert mine.dtype == want.dtype and mine.shape == want.shape, name
        np.testing.assert_array_equal(_bits(mine), _bits(want), err_msg=name)
    assert len(pb.host_csr) == len(rb.host_csr) == 4
    for mine, want in zip(pb.host_csr, rb.host_csr):
        assert mine.dtype == want.dtype
        np.testing.assert_array_equal(_bits(mine), _bits(want))
    assert pb.host_weights is pb.postings_weight
    rg, pg = ref.retriever.graph_index, port.retriever.graph_index
    np.testing.assert_array_equal(pg.host_chunk_entities, rg.host_chunk_entities)
    assert pg.host_chunk_entities.dtype == rg.host_chunk_entities.dtype


def test_bm25_record_fills_what_the_reference_leaves_optional(cfg):
    """A record built with the reference's required fields only folds the
    per-posting weights from the term frequencies, bit-equal to the build's."""
    texts = [" ".join(f"w{(i * j) % 37}" for j in range(3 + i % 9)) for i in range(40)]
    c = torch_config(cfg)
    built = port_bm25.build_bm25_index(texts, c)
    bare = port_bm25.BM25Index(
        offsets=built.offsets, lengths=built.lengths, postings_doc=built.postings_doc,
        postings_tf=built.postings_tf, term_ids=built.term_ids, term_weights=built.term_weights,
        contrib_denom_k1=built.contrib_denom_k1, idf=built.idf, n_docs=built.n_docs,
        n_pad=built.n_pad, l_max=built.l_max, vocab=built.vocab, config=c)
    np.testing.assert_array_equal(_bits(bare.postings_weight), _bits(built.postings_weight))
    assert bare.host_weights is bare.postings_weight
    assert bare.host_csr[0] is built.offsets and bare.host_csr[3] is built.postings_tf


def test_keyword_names_of_the_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(-2, 20, size=(16, 6)).astype(np.int32)
    w = rng.random((16, 6)).astype(np.float32)
    qt = rng.integers(-1, 20, size=(3, 4)).astype(np.int32)
    got = bm25.score_termtable_batch(torch.from_numpy(ids), torch.from_numpy(w),
                                     query_terms_batch=torch.from_numpy(qt))
    want = ref_bm25.score_termtable_batch(jnp.asarray(ids), jnp.asarray(w),
                                          query_terms_batch=jnp.asarray(qt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    model = enc.init_encoder(enc_cfg=enc.EncoderConfig(**TINY), seed=1, device="cpu")
    again = enc.init_encoder(enc.EncoderConfig(**TINY), 1, device="cpu")
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def _bm25_corpus(cfg, n_docs=300):
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(200)]
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 50))) for _ in range(n_docs)]
    return words, ref_build_bm25(texts, cfg)


def _ref_args(ref):
    return (ref.offsets, ref.lengths, ref.postings_doc, ref.postings_tf, ref.contrib_denom_k1,
            ref.idf, jnp.float32(ref.config.bm25_k1 + 1.0))


def _port_args(ref):
    offs, lens, pd, pt = ref.host_csr
    return tuple(torch.from_numpy(np.array(a)) for a in (
        offs, lens, pd, pt, ref.contrib_denom_k1, ref.idf)) + (ref.config.bm25_k1 + 1.0,)


@pytest.mark.parametrize("df_cap", [0, 16])
def test_score_postings_with_the_references_contract(cfg, df_cap):
    """Dense f32[n_pad] scores from term frequencies, the reference's bits (the
    contribution ``idf * tf * (k1 + 1) / (tf + denom)`` in its order of operations,
    added slot by slot); an all-OOV query scores 0 everywhere."""
    c = cfg.replace(max_query_terms=16, capacity_round=64, bm25_df_cap=df_cap)
    words, ref = _bm25_corpus(c)
    rng = np.random.default_rng(6)
    for trial in range(20):
        kws = list(rng.choice(words, size=rng.integers(1, 16))) + ["unknownword"]
        qt = ref.encode_query(kws if trial else ["unknownword"])
        want = np.asarray(ref_bm25.score_postings(*_ref_args(ref), jnp.asarray(qt),
                                                  l_max=ref.l_max, n_pad=ref.n_pad))
        got = bm25.score_postings(*_port_args(ref), torch.from_numpy(qt),
                                  l_max=ref.l_max, n_pad=ref.n_pad)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        if not trial:
            assert not want.any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("top_k", [10, 400])
def test_score_postings_topk_with_the_references_contract(cfg, masked, top_k):
    """Ids equal and scores bit for bit, with and without a row mask, a query
    with no known term, and a top-k above the matched postings (-1 / -inf)."""
    c = cfg.replace(max_query_terms=16, capacity_round=64)
    words, ref = _bm25_corpus(c)
    rng = np.random.default_rng(7)
    mask = np.arange(ref.n_pad) % 3 != 0
    for trial in range(12):
        kws = list(rng.choice(words, size=rng.integers(1, 6))) if trial else ["unknownword"]
        qt = ref.encode_query(kws)
        want_ids, want_vals = ref_bm25.score_postings_topk(
            *_ref_args(ref), jnp.asarray(qt), jnp.asarray(mask) if masked else None,
            l_max=ref.l_max, n_pad=ref.n_pad, top_k=top_k)
        got_ids, got_vals = bm25.score_postings_topk(
            *_port_args(ref), torch.from_numpy(qt), torch.from_numpy(mask) if masked else None,
            l_max=ref.l_max, n_pad=ref.n_pad, top_k=top_k)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_vals.numpy().view(np.int32),
                                      np.asarray(want_vals).view(np.int32))
        if top_k == 400:
            assert (got_ids.numpy() == -1).any()
    # the batched form gives each query's row
    qts = np.stack([ref.encode_query(list(rng.choice(words, size=4))) for _ in range(3)])
    rows = np.stack([mask] * 3)
    ids_b, vals_b = bm25.score_postings_topk(
        *_port_args(ref), torch.from_numpy(qts), torch.from_numpy(rows) if masked else None,
        l_max=ref.l_max, n_pad=ref.n_pad, top_k=top_k)
    for i in range(3):
        one = bm25.score_postings_topk(
            *_port_args(ref), torch.from_numpy(qts[i]), torch.from_numpy(mask) if masked else None,
            l_max=ref.l_max, n_pad=ref.n_pad, top_k=top_k)
        assert torch.equal(ids_b[i], one[0]) and torch.equal(vals_b[i], one[1])


@pytest.mark.parametrize("masked", [False, True])
def test_sorted_ops_take_the_references_single_query(cfg, masked):
    """``score_postings_topk_pre`` and ``_tiered`` take the reference's one query
    (1-D terms, a bool[n_pad] mask) and give its ids and score bits as [top_k]."""
    c = cfg.replace(max_query_terms=16, capacity_round=64, bm25_small_window=4)
    words, ref = _bm25_corpus(c)
    offs, lens, pd, _ = (torch.from_numpy(np.array(a)) for a in ref.host_csr)
    pw = torch.from_numpy(np.array(ref.host_weights))
    rng = np.random.default_rng(11)
    mask = np.arange(ref.n_pad) % 4 != 1
    shape = dict(l_max=ref.l_max, n_pad=ref.n_pad, top_k=12)
    for _ in range(8):
        kws = list(rng.choice(words, size=rng.integers(1, 10)))
        qt = ref.encode_query(kws)
        want = ref_bm25.score_postings_topk_pre(
            ref.offsets, ref.lengths, ref.postings_doc, ref.postings_weight, jnp.asarray(qt),
            jnp.asarray(mask) if masked else None, **shape)
        got = bm25.score_postings_topk_pre(offs, lens, pd, pw, torch.from_numpy(qt),
                                           torch.from_numpy(mask) if masked else None, **shape)
        tiers = ref.encode_query_tiered(kws)
        want_t = ref_bm25.score_postings_topk_tiered(
            ref.offsets, ref.lengths, ref.postings_doc, ref.postings_weight,
            *(jnp.asarray(t) for t in tiers), jnp.asarray(mask) if masked else None,
            l_small=c.bm25_small_window, **shape)
        got_t = bm25.score_postings_topk_tiered(
            offs, lens, pd, pw, *(torch.from_numpy(t) for t in tiers),
            torch.from_numpy(mask) if masked else None, l_small=c.bm25_small_window, **shape)
        for (gi, gv), (wi, wv) in ((got, want), (got_t, want_t)):
            assert gi.shape == (12,)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gv.numpy().view(np.int32), np.asarray(wv).view(np.int32))


# ---------------------------------------------------------------- missing names


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("tq,d", [(32, 128), (256, 1024)])
def test_maxsim_scores_batch_matches_reference(store, tq, d):
    """B 3 x K 8 candidates of 16 doc tokens: one in eight invalid, two without doc
    tokens, and a query without unmasked tokens (its scores 0)."""
    rng = np.random.default_rng(8)
    b, k, td = 3, 8, 16
    docs = _unit(rng, (b, k, td, d))
    dmask = rng.random((b, k, td)) > 0.25
    dmask[0, 2] = False
    dmask[2, 5] = False
    valid = rng.random((b, k)) > 0.125
    valid[1, 0] = False
    q = _unit(rng, (b, tq, d))
    qmask = rng.random((b, tq)) > 0.3
    qmask[2] = False
    if store == "int8":
        doc_t = maxsim.quantize_tokens(torch.from_numpy(docs))
        doc_j = jnp.asarray(doc_t.numpy())
    else:
        doc_t = torch.from_numpy(docs).to(torch.bfloat16)
        doc_j = jnp.asarray(docs, jnp.bfloat16)
    want = np.asarray(ref_maxsim.maxsim_scores_batch(
        doc_j, jnp.asarray(dmask), jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(valid)))
    got = maxsim.maxsim_scores_batch(doc_t, torch.from_numpy(dmask), torch.from_numpy(q),
                                     torch.from_numpy(qmask), torch.from_numpy(valid)).numpy()
    assert got.shape == (b, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MAXSIM_ATOL, rtol=0)
    assert (got[~valid] == 0).all() and got[0, 2] == 0 and got[2, 5] == 0
    assert (got[2] == 0).all() and (got[0][valid[0] & dmask[0].any(-1)] > 0).any()


def test_maxsim_scores_batch_f32_tokens_round_as_the_reference():
    rng = np.random.default_rng(9)
    docs = _unit(rng, (2, 4, 8, 32))
    dmask = np.ones((2, 4, 8), bool)
    q = _unit(rng, (2, 5, 32))
    qmask = np.ones((2, 5), bool)
    valid = np.ones((2, 4), bool)
    want = np.asarray(ref_maxsim.maxsim_scores_batch(
        jnp.asarray(docs), jnp.asarray(dmask), jnp.asarray(q), jnp.asarray(qmask),
        jnp.asarray(valid)))
    got = maxsim.maxsim_scores_batch(*(torch.from_numpy(x) for x in (docs, dmask, q, qmask, valid)))
    np.testing.assert_allclose(got.numpy(), want, atol=MAXSIM_ATOL, rtol=0)


def test_chunk_scores_from_entities_batch_bit_equal():
    rng = np.random.default_rng(10)
    n, m, b, e = 700, 5, 6, 90
    ce = np.where(rng.random((n, m)) < 0.6, rng.integers(0, e, (n, m)), -1).astype(np.int32)
    ce[3] = -1  # a chunk without entities scores 0
    scores = np.where(rng.random((b, e)) < 0.3, rng.random((b, e)), 0.0).astype(np.float32)
    want = np.asarray(ref_graph.chunk_scores_from_entities_batch(jnp.asarray(ce), jnp.asarray(scores)))
    got = graph.chunk_scores_from_entities_batch(torch.from_numpy(ce), torch.from_numpy(scores))
    assert got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    for i in range(b):
        one = graph.chunk_scores_from_entities(torch.from_numpy(ce), torch.from_numpy(scores[i]))
        assert torch.equal(one, got[i])


def _forward_both(model, ref_model, ref_params, texts=("payment invoice", "fox habitat forest")):
    ids, mask = ref_enc.TextHasher(ref_enc.EncoderConfig(**TINY)).encode(list(texts))
    want = ref_model.apply(ref_params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_encoder_param_files_read_by_either_package(tmp_path):
    """A file the reference saves loads into the port's template, and a file the
    port saves loads into the reference's: the forwards agree to 1e-5."""
    ref_model, ref_params = ref_enc.init_encoder(ref_enc.EncoderConfig(**TINY), seed=1)
    ref_enc.save_encoder_params(ref_params, tmp_path / "ref.npz")
    template = enc.init_encoder(enc.EncoderConfig(**TINY), seed=2, device="cpu")
    got = enc.load_encoder_params(template, tmp_path / "ref.npz")
    assert got is template
    _forward_both(got, ref_model, ref_params)

    port_model = enc.init_encoder(enc.EncoderConfig(**TINY), seed=3, device="cpu")
    enc.save_encoder_params(port_model, tmp_path / "port.npz")
    _, fresh = ref_enc.init_encoder(ref_enc.EncoderConfig(**TINY), seed=4)
    restored = ref_enc.load_encoder_params(fresh, tmp_path / "port.npz")
    _forward_both(port_model, ref_model, restored)
    # a bare state dict needs the head count
    enc.save_encoder_params(port_model.state_dict(), tmp_path / "sd.npz", n_heads=TINY["n_heads"])
    with np.load(tmp_path / "sd.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[n], b[n]) for n in a.files)
    with pytest.raises(ValueError, match="n_heads"):
        enc.save_encoder_params(port_model.state_dict(), tmp_path / "x.npz")


def test_encoder_param_files_refuse_a_wrong_shape_or_a_missing_name(tmp_path):
    """As the reference's ``tests/test_encoder.py``: another width raises
    ValueError ("shape mismatch for ..."), another depth KeyError ("checkpoint
    missing parameter ..."), in both packages."""
    ref_model, ref_params = ref_enc.init_encoder(ref_enc.EncoderConfig(**TINY), seed=1)
    path = tmp_path / "enc.npz"
    ref_enc.save_encoder_params(ref_params, path)
    wide = enc.init_encoder(enc.EncoderConfig(**{**TINY, "d_model": 64}), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch for"):
        enc.load_encoder_params(wide, path)
    _, ref_wide = ref_enc.init_encoder(ref_enc.EncoderConfig(**{**TINY, "d_model": 64}))
    with pytest.raises(ValueError, match="shape mismatch for"):
        ref_enc.load_encoder_params(ref_wide, path)
    deep = enc.init_encoder(enc.EncoderConfig(**{**TINY, "n_layers": 2}), device="cpu")
    with pytest.raises(KeyError, match="checkpoint missing parameter"):
        enc.load_encoder_params(deep, path)
    _, ref_deep = ref_enc.init_encoder(ref_enc.EncoderConfig(**{**TINY, "n_layers": 2}))
    with pytest.raises(KeyError, match="checkpoint missing parameter"):
        ref_enc.load_encoder_params(ref_deep, path)


def test_encoder_embedder_takes_the_references_defaults():
    """``EncoderEmbedder()`` without a config or weights: the reference's default
    widths from the RAG config, and ``init_encoder``'s weights for ``seed``."""
    rag_cfg = RAGConfig(vocab_hash_buckets=512, embedding_dim_full=64, maxsim_dim=16)
    emb = enc.EncoderEmbedder(rag_cfg=rag_cfg, seed=5, device="cpu")
    want = ref_enc.EncoderEmbedder(rag_cfg=ref_enc.RAGConfig(
        vocab_hash_buckets=512, embedding_dim_full=64, maxsim_dim=16))
    assert emb.enc_cfg == enc.EncoderConfig(**{
        k: getattr(want.enc_cfg, k) for k in enc.EncoderConfig.__dataclass_fields__})
    again = enc.init_encoder(emb.enc_cfg, 5, device="cpu").cast_for_compute()
    for a, b in zip(emb.model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    assert emb.embed_texts(["payment invoice"]).shape == (1, 64)


def test_data_dir_holds_the_packaged_weights():
    assert pretrain.DATA_DIR.name == ref_pretrain.DATA_DIR.name == "data"
    assert pretrain.DATA_DIR.resolve() == ref_pretrain.DATA_DIR.resolve()
    assert pretrain.DEFAULT_PARAMS == pretrain.DATA_DIR / "encoder.npz"

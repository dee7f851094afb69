"""The port's Engine with the trained encoder against the JAX ShardedEngine at one device.

A tiny float32 encoder (the shape of ``tests/test_sharded.py``'s) is initialized in
flax and carried over with ``encoder_params_from_flax``; the JAX Retriever embeds the
``build_fixture`` corpus with it and the index arrays are carried over with
``IndexState.from_numpy``. Both engines then encode their queries with their own
encoder, on the device (``device_query_encode``, the default) or through the host
path. Ids and refusals must be equal and final and rerank scores agree within 1e-5,
except where the f16 query wire rounds the two packages' f32 query vectors (equal
within 1e-6) to different f16 neighbours: then the ids must still be equal and the
evidence is asserted (see :func:`_wire_split`).
"""

import numpy as np
import pytest

from triple_hybrid_rag_tpu.models.encoder import EncoderConfig, EncoderEmbedder
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh
from triple_hybrid_rag_tpu.retrieval import Retriever

from test_sharded import build_fixture
from torch_port_helpers import flat_params, state_from_retriever, torch_config
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.models import encoder as enc

TINY = dict(
    vocab_buckets=2048, d_model=32, n_layers=1, n_heads=4, d_mlp=64,
    max_tokens=16, out_dim=64, token_dim=16, dtype="float32",
)
QUERIES = [
    "payment invoice billing settlement",
    "fox wildlife forest habitat",
    "completely unrelated query text",
    "contract termination clause",
    "How do I reset my password?",
    "Who works for Acme Corp?",
]
ATOL = 1e-5


@pytest.fixture
def cfg(small_config):
    return small_config.replace(
        embedding_dtype="float32", safety_threshold=0.2, capacity_round=8,
        embedder_backend="encoder", graph_enabled=False,
    )


def engines(cfg, n_docs=12):
    """(ShardedEngine, Engine) over one corpus, each with the same encoder weights."""
    corpus, _ = build_fixture(cfg, n_docs=n_docs, with_graph=False)
    ref_emb = EncoderEmbedder(EncoderConfig(**TINY), cfg)
    ret = Retriever(corpus, cfg, embedder=ref_emb)
    tcfg = torch_config(cfg)
    port_emb = enc.EncoderEmbedder(
        enc.EncoderConfig(**TINY), tcfg,
        params=enc.encoder_params_from_flax(flat_params(ref_emb.params)), device="cpu",
    )
    eng = Engine(state_from_retriever(ret, tcfg), embedder=port_emb, device="cpu")
    return ShardedEngine(ret, single_device_mesh()), eng


def _wire_split(ref_eng, eng, queries) -> bool:
    """True when some query's f16 wire differs between the packages. Asserts why:
    the f32 vectors agree within 1e-6 and every differing f16 element is one f16
    step from the reference's (a value near a rounding midpoint)."""
    ref_vec = np.asarray(ref_eng.prepare_queries(queries)[1][5], np.float32)
    got = eng.prepare_queries(queries)[1].q_vec.float().numpy()
    ref_f32 = np.asarray(ref_eng.retriever.embedder.embed_texts(queries), np.float32)
    got_f32 = eng.embedder.embed_texts(queries)
    np.testing.assert_allclose(got_f32, ref_f32, atol=1e-6, rtol=0)
    diff = got != ref_vec
    if diff.any():
        step = np.abs(np.spacing(ref_vec.astype(np.float16)).astype(np.float32))
        assert (np.abs(got - ref_vec)[diff] <= step[diff] * 1.001).all()
    return bool(diff.any())


def _compare(ref, got, atol=ATOL):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert [x.chunk_id for x in r.results] == [x.chunk_id for x in g.results], r.query
        assert r.refused == g.refused, r.query
        for key in ("final_score", "rerank_score", "semantic_score"):
            np.testing.assert_allclose(
                [getattr(x, key) for x in g.results], [getattr(x, key) for x in r.results],
                atol=atol, rtol=0, err_msg=f"{r.query}: {key}",
            )
        np.testing.assert_allclose(g.max_score, r.max_score, atol=atol, rtol=0)


@pytest.mark.parametrize("device_encode", [True, False])
def test_encoder_engine_matches_sharded_engine(cfg, device_encode):
    ref_eng, eng = engines(cfg)
    assert ref_eng.device_query_encode is eng.device_query_encode is True
    ref_eng.device_query_encode = eng.device_query_encode = device_encode
    args = eng.prepare_queries(QUERIES)[1]
    assert args.q_vec.dtype == args.q_tokens.dtype == args.q_tok_mask.dtype
    assert tuple(args.q_tokens.shape) == (len(QUERIES), cfg.maxsim_query_tokens, cfg.maxsim_dim)
    # the wire rounds vectors equal within 1e-6: a different f16 neighbour moves the
    # dense and final scores by up to about one f16 step (5e-4 at 1.0)
    atol = 1e-3 if _wire_split(ref_eng, eng, QUERIES) else ATOL
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES), atol)
    for q in QUERIES:
        atol = 1e-3 if _wire_split(ref_eng, eng, [q]) else ATOL
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]), atol)


def test_device_query_encode_matches_host_prep(cfg):
    """The port of ``tests/test_sharded.py:274``: within the port, the device encode
    returns the results of the host path (embed_texts + token_embeddings)."""
    _, eng = engines(cfg)
    assert eng.device_query_encode is True
    dev = eng.retrieve_batch(QUERIES[:4])
    eng.device_query_encode = False
    host = eng.retrieve_batch(QUERIES[:4])
    for rd, rh in zip(dev, host):
        assert rd.refused == rh.refused
        assert [x.chunk_id for x in rd.results] == [x.chunk_id for x in rh.results]
        for a, b in zip(rd.results, rh.results):
            assert abs(a.final_score - b.final_score) < 2e-3


def test_retrieve_batch_retries_host_prep_on_device_failure(cfg):
    """The port of ``tests/test_sharded.py:437``: a failure surfacing while the
    outputs come back triggers one retry through the host path, then the device
    encode is restored."""
    _, eng = engines(cfg, n_docs=4)
    calls = {"n": 0, "device": []}
    orig = eng.search_arrays

    def flaky(queries, collections=None):
        calls["n"] += 1
        calls["device"].append(eng.device_query_encode)
        if calls["n"] == 1 and eng.device_query_encode:
            raise RuntimeError("simulated asynchronous device failure")
        return orig(queries, collections)

    eng.search_arrays = flaky
    out = eng.retrieve_batch(["payment invoice settlement"])
    assert calls["n"] == 2 and calls["device"] == [True, False]
    assert out[0].results
    assert eng.device_query_encode is True  # fast path restored after the retry

    def broken(queries, collections=None):
        raise RuntimeError("the host path fails too")

    eng.search_arrays = broken
    with pytest.raises(RuntimeError, match="host path"):
        eng.retrieve_batch(["payment invoice settlement"])
    assert eng.device_query_encode is True


def test_maxsim_calibration_comes_from_the_embedder(cfg):
    """The MaxSim rerank of an anchored encoder is divided by its calibration
    (anchor_token_w2 = 0.6), fixed when the engine is built, whatever the index
    state was built from: the state carries no calibration, as a synthetic corpus's
    does not either."""
    ref_eng, eng = engines(cfg)
    assert eng.maxsim_calibration == ref_eng.retriever.embedder.maxsim_calibration == 0.6
    assert not hasattr(eng.state, "maxsim_calibration")
    eng.device_query_encode = ref_eng.device_query_encode = False
    ref = ref_eng.retrieve_batch(QUERIES)
    got = eng.retrieve_batch(QUERIES)
    _compare(ref, got)
    # uncalibrated (1.0, what the engine used for such a state before) the rerank
    # falls by up to 0.40 and the ids change
    eng.maxsim_calibration = 1.0
    stale = eng.retrieve_batch(QUERIES)
    assert any([x.chunk_id for x in r.results] != [x.chunk_id for x in s.results]
               for r, s in zip(ref, stale))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dot_rerank_matches_sharded_engine(cfg, dtype):
    """rerank_backend="dot": cosine against the parents' mean embeddings (the
    reference reranker's parent_embeddings, carried over)."""
    c = cfg.replace(rerank_backend="dot", embedding_dtype=dtype, embedder_backend="bowhash",
                    graph_enabled=True)
    corpus, gidx = build_fixture(c, with_graph=True)
    ret = Retriever(corpus, c, graph_index=gidx)
    assert ret.maxsim_index is None and ret.reranker.parent_embeddings is not None
    st = state_from_retriever(ret)
    assert st.maxsim_tokens is None and st.parent_emb is not None
    np.testing.assert_array_equal(st.parent_emb.numpy(), np.asarray(ret.reranker.parent_embeddings))
    assert st.nbytes()["parent_emb"] == np.asarray(ret.reranker.parent_embeddings).nbytes
    ref_eng = ShardedEngine(ret, single_device_mesh())
    eng = Engine(st, device="cpu")
    _compare(ref_eng.retrieve_batch(QUERIES), eng.retrieve_batch(QUERIES))
    for q in QUERIES:
        _compare(ref_eng.retrieve_batch([q]), eng.retrieve_batch([q]))
    scores = [x.rerank_score for r in eng.retrieve_batch(QUERIES) for x in r.results]
    assert scores and all(0.0 <= s <= 1.0 for s in scores) and len(set(scores)) > 1
    assert eng.refresh(state_from_retriever(ret))
    no_dot = state_from_retriever(ret)
    no_dot.parent_emb = None
    assert not eng.refresh(no_dot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_build_parent_embeddings_matches_reference(cfg, dtype):
    """retrieval.build_parent_embeddings: dequantized rows, segment mean per parent,
    L2-normalized, within 1e-6 of the reference's (f32 sums in another order)."""
    from triple_hybrid_rag_tpu_torch.index.state import _to_tensor
    from triple_hybrid_rag_tpu_torch.retrieval import build_parent_embeddings

    c = cfg.replace(rerank_backend="dot", embedding_dtype=dtype, embedder_backend="bowhash")
    corpus, _ = build_fixture(c, with_graph=False)
    ret = Retriever(corpus, c)
    dx = ret.dense_index
    scales = None if dx.scales is None else _to_tensor(np.asarray(dx.scales), "cpu")
    p_pad = c.round_capacity(max(corpus.n_parents, 1))
    got = build_parent_embeddings(
        _to_tensor(np.asarray(dx.embeddings), "cpu"), scales, corpus.parent_rows(), p_pad
    )
    want = np.asarray(ret.reranker.parent_embeddings)
    assert got.shape == want.shape and got.dtype.is_floating_point
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

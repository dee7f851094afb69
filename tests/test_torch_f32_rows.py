"""f32 rows in the port: the synthetic float32 configuration, the query-tile width
of the f32-row kernel bodies, and their plain versions against the Pallas kernels
in interpret mode at ragged shapes (more than 128 queries, widths that are not a
multiple of the kernels' 16-column stage).

Unit rows: scores agree within 1e-5 (f32 sums of the same f32 products in another
order). The CUDA bodies themselves are held against the plain versions on the card
by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.ops.pallas import dense_scores_pallas
from triple_hybrid_rag_tpu.ops.pallas.fused_topk import bucket_maxima_pallas
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.kernels.build import F32_QUERY_TILES, f32_query_tile
from triple_hybrid_rag_tpu_torch.ops import dense_kernel, fused_topk

# (n, d, b): one row, rows short of a bucket, odd n; one query, 17 (the wide tile),
# more than one tile of 128; widths of 8, 72 and 1028 (not a multiple of 16)
F32_EDGE_SHAPES = [(1, 8, 1), (15, 72, 5), (333, 1028, 17), (257, 72, 130), (100, 16, 257)]


def _unit_rows(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.mark.parametrize("b,width", [(1, 16), (16, 16), (17, 128), (128, 128), (129, 128)])
def test_f32_query_tile(b, width):
    assert f32_query_tile(b) == width
    assert width in F32_QUERY_TILES


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("n,d,b", F32_EDGE_SHAPES)
def test_f32_bucket_maxima_edge_shapes(rng, n, d, b, scoped):
    mat = _unit_rows(rng, n, d)
    q = _unit_rows(rng, b, d)
    valid = rng.random(n) > 0.1
    coll = rng.integers(0, 3, n).astype(np.int32)
    cid = np.resize(np.array([-1, 0, 1, 2, -2], np.int32), b)
    # the Pallas kernel takes whole blocks of rows: pad with masked rows
    n_pad = -(-n // 512) * 512
    mat_p = np.zeros((n_pad, d), np.float32)
    mat_p[:n] = mat
    addmask = np.full((1, n_pad), -np.inf, np.float32)
    addmask[0, :n] = np.where(valid, 0.0, -np.inf)
    extra = {}
    if scoped:
        coll_p = np.zeros(n_pad, np.int32)
        coll_p[:n] = coll
        extra = dict(collection_of=jnp.asarray(coll_p)[None, :], coll_cid=jnp.asarray(cid)[None, :])
    want = np.asarray(bucket_maxima_pallas(
        jnp.asarray(mat_p), jnp.asarray(q), jnp.asarray(addmask), block=512, bucket=16,
        interpret=True, **extra))[:, : -(-n // 16)]
    c, k = (torch.from_numpy(coll), torch.from_numpy(cid)) if scoped else (None, None)
    got = fused_topk.bucket_maxima(torch.from_numpy(mat), torch.from_numpy(q),
                                   torch.from_numpy(valid), c, k)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(want), torch.isinf(got).numpy())
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=1e-5, rtol=0)
    if scoped:
        assert np.all(np.isinf(want[cid == -2]))  # cid -2 matches nothing


@pytest.mark.parametrize("n,d,b", F32_EDGE_SHAPES)
def test_f32_dense_scores_edge_shapes(rng, n, d, b):
    mat = _unit_rows(rng, n, d)
    q = _unit_rows(rng, b, d)
    want = np.asarray(dense_scores_pallas(jnp.asarray(mat), jnp.asarray(q), interpret=True))
    got = dense_kernel.dense_scores(torch.from_numpy(mat), torch.from_numpy(q))
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), q.astype(np.float64) @ mat.astype(np.float64).T,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 6), (torch.float32, 2), (torch.bfloat16, 12)])
def test_dense_scores_launch_rejects_partial_chunks(dtype, d):
    """The kernels copy 16-byte chunks of a row: a row of another size raises
    before anything is built."""
    with pytest.raises(ValueError, match="16 bytes"):
        dense_kernel._launch_dense_scores(torch.zeros((4, d), dtype=dtype), torch.zeros((2, d)))


def _synthetic(dtype):
    from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic

    n, dim, n_ent = 2048, 64, 200
    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=dim, embedding_dim_full=dim, embedding_dtype=dtype,
        maxsim_doc_tokens=16, maxsim_dim=32, maxsim_query_tokens=8, safety_threshold=0.0,
        graph_max_entities_per_chunk=4, lexical_backend="sorted", bm25_df_cap=256,
        embedder_backend="bowhash",
    )
    return cfg, build_synthetic(cfg, n, dim, n_ent, seed=0, device="cpu")


def test_synthetic_float32_rows():
    """Under float32 the synthetic rows stay unrounded unit vectors whose bf16
    rounding is the bf16 configuration's rows; every other layout is the same."""
    _, syn = _synthetic("float32")
    _, ref = _synthetic("bfloat16")
    st, rs = syn.state, ref.state
    assert st.embeddings.dtype == torch.float32 and rs.embeddings.dtype == torch.bfloat16
    assert torch.equal(st.embeddings.to(torch.bfloat16), rs.embeddings)
    live = st.embeddings[st.valid]
    np.testing.assert_allclose(live.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert not torch.equal(live, live.to(torch.bfloat16).float())  # full mantissas
    assert st.nbytes()["embeddings"] >= 2 * rs.nbytes()["embeddings"] - rs.valid.numel()
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(rs, f.name)
        if f.name != "embeddings" and isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(syn.term_ids, ref.term_ids)


def test_synthetic_float32_self_retrieval():
    """The float32 configuration finds each plain query's own row through both
    dense paths (the f32 bucket maxima's plain version, and the bucketed top-k
    over the f32 matmul), and the two return the same ids."""
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.synthetic import make_query_texts

    cfg, syn = _synthetic("float32")
    rng = np.random.default_rng(11)
    rows = rng.integers(0, syn.n // 5, size=48) * 5
    texts, _ = make_query_texts(rows, syn.term_ids, rng, 0.0, syn.n_entities)
    ids = []
    for fused in (True, False):
        eng = Engine(syn.state, config=cfg.replace(use_fused_topk=fused), embedder=syn.embedder,
                     device="cpu")
        assert eng.use_fused() == fused
        ids.append(eng.search_arrays(texts)[1][0].numpy())
        assert np.mean([rows[i] in ids[-1][i] for i in range(len(rows))]) >= 0.95
    np.testing.assert_array_equal(ids[0], ids[1])

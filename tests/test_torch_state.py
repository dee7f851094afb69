"""The port's MaxSim token store as the index state places it: an int8 store stays
int8 (the reference's storage under int8 and int4 dense rows, dequantized only as
candidates are scored), float stores are scored in bf16, and the synthetic corpus
stores its tokens as ``bench.py`` does."""

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.index.maxsim_index import _pack_tokens
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.index.state import IndexState
from triple_hybrid_rag_tpu_torch.ops.maxsim import dequantize_tokens, quantize_tokens


def _tokens(rng, dtype):
    x = rng.standard_normal((6, 4, 8)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    t = torch.from_numpy(x)
    return quantize_tokens(t) if dtype == torch.int8 else t.to(dtype)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_from_tensors_token_store(rng, dtype):
    tokens = _tokens(rng, dtype)
    mask = torch.ones((6, 4), dtype=torch.bool)
    st = IndexState.from_tensors(
        {"parent_of": torch.arange(6, dtype=torch.int32), "maxsim_tokens": tokens,
         "maxsim_mask": mask},
        {}, RAGConfig(), "cpu",
    )
    if dtype == torch.float32:  # rounded to bf16, as the reference's kernel path rounds it
        assert st.maxsim_tokens.dtype == torch.bfloat16
        assert torch.equal(st.maxsim_tokens, tokens.to(torch.bfloat16))
    else:  # placed as given: no widened copy of an int8 store
        assert st.maxsim_tokens.dtype == dtype
        assert st.maxsim_tokens.data_ptr() == tokens.data_ptr()
    assert st.nbytes()["maxsim"] == st.maxsim_tokens.numel() * st.maxsim_tokens.element_size() + 24


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_synthetic_int8_token_store(dtype):
    """Under int8 and int4 rows the synthetic store holds the reference rule's int8
    tokens of the same directions as the bf16 store, at half its bytes; the program
    still finds each query's own row."""
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, make_query_texts

    n, dim, n_ent = 2048, 64, 200
    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=dim, embedding_dim_full=dim, embedding_dtype=dtype,
        maxsim_doc_tokens=16, maxsim_dim=32, maxsim_query_tokens=8, safety_threshold=0.0,
        graph_max_entities_per_chunk=4, lexical_backend="sorted", bm25_df_cap=256,
        embedder_backend="bowhash",
    )
    syn = build_synthetic(cfg, n, dim, n_ent, seed=0, device="cpu")
    ref = build_synthetic(cfg.replace(embedding_dtype="bfloat16"), n, dim, n_ent, seed=0,
                          device="cpu").state
    st = syn.state
    assert st.maxsim_tokens.dtype == torch.int8 and ref.maxsim_tokens.dtype == torch.bfloat16
    assert 2 * st.maxsim_tokens.nbytes == ref.maxsim_tokens.nbytes
    # the same f16 directions under the reference's int8 rule: within one step of 1/127
    # (plus the bf16 store's own rounding) of the bf16 store
    deq = dequantize_tokens(st.maxsim_tokens).float()
    assert float((deq - ref.maxsim_tokens.float()).abs().max()) <= 0.5 / 127 + 2 ** -8
    np.testing.assert_array_equal(
        st.maxsim_tokens.numpy(), _pack_tokens(st.maxsim_tokens.numpy() / 127.0, dtype))
    eng = Engine(st, embedder=syn.embedder, device="cpu")
    rng = np.random.default_rng(7)
    rows = rng.integers(0, n // 5, size=64) * 5
    texts, is_graph = make_query_texts(rows, syn.term_ids, rng, 0.0, n_ent)
    ids = eng.search_arrays(texts)[1][0].numpy()
    assert np.mean([rows[i] in ids[i] for i in range(len(rows))]) >= 0.95

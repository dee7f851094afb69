"""The BowHash draw kernel (``csrc/bowhash.cu``) on the card.

Marked ``card``: each test skips without a CUDA card. No JAX is imported, so on
the card the file runs without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_bowhash_card.py

The kernel's f32 draws equal numpy's bit for bit; a batch's query vectors and
MaxSim tokens equal the host path's within one f16 step, with the same occupancy
and token weights; ``Engine.retrieve_batch`` returns the same ids either way.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
from triple_hybrid_rag_tpu_torch.observability.metrics import rag_metrics
from triple_hybrid_rag_tpu_torch.ops.bowhash import MAX_POOL_DIM, bowhash_encode
from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, encode_rows, make_query_texts

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def hash_seed(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode("utf-8")).digest()[:8], "little")


def f16_steps(a: np.ndarray, b: np.ndarray) -> int:
    def line(x):
        i = np.ascontiguousarray(x, np.float16).view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return int(np.abs(line(a) - line(b)).max()) if a.size else 0


def drawn(seeds, n_tok: int, dim_tok: int, dim_m: int, dev):
    """The kernel's raw f32 draws of ``seeds`` (the first ``n_tok`` at ``dim_tok``, the
    rest at ``dim_m``) through ``bowhash_encode``, over one query of no tokens."""
    s = torch.from_numpy(np.array(seeds, np.uint64).view(np.int64)).to(dev)
    draws = (torch.empty((n_tok, dim_tok), dtype=torch.float32, device=dev),
             torch.empty((len(seeds) - n_tok, dim_m), dtype=torch.float32, device=dev))
    none = torch.full((1, 1), -1, dtype=torch.int32, device=dev)
    bowhash_encode(s, n_tok, dim_tok, dim_m, none, none, dim_tok, draws=draws)
    return draws[0].cpu().numpy(), draws[1].cpu().numpy()


def numpy_rows(seeds, dim):
    return np.stack([np.random.default_rng(s).standard_normal(dim).astype(np.float32)
                     for s in seeds])


@pytest.mark.parametrize("kind,dim,n", [("tok", 2048, 6000), ("mtok", 128, 6000)])
def test_draws_equal_numpy(card, kind, dim, n):
    """12,000 streams (and seeds of one entropy word): every f32 draw of the kernel
    equals ``default_rng(seed).standard_normal(dim).astype(np.float32)``."""
    prefix = "tok\x00" if kind == "tok" else f"mtok{dim}\x00"
    seeds = [hash_seed(f"{prefix}t{i:06d}") for i in range(n)] + [0, 1, 2**32 - 1, 2**32, 2**64 - 1]
    n_tok = len(seeds) if kind == "tok" else 0
    got_tok, got_m = drawn(seeds, n_tok, dim, dim, card)
    got = got_tok if kind == "tok" else got_m
    assert np.array_equal(got.view(np.uint32), numpy_rows(seeds, dim).view(np.uint32))


def test_widest_pool_launches(card):
    """At the widest dense width the pool's shared memory allows (``MAX_POOL_DIM``)
    the kernel launches, and its draws and pooled vectors equal the plain
    version's (the vectors within one f16 step)."""
    seeds = [hash_seed(f"tok\x00w{i}") for i in range(3)] + [hash_seed("mtok128\x00w")]
    idx = torch.tensor([[0, 1, 2], [2, -1, -1]], dtype=torch.int32)
    midx = torch.tensor([[0, -1], [-1, -1]], dtype=torch.int32)  # MaxSim streams count from 0
    s = torch.from_numpy(np.array(seeds, np.uint64).view(np.int64))
    args = (3, MAX_POOL_DIM, 128)
    launches = bowhash_encode.launches
    got = bowhash_encode(s.to(card), *args, idx.to(card), midx.to(card), 1024)
    assert bowhash_encode.launches == launches + 1
    want = bowhash_encode(s, *args, idx, midx, 1024)
    for g, w in zip(got, want):
        assert f16_steps(g.cpu().numpy(), w.numpy()) <= 1


def traffic_texts(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        terms = " ".join(f"t{int(t):06d}" for t in rng.integers(0, 65536, size=6))
        out.append(f"How is entity {i} related to entity {i + 1}? {terms}" if i % 3 == 0 else terms)
    return out


def test_encode_matches_the_host_path(card):
    """A batch of 128 at the default widths (2,048 cut to 1,024; MaxSim 32 x 128):
    the engine's query arrays with the device encode and through the host path are
    within one f16 step, the token weights equal; one launch, its streams counted."""
    cfg = RAGConfig(capacity_round=1024, bm25_df_cap=256, embedder_backend="bowhash")
    syn = build_synthetic(cfg, 4096, cfg.embedding_dim, 300, seed=0, device=card)
    eng = Engine(syn.state, config=cfg,
                 embedder=BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg), device=card)
    texts = traffic_texts(128)
    launches = bowhash_encode.launches
    streams = rag_metrics.counter("bowhash_device_streams_total").value()
    _, dev = eng.prepare_queries(texts)
    torch.cuda.synchronize()
    assert bowhash_encode.launches == launches + 1
    assert rag_metrics.counter("bowhash_device_streams_total").value() > streams
    eng.device_query_encode = False
    _, host = eng.prepare_queries(texts)
    assert dev.q_vec.shape == host.q_vec.shape and dev.q_tokens.shape == host.q_tokens.shape
    assert f16_steps(dev.q_vec.cpu().numpy(), host.q_vec.cpu().numpy()) <= 1
    assert f16_steps(dev.q_tokens.cpu().numpy(), host.q_tokens.cpu().numpy()) <= 1
    assert torch.equal(dev.q_tok_mask.cpu(), host.q_tok_mask.cpu())


def test_retrieve_batch_same_ids(card):
    """``Engine.retrieve_batch`` over a small corpus: the same ids with the device
    encode on and off, scores within 1e-5; with it on, the kernel launched once
    and no batch went through the host encode."""
    cfg = RAGConfig(capacity_round=1024, bm25_df_cap=256, graph_max_entities_per_chunk=4,
                    embedder_backend="bowhash")
    syn = build_synthetic(cfg, 4096, cfg.embedding_dim, 300, seed=0, device=card)
    emb = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    rows = np.arange(0, 256, 2)
    encode_rows(syn.state, rows, emb, syn.state.corpus.text_of)
    texts, _ = make_query_texts(rows, syn.term_ids, np.random.default_rng(0), 0.3, 300)
    eng = Engine(syn.state, config=cfg, embedder=emb, device=card)
    device_batches = rag_metrics.counter("query_encode_device_batches_total")
    host_batches = rag_metrics.counter("query_encode_host_batches_total")
    before = (device_batches.value(), host_batches.value(), bowhash_encode.launches)
    on = eng.retrieve_batch(texts)
    assert (device_batches.value(), host_batches.value(), bowhash_encode.launches) == (
        before[0] + 1, before[1], before[2] + 1)
    eng.device_query_encode = False
    off = eng.retrieve_batch(texts)
    for a, b in zip(on, off):
        assert a.refused == b.refused
        assert [r.chunk_id for r in a.results] == [r.chunk_id for r in b.results]
        for x, y in zip(a.results, b.results):
            assert abs(x.final_score - y.final_score) <= 1e-5
            assert abs(x.semantic_score - y.semantic_score) <= 1e-5

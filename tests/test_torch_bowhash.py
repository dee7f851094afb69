"""The BowHash query encode of the batched engine, on the CPU.

The card draws each distinct token's direction with ``csrc/bowhash.cu``; its
arithmetic is :func:`ops.bowhash.draw_plain` (SeedSequence, PCG64 and numpy's
ziggurat over the committed tables), held here to numpy's own generator bit for
bit, every path of the ziggurat included. The plain encode (the kernel's pooling,
in numpy) is held to the host path, and an engine on the CPU keeps the host path:
its query arrays are today's, bit for bit, and its counters read host. The same
checks on the card are in ``test_torch_bowhash_card.py``. No JAX here.
"""

from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.index.dense_index import truncate_matryoshka
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
from triple_hybrid_rag_tpu_torch.observability.metrics import rag_metrics
from triple_hybrid_rag_tpu_torch.ops.bowhash import (
    MAX_POOL_DIM,
    bowhash_encode,
    draw_plain,
    ziggurat_tables,
)
from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, encode_rows, make_query_texts

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("query_encode_device_batches_total", "query_encode_host_batches_total",
            "bowhash_device_streams_total")


def hash_seed(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode("utf-8")).digest()[:8], "little")


def numpy_rows(seeds, dim):
    return np.stack([np.random.default_rng(int(s)).standard_normal(dim).astype(np.float32)
                     for s in seeds])


def f16_steps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance between two f16 arrays in steps of f16's grid (the
    bits as an ordered integer line)."""
    def line(x):
        i = np.ascontiguousarray(x, np.float16).view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return int(np.abs(line(a) - line(b)).max()) if a.size else 0


def counts():
    return {k: rag_metrics.counter(k).value() for k in COUNTERS}


@pytest.mark.parametrize("kind,dim", [("tok", 2048), ("mtok", 128)])
def test_draws_equal_numpy_bit_for_bit(kind, dim):
    """2,000 keys of each kind at its width: every f32 draw equals numpy's, and the
    streams went through the ziggurat's tail, its wedge and its rejections."""
    prefix = "tok\x00" if kind == "tok" else f"mtok{dim}\x00"
    seeds = [hash_seed(f"{prefix}t{i:06d}") for i in range(2000)]
    got, paths = draw_plain(seeds, dim)
    want = numpy_rows(seeds, dim)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert paths["tail"] > 0 and paths["wedge"] > 0 and paths["rejected"] > 0, paths
    assert paths["fast"] + paths["wedge"] + paths["tail"] == len(seeds) * dim


def test_draws_of_seeds_below_two_to_the_32():
    """Seeds of one 32-bit entropy word (0 among them), at the edges of the second
    word and of the 64 bits."""
    seeds = [0, 1, 2, 7, 12345, 2**31, 2**32 - 1, 2**32, 2**32 + 1, 2**63, 2**64 - 1]
    seeds += list(np.random.default_rng(5).integers(0, 2**32, size=200, dtype=np.uint64))
    got, _ = draw_plain(seeds, 256)
    assert np.array_equal(got.view(np.uint32), numpy_rows(seeds, 256).view(np.uint32))


def test_committed_tables_equal_this_numpy():
    """The header the kernel compiles equals the installed numpy's tables
    (``scripts/extract_ziggurat_tables.py --check``), and its first entries are
    numpy's documented constants."""
    spec = importlib.util.spec_from_file_location(
        "extract_ziggurat_tables", ROOT / "scripts" / "extract_ziggurat_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod.read_tables()
    have = ziggurat_tables()
    for src, dst in mod.TABLES.items():
        assert have[dst].tolist() == want[src]
    assert have["kZigWiBits"].view(np.float64)[0] == pytest.approx(8.68362706080130616677e-16)
    assert have["kZigFiBits"].view(np.float64)[0] == 1.0


def traffic_texts(n: int, seed: int = 0):
    """Texts shaped as the benchmark's: six terms, or a relation question."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        terms = " ".join(f"t{int(t):06d}" for t in rng.integers(0, 65536, size=6))
        out.append(f"How is entity {i} related to entity {i + 1}? {terms}" if i % 3 == 0 else terms)
    return out + ["", "the of and"]


def test_plain_encode_matches_the_host_path():
    """``encode_queries_device`` through the plain version (CPU): the f16 query
    vectors and MaxSim tokens of ``embed_texts`` + ``truncate_matryoshka`` and
    ``token_embeddings`` within one f16 step, the occupancy equal."""
    cfg = RAGConfig()
    emb = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    texts = traffic_texts(24)
    pooled, tok, occupied = emb.encode_queries_device(
        texts, out_dim=cfg.embedding_dim, max_tokens=cfg.maxsim_query_tokens,
        token_dim=cfg.maxsim_dim, device="cpu")
    host_vec = truncate_matryoshka(emb.embed_texts(texts), cfg.embedding_dim).astype(np.float16)
    host_tok = emb.token_embeddings(texts, max_tokens=cfg.maxsim_query_tokens, dim=cfg.maxsim_dim)
    assert pooled.dtype == tok.dtype == torch.float16
    assert tok.shape == (len(texts), cfg.maxsim_query_tokens, cfg.maxsim_dim)
    assert f16_steps(pooled.numpy(), host_vec) <= 1
    assert f16_steps(tok.numpy(), host_tok.astype(np.float16)) <= 1
    assert np.array_equal(occupied, np.any(host_tok != 0, axis=-1))
    assert not pooled[-2].any() and not occupied[-2].any()  # no tokens: a zero vector


SMALL = dict(capacity_round=1024, graph_max_entities_per_chunk=4, bm25_df_cap=256,
             embedding_dim=64, embedding_dim_full=128, maxsim_dim=32, maxsim_doc_tokens=16,
             maxsim_query_tokens=8, embedder_backend="bowhash")


@pytest.fixture(scope="module")
def small_engine():
    cfg = RAGConfig(**SMALL)
    syn = build_synthetic(cfg, 2048, cfg.embedding_dim, 200, seed=0, device="cpu")
    emb = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    rows = np.arange(0, 96, 3)
    encode_rows(syn.state, rows, emb, syn.state.corpus.text_of)
    texts, _ = make_query_texts(rows, syn.term_ids, np.random.default_rng(0), 0.3, 200)
    return Engine(syn.state, config=cfg, embedder=emb, device="cpu"), texts


def test_cpu_engine_keeps_the_host_encode(small_engine, monkeypatch):
    """An engine on the CPU never takes the BowHash device encode: its query arrays
    equal the host path's bit for bit, and the counters read host."""
    eng, texts = small_engine
    cfg = eng.config

    def refuse(*a, **k):
        raise AssertionError("the device encode ran on a CPU engine")

    monkeypatch.setattr(eng.embedder, "encode_queries_device", refuse)
    before = counts()
    plans, args = eng.prepare_queries(texts)
    after = counts()
    assert after[COUNTERS[0]] == before[COUNTERS[0]]
    assert after[COUNTERS[1]] == before[COUNTERS[1]] + 1
    assert after[COUNTERS[2]] == before[COUNTERS[2]]
    sem = [p.semantic_query_text or p.original_query for p in plans]
    want_vec = truncate_matryoshka(eng.embedder.embed_texts(sem), cfg.embedding_dim)
    want_tok = eng.embedder.token_embeddings(sem, max_tokens=cfg.maxsim_query_tokens,
                                             dim=cfg.maxsim_dim)
    want_w = eng._token_weights(np.any(want_tok != 0, axis=-1), sem)
    assert np.array_equal(args.q_vec.numpy(), want_vec.astype(np.float16))
    assert np.array_equal(args.q_tokens.numpy(), want_tok.astype(np.float16))
    assert np.array_equal(args.q_tok_mask.numpy(), want_w)


class CpuDrawBowHash(BowHashEmbedder):
    """BowHash whose device encode an engine on the CPU takes (the plain version)."""

    device_encode_types = ("cpu", "cuda")


def test_device_branch_through_the_plain_version(small_engine):
    """With the device encode allowed on the CPU, the engine's device branch (the
    packed copy, the plain draws and pooling) returns the host path's answers, and
    the counters read device."""
    eng, texts = small_engine
    dev_eng = Engine(eng.state, config=eng.config,
                     embedder=CpuDrawBowHash(dim=eng.config.embedding_dim_full, config=eng.config),
                     device="cpu")
    before = counts()
    _, dev_args = dev_eng.prepare_queries(texts)
    after = counts()
    assert after[COUNTERS[0]] == before[COUNTERS[0]] + 1
    assert after[COUNTERS[1]] == before[COUNTERS[1]]
    assert after[COUNTERS[2]] == before[COUNTERS[2]]  # no stream drawn on a card
    _, host_args = eng.prepare_queries(texts)
    assert f16_steps(dev_args.q_vec.numpy(), host_args.q_vec.numpy()) <= 1
    assert f16_steps(dev_args.q_tokens.numpy(), host_args.q_tokens.numpy()) <= 1
    assert np.array_equal(dev_args.q_tok_mask.numpy(), host_args.q_tok_mask.numpy())
    got, want = dev_eng.retrieve_batch(texts), eng.retrieve_batch(texts)
    for g, w in zip(got, want):
        assert [r.chunk_id for r in g.results] == [r.chunk_id for r in w.results]
        assert all(abs(a.final_score - b.final_score) < 1e-3 for a, b in zip(g.results, w.results))


def test_encode_writes_its_draws_and_checks_the_widths():
    """``bowhash_encode``'s ``draws`` receive the raw draws (numpy's, bit for bit);
    a dense width past the pool's shared memory, or draws of the wrong shape, raise
    before any launch."""
    seeds = [hash_seed(f"tok\x00d{i}") for i in range(3)] + [hash_seed("mtok32\x00d")]
    s = torch.from_numpy(np.array(seeds, np.uint64).view(np.int64))
    idx = torch.tensor([[0, 1, 2], [1, -1, -1]], dtype=torch.int32)
    midx = torch.tensor([[0, -1], [-1, -1]], dtype=torch.int32)  # MaxSim streams count from 0
    draws = (torch.empty((3, 64), dtype=torch.float32), torch.empty((1, 32), dtype=torch.float32))
    q_vec, q_tok = bowhash_encode(s, 3, 64, 32, idx, midx, 48, draws=draws)
    assert np.array_equal(draws[0].numpy().view(np.uint32), numpy_rows(seeds[:3], 64).view(np.uint32))
    assert np.array_equal(draws[1].numpy().view(np.uint32), numpy_rows(seeds[3:], 32).view(np.uint32))
    assert q_vec.shape == (2, 48) and q_tok.shape == (2, 2, 32)
    with pytest.raises(ValueError, match="draws"):
        bowhash_encode(s, 3, 64, 32, idx, midx, 48, draws=(draws[1], draws[0]))
    assert MAX_POOL_DIM * 4 + 64 == 48 * 1024  # the pool's sum beside its f64 scratch
    with pytest.raises(ValueError, match="widths"):
        bowhash_encode(s, 3, MAX_POOL_DIM + 1, 32, idx, midx, 48)


def test_a_failing_bowhash_encode_raises(small_engine, monkeypatch):
    """A failure of BowHash's device encode (the kernel's build or launch) raises
    from ``retrieve_batch``: no retry through the host, and neither counter moves."""
    eng, texts = small_engine
    dev_eng = Engine(eng.state, config=eng.config,
                     embedder=CpuDrawBowHash(dim=eng.config.embedding_dim_full, config=eng.config),
                     device="cpu")

    def broken(*a, **k):
        raise RuntimeError("bowhash_encode: launch failed")

    monkeypatch.setattr(dev_eng.embedder, "encode_queries_device", broken)
    before = counts()
    with pytest.raises(RuntimeError, match="bowhash_encode"):
        dev_eng.retrieve_batch(texts)
    assert counts() == before
    assert dev_eng.device_query_encode is True

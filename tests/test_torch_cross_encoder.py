"""The on-device cross-encoder reranker (``models/cross_encoder.py``) against the plain
reference of the benchmark (``perfbench/reference/models/moonlight.py``), on seeded
random weights at a small size on the CPU: hidden 64, layer 0 dense then 3 expert
layers of 8 routed experts (top 2) and 1 shared, latent rank 16, rotary 8, key 16,
value 16 wide, 4 heads, vocabulary 512.

Tolerances, each with its reading at the seed here:

* f32 weights and activations: every position's logits within 1e-5 (reads 1.8e-7;
  the two differ only in the order of float32 sums);
* bf16 (weights and GEMMs; the residual stream f32): every position's logits within
  1e-2 of the reference on the same bf16-rounded weights (reads 2.1e-3), a bound the
  e4m3 weights of the control exceed (read 2.6e-2);
* prompts packed and padded together against each alone: within 1e-5 (read 1.8e-7).

Then the staged path: ``Retriever.from_state`` over a placed synthetic corpus with
``rerank_backend="cross_encoder"`` returns the plain reference pipeline's answers;
``Retriever`` and ``RAG`` tokenize an ingested corpus's parents into the store; the
batched ``Engine`` refuses the backend.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.lib import prompts as bench_prompts
from perfbench.reference.models import moonlight as plain
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.models import cross_encoder as X

SEED = 2147483999
TINY = dict(plain.PUBLISHED, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, vocab_size=512)
CFG = X.CrossEncoderConfig.from_hf(TINY)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 512, size=n).tolist() for n in (7, 13, 1, 20)]


def reference_logits(prompts, bf16_weights):
    ref = plain.Plain(TINY, SEED, "cpu", bf16_weights=bf16_weights)
    return torch.cat([ref.logits(p) for p in prompts])


def test_preset_is_the_published_config():
    assert X.PRESETS["moonlight-16b-a3b"] == X.CrossEncoderConfig.from_hf(plain.PUBLISHED)
    assert X.PRESETS["moonlight-16b-a3b"].qk_head_dim == 192
    with pytest.raises(ValueError):
        X.CrossEncoderConfig.from_hf(dict(plain.PUBLISHED, q_lora_rank=1536))


def test_forward_f32_matches_plain_reference(prompts):
    m = X.init_cross_encoder(CFG, SEED, "cpu", dtype=torch.float32)
    got = m.logits(X.pack(prompts, "cpu"))
    want = reference_logits(prompts, bf16_weights=False)
    assert got.shape == (sum(map(len, prompts)), 512)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("weight_dtype, within", [("bfloat16", True), ("float8_e4m3fn", False)])
def test_forward_bf16_tolerance_and_fp8_control(prompts, weight_dtype, within):
    m = X.init_cross_encoder(CFG, SEED, "cpu", weight_dtype=weight_dtype)
    gap = (m.logits(X.pack(prompts, "cpu")) - reference_logits(prompts, bf16_weights=True)).abs().max().item()
    assert (gap <= 1e-2) == within, gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_prompts_equal_one_prompt_forward_passes(prompts, dtype):
    m = X.init_cross_encoder(CFG, SEED, "cpu", dtype=dtype)
    packed = m.logits(X.pack(prompts, "cpu"))
    alone = torch.cat([m.logits(X.pack([p], "cpu")) for p in prompts])
    assert (packed - alone).abs().max().item() <= 1e-5
    p = m.yes_probability(X.pack(prompts, "cpu"))
    last = np.cumsum([len(q) for q in prompts]) - 1
    want = torch.softmax(packed[last][:, [X.YES_ID, X.NO_ID]], dim=-1)[:, 0]
    assert torch.allclose(p, want, atol=1e-6)


def test_router_selects_on_biased_scores_and_weights_by_unbiased():
    m = X.init_cross_encoder(CFG, SEED, "cpu", dtype=torch.float32)
    p = "model.layers.1."
    h = torch.randn(64, CFG.hidden_size, generator=torch.Generator().manual_seed(1))
    scores = (h @ m.w[p + "mlp.gate.weight"].T).sigmoid()
    bias = torch.zeros(CFG.n_routed_experts)
    bias[3] = 10.0  # expert 3 is chosen for every token whatever its score
    m.w[p + "mlp.gate.e_score_correction_bias"] = bias
    idx, wts = m.route(h, p)
    assert (idx == 3).any(dim=1).all()
    for t in range(h.shape[0]):
        chosen = set(idx[t].tolist())
        rest = torch.topk(scores[t] + bias, CFG.num_experts_per_tok).indices.tolist()
        assert chosen == set(rest)
        unbiased = scores[t, idx[t]]
        assert torch.allclose(wts[t], unbiased / unbiased.sum() * CFG.routed_scaling_factor, atol=1e-6)
    assert not torch.allclose(wts.sum(dim=1), torch.zeros(()))


def test_stand_in_tokenizer_and_prompt_follow_the_written_rules():
    assert X.token_ids("Yes, no. YES", 512) == [X.YES_ID, X.token_id(",", 512), X.NO_ID,
                                                X.token_id(".", 512), X.YES_ID]
    ids = X.token_ids("the t000123 Acme00001 é", 163840)
    assert all(3 <= i < 163840 for i in ids)
    for query in ("t000001 t000002", "How is Acme00001 related to Acme00002? t000003"):
        head, tail = X.prompt_parts(query, 163840)
        doc = [7, 8, 9]
        assert head + doc + tail == bench_prompts.prompt(query, doc, 163840)
        assert tail[-4:] == [X.YES_ID, X.token_id("or", 163840), X.NO_ID, X.token_id(".", 163840)]


def test_fp8_weights_store_codes_and_scales():
    m = X.init_cross_encoder(CFG, SEED, "cpu", weight_dtype="float8_e4m3fn")
    w = m.w["model.layers.1.mlp.experts.gate_up"]
    assert isinstance(w, X.Fp8Weight) and w.codes.dtype == torch.float8_e4m3fn
    assert w.scale.shape == (CFG.n_routed_experts, 2 * CFG.moe_intermediate_size, 1)
    assert not isinstance(m.w["lm_head.weight"], X.Fp8Weight)
    with pytest.raises(ValueError):
        X.init_cross_encoder(CFG, SEED, "cpu", weight_dtype="int4")


def test_reranker_scores_counters_and_store(prompts):
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    m = X.init_cross_encoder(CFG, SEED, "cpu")
    texts = ["alpha beta gamma", "delta", "epsilon zeta eta theta"]
    store = X.DocumentStore.from_texts(texts, CFG.vocab_size, 64, "cpu")
    assert store.ids.shape == (3, 4) and store.lengths_host.tolist() == [3, 1, 4]
    rr = X.CrossEncoderReranker(m, store.ids, store.lengths, RAGConfig(rerank_max_candidates=3))
    before = {k: rag_metrics.counter(k).value() for k in (
        "rerank_xenc_prompts_total", "rerank_xenc_tokens_total",
        "rerank_xenc_padded_tokens_total", "rerank_xenc_attention_pairs_total")}
    ids = torch.tensor([2, -1, 0, 2, 1])
    got = rr.score({"query_text": "alpha query"}, ids, torch.zeros(5))
    head, tail = X.prompt_parts("alpha query", CFG.vocab_size)
    want = m.yes_probability(X.pack([head + X.token_ids(texts[i], CFG.vocab_size) + tail
                                     for i in (0, 2)], "cpu"))
    # the first three valid slots (2, 0, 2) are judged, parent 2 once; slot 4 is past the cap
    assert got[1] == 0 and got[4] == 0
    assert torch.allclose(got[[0, 2, 3]], want[[1, 0, 1]], atol=1e-6)
    lengths = np.array([len(head) + n + len(tail) for n in (3, 4)])
    grew = {k: rag_metrics.counter(k).value() - v for k, v in before.items()}
    assert grew == {"rerank_xenc_prompts_total": 2, "rerank_xenc_tokens_total": lengths.sum(),
                    "rerank_xenc_padded_tokens_total": 2 * lengths.max() - lengths.sum(),
                    "rerank_xenc_attention_pairs_total": (lengths * (lengths + 1) // 2).sum()}


@pytest.fixture(scope="module")
def placed():
    """A synthetic corpus placed with the benchmark's plug-ins at the small size, the
    cross-encoder in f32 on both sides."""
    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.generator import build_corpus, make_texts
    from perfbench.lib.system import build_system

    cell = resolve(load_benchmark(), "rag1m-moonlight.staged-xenc")
    config = json.loads(json.dumps(cell.config))
    config.update({k: TINY[k] for k in TINY})
    config["documents"] = {"doc_tokens_min": 48, "doc_tokens_max": 64}
    config["corpus"].update(n_chunks=2000, n_entities=200, terms_per_doc=8, vocab=2048,
                            embedding_dim=64, embedding_dim_full=128, maxsim_dim=16,
                            maxsim_doc_tokens=16)
    # the tiny random model's yes-probabilities sit near 0.5, under the 0.6 gate: a gate
    # at 0.3 keeps answers to compare
    config["rag_config"].update(embedding_dim=64, embedding_dim_full=128, maxsim_dim=16,
                                maxsim_doc_tokens=16, maxsim_query_tokens=8, safety_threshold=0.3)
    seed = 2147600321
    corpus = build_corpus(config["corpus"], seed, "cpu")
    texts, _ = make_texts(corpus, dict(cell.traffic, texts=200), seed)
    system = build_system(corpus, config, "cpu", None, seed, cell.models)
    system.state.xenc_model = X.init_cross_encoder(CFG, seed, "cpu", dtype=torch.float32)
    return cell, config, corpus, texts[:6], system, seed


def test_retriever_from_state_returns_the_reference_pipelines_answers(placed, monkeypatch):
    from perfbench.reference import judge
    from perfbench.reference.pipeline import Reference

    cell, config, corpus, texts, system, seed = placed
    ret = system.retriever()
    assert isinstance(ret.reranker, X.CrossEncoderReranker)
    got = [judge.served(ret.retrieve(t)) for t in texts]
    ref_model = cell.models["reranker"].reference
    monkeypatch.setattr(ref_model, "PUBLISHED", TINY)
    monkeypatch.setattr(ref_model, "DOCUMENTS", config["documents"])
    monkeypatch.setattr(ref_model.Plain, "__init__", _f32_weights(ref_model.Plain.__init__))
    ref = Reference(corpus, config, "cpu", seed, cell.models)
    answers = ref.answers(texts, "staged")
    for g, a in zip(got, answers):
        assert g.refused == a.refused
        assert g.rows == [row for row, _ in a.final]
        numbers = judge.compare(g, a)
        assert numbers["channel_gap"] <= 1e-5 and numbers["score_gap"] <= 1e-5, numbers
    assert any(g.rows for g in got)


def test_prompt_ids_cross_before_the_score(placed):
    """The prompt ids are made, and copied to the device, in the retriever's rerank
    range before the score is called: a caller that wraps the score in a range of its
    own (as the benchmark's ``bench.staged.rerank`` span does) still sees that copy
    open ``engine.staged.rerank`` on the device, ahead of the model's ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    texts, system = placed[3], placed[4]
    ret = system.retriever()
    score = ret.reranker.score

    def wrapped(*a, **k):
        with record_function("bench.staged.rerank"):
            return score(*a, **k)

    ret.reranker.score = wrapped
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ret.retrieve(texts[0])
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation())
    rerank, pack, wrap = (next(x for x in spans if x[2] == name) for name in (
        "engine.staged.rerank", "engine.staged.rerank.pack", "bench.staged.rerank"))
    assert rerank[0] <= pack[0] and pack[1] <= wrap[0] <= wrap[1] <= rerank[1]


def _f32_weights(init):
    def wrapped(self, cfg, seed, device, bf16_weights=True):
        init(self, cfg, seed, device, bf16_weights=False)
    return wrapped


def test_ingested_corpus_builds_the_store_and_batched_engine_refuses():
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.facade import RAG

    cfg = RAGConfig(rerank_backend="cross_encoder", embedder_backend="bowhash", capacity_round=64,
                    embedding_dim=32, embedding_dim_full=64, maxsim_dim=16, maxsim_doc_tokens=16,
                    maxsim_query_tokens=8)
    model = X.init_cross_encoder(CFG, SEED, "cpu")
    rag = RAG(cfg, device="cpu", cross_encoder=model)
    rag.ingest_text("# Pumps\n\nThe centrifugal pump moves water through the cooling loop.\n\n"
                    "# Valves\n\nA gate valve isolates the pump for maintenance.", name="plant.md")
    ret = rag.retriever
    ids, lengths = ret.state.xenc_doc_ids, ret.state.xenc_doc_len
    n = ret.corpus.n_parents
    assert isinstance(ret.reranker, X.CrossEncoderReranker) and ids.shape[0] == n
    for row in range(n):
        want = X.token_ids(ret.corpus.parent_by_row(row).text, CFG.vocab_size)
        assert ids[row, : lengths[row]].tolist() == want
    res = rag.query("which valve isolates the pump")
    assert all(0.0 <= r.rerank_score <= 1.0 for r in res.results)
    assert ret.state.nbytes()["cross_encoder"] == 4 * (ids.numel() + lengths.numel()) + model.nbytes()
    with pytest.raises(NotImplementedError, match="staged path"):
        Engine(ret.state, config=cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        rag.query_batch(["pump"])


PORT = Path(X.__file__).resolve().parents[1]
RERANKERS = {f"triple_hybrid_rag_tpu_torch.models.{m}"
             for m in ("cross_encoder", "reranker", "maxsim_reranker")}


def _imported(path: Path):
    """Every module a source imports, at any depth of its code, by absolute name (a
    ``from package import name`` also names ``package.name``)."""
    package = ".".join(("triple_hybrid_rag_tpu_torch",) + path.relative_to(PORT).parent.parts)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.rsplit(".", node.level - 1)[0] if node.level > 1 else package
                base = f"{parent}.{base}" if base else parent
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


@pytest.mark.parametrize("module", sorted(
    str(p.relative_to(PORT)) for sub in ("index", "ops") for p in (PORT / sub).glob("*.py")))
def test_index_and_ops_import_no_reranker(module):
    """The placed state and the kernels' wrappers know no reranker: a rung's module
    reads what the state holds, never the other way round."""
    assert RERANKERS.isdisjoint(_imported(PORT / module)), module


def test_checkpoint_records_the_weight_type_only_away_from_its_default(tmp_path):
    from triple_hybrid_rag_tpu_torch.index import checkpoint
    from triple_hybrid_rag_tpu_torch.ingest import Ingestor

    for value, kept in (("bfloat16", False), ("float8_e4m3fn", True)):
        cfg = RAGConfig(cross_encoder_weight_dtype=value, embedder_backend="bowhash")
        ing = Ingestor(config=cfg, device="cpu")
        ing.ingest_text("a short note about pumps", name="n.txt")
        d = checkpoint.save_ingestor(ing, tmp_path / value)
        saved = json.loads((d / "manifest.json").read_text())["config"]
        assert ("cross_encoder_weight_dtype" in saved) == kept
        assert checkpoint.load_checkpoint(d)[3] == dataclasses.replace(cfg, api_key="")

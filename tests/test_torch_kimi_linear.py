"""Kimi-Linear as the cross-encoder (``models/kimi_linear.py``) and its chunked KDA
(``ops/kda.py``) against the plain reference of the benchmark
(``perfbench/reference/models/kimilinear.py``: the token-by-token recurrence), on
seeded random weights at a small size on the CPU: hidden 64, layer 1 dense, then
three KDA layers to one latent attention layer (KDA at 1-4, MLA at 5, counted from
1), KDA and attention 4 heads of 16, latent rank 16, 16 routed experts (top 4) of
width 32 of which channels 0-15 are held, 1 shared, vocabulary 512.

Tolerances, each with its reading at the seed here:

* f32 weights and activations: every position's logits within 1e-5 of the reference
  (reads 8.5e-7; the chunked and the recurrent forms differ in the order of f32 sums);
* bf16 (weights, GEMMs and their outputs; the residual stream and the KDA layer
  between its projections f32): every position's logits within 4e-2 of the
  reference on the same bf16-rounded weights (reads 9.0e-3), a bound the e4m3
  weights of the control exceed (read 0.132);
* the plain chunked KDA against the recurrence, prompts of 1, 63, 64, 65 and 130
  tokens packed together and each alone: within 1e-5 (reads 4.3e-7);
* prompts packed together against each alone through the model: within 1e-5 (reads
  4.5e-7 in f32, 1.6e-7 in bf16);
* the two halves of the experts' channels, the shared expert counted once, against
  the uncut layer: within 1e-5 (f32; reads 2.4e-7).

Then the staged path: ``Retriever.from_state`` with this model returns the plain
reference pipeline's answers.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference.models import kimilinear as plain
from triple_hybrid_rag_tpu_torch.models import cross_encoder as X
from triple_hybrid_rag_tpu_torch.models import kimi_linear as K
from triple_hybrid_rag_tpu_torch.ops.kda import kda_chunked_plain

SEED = 2147483999
TINY_LAC = {"full_attn_layers": [5], "kda_layers": [1, 2, 3, 4], "head_dim": 16, "num_heads": 4,
            "short_conv_kernel_size": 4}
TINY = dict(plain.PUBLISHED, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=5, num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, num_experts=16, num_experts_per_token=4,
            num_shared_experts=1, vocab_size=512, linear_attn_config=TINY_LAC)
CHANNELS = (0, 16)
CFG = K.KimiLinearConfig.from_hf(TINY, *CHANNELS)
CONFIG_FILE = Path(__file__).resolve().parents[1] / "perfbench" / "configs" / "rag1m-kimilinear.json"


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


def reference_logits(prompts, bf16_weights, channels=CHANNELS):
    return plain.Plain(TINY, SEED, "cpu", bf16_weights=bf16_weights, channels=channels).logits(prompts)


def test_preset_is_the_published_config():
    preset = K.PRESETS["kimi-linear-48b-a3b"]
    assert preset == K.KimiLinearConfig.from_hf(plain.PUBLISHED)
    assert preset.moe.experts == 256 and preset.moe.channels == (0, 1024) and preset.moe.top_k == 8
    mla = sorted(set(range(preset.num_hidden_layers)) - preset.kda_index)
    assert mla == [3, 7, 11, 15, 19, 23, 26]
    conf = json.loads(CONFIG_FILE.read_text())
    assert {k: conf[k] for k in plain.PUBLISHED} == plain.PUBLISHED
    share = conf["expert_share"]
    assert (share["channels_first"], share["channels_held"]) == (
        plain.CHANNELS["first"], plain.CHANNELS["count"]) == (0, 512)
    for key, value in (("mla_use_nope", False), ("use_grouped_topk", False), ("q_lora_rank", 1536),
                       ("moe_router_activation_func", "softmax"), ("model_type", "deepseek_v3")):
        with pytest.raises(ValueError):
            K.KimiLinearConfig.from_hf(dict(plain.PUBLISHED, **{key: value}))
    with pytest.raises(ValueError):
        K.KimiLinearConfig.from_hf(plain.PUBLISHED, channels_first=600, channels_held=512)


def test_forward_f32_matches_plain_reference(prompts):
    m = K.init_kimi_linear(CFG, SEED, "cpu", dtype=torch.float32)
    assert isinstance(m, K.KimiLinear)
    got = m.logits(X.pack(prompts, "cpu"))
    want = reference_logits(prompts, bf16_weights=False)
    assert got.shape == (sum(map(len, prompts)), 512)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("weight_dtype, within", [("bfloat16", True), ("float8_e4m3fn", False)])
def test_forward_bf16_tolerance_and_fp8_control(prompts, weight_dtype, within):
    m = K.init_kimi_linear(CFG, SEED, "cpu", weight_dtype=weight_dtype)
    gap = (m.logits(X.pack(prompts, "cpu")) - reference_logits(prompts, bf16_weights=True)).abs().max().item()
    assert (gap <= 4e-2) == within, gap


@pytest.mark.parametrize("layout", ["packed", "alone"])
def test_chunked_kda_matches_the_recurrence(layout):
    """Chunks of 64 that end at each prompt's end: 1, 63, 64, 65 and 130 tokens, the
    state restarting at every prompt."""
    g = torch.Generator().manual_seed(0)
    lengths = [1, 63, 64, 65, 130]
    t, h, d = sum(lengths), 3, 16
    q = torch.nn.functional.normalize(torch.randn(t, h, d, generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(t, h, d, generator=g), dim=-1)
    v = torch.randn(t, h, d, generator=g)
    decay = -2.0 * torch.rand(t, h, d, generator=g)
    beta = torch.rand(t, h, generator=g)
    cu = np.concatenate([[0], np.cumsum(lengths)])
    want = plain.recurrence(q, k, v, decay, beta, lengths, d ** -0.5)
    if layout == "packed":
        got = kda_chunked_plain(q, k, v, decay, beta, cu.tolist(), d ** -0.5)
    else:
        got = torch.cat([kda_chunked_plain(q[a:b], k[a:b], v[a:b], decay[a:b], beta[a:b], [0, b - a], d ** -0.5)
                         for a, b in zip(cu[:-1], cu[1:])])
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_prompts_equal_one_prompt_forward_passes(prompts, dtype):
    """The convolutions and the recurrence restart at each prompt's first token."""
    m = K.init_kimi_linear(CFG, SEED, "cpu", dtype=dtype)
    packed = m.logits(X.pack(prompts, "cpu"))
    alone = torch.cat([m.logits(X.pack([p], "cpu")) for p in prompts])
    assert (packed - alone).abs().max().item() <= 1e-5
    p = m.yes_probability(X.pack(prompts, "cpu"))
    last = np.cumsum([len(q) for q in prompts]) - 1
    want = torch.softmax(packed[last][:, [X.YES_ID, X.NO_ID]], dim=-1)[:, 0]
    assert torch.allclose(p, want, atol=1e-6)


def test_two_halves_of_the_experts_add_up_to_the_uncut_layer():
    """Each chip computes its own channels of every expert; the two parts, with what
    both chips compute alike (the residual and the shared expert) counted once, are
    the uncut layer. A chip's held channels are the uncut layer's, bit for bit."""
    uncut = K.init_kimi_linear(K.KimiLinearConfig.from_hf(TINY), SEED, "cpu", dtype=torch.float32)
    halves = [K.init_kimi_linear(K.KimiLinearConfig.from_hf(TINY, first, 16), SEED, "cpu", dtype=torch.float32)
              for first in (0, 16)]
    p = "model.layers.2."
    gate_up, down = uncut.w[p + "mlp.experts.gate_up"], uncut.w[p + "mlp.experts.down_proj.weight"]
    for i, half in enumerate(halves):
        held = slice(16 * i, 16 * i + 16)
        assert torch.equal(half.w[p + "mlp.experts.gate_up"],
                           torch.cat([gate_up[:, :32][:, held], gate_up[:, 32:][:, held]], 1))
        assert torch.equal(half.w[p + "mlp.experts.down_proj.weight"], down[:, :, held])
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(3))
    h = X.rms_norm(x, uncut.w[p + "post_attention_layernorm.weight"], CFG.rms_norm_eps)
    shared = X.swiglu(h, uncut.w, p + "mlp.shared_experts.", torch.float32)
    parts = [half._ffn(x, 2) - x - shared for half in halves]
    assert (parts[0] + parts[1] + x + shared - uncut._ffn(x, 2)).abs().max().item() <= 1e-5


@pytest.fixture(scope="module")
def placed():
    """A synthetic corpus placed with the benchmark's plug-ins at the small size, the
    cross-encoder in f32 on both sides."""
    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.generator import build_corpus, make_texts
    from perfbench.lib.system import build_system

    cell = resolve(load_benchmark(), "rag1m-kimilinear.staged-xenc")
    config = json.loads(json.dumps(cell.config))
    config.update({k: TINY[k] for k in TINY},
                  expert_share={"channels_first": CHANNELS[0], "channels_held": CHANNELS[1]})
    config["documents"] = {"doc_tokens_min": 48, "doc_tokens_max": 64}
    config["corpus"].update(n_chunks=2000, n_entities=200, terms_per_doc=8, vocab=2048,
                            embedding_dim=64, embedding_dim_full=128, maxsim_dim=16,
                            maxsim_doc_tokens=16)
    # the tiny random model's yes-probabilities sit near 0.5, under the 0.6 gate: a gate
    # at 0.3 keeps answers to compare
    config["rag_config"].update(embedding_dim=64, embedding_dim_full=128, maxsim_dim=16,
                                maxsim_doc_tokens=16, maxsim_query_tokens=8, safety_threshold=0.3)
    seed = 2147600322
    corpus = build_corpus(config["corpus"], seed, "cpu")
    texts, _ = make_texts(corpus, dict(cell.traffic, texts=200), seed)
    system = build_system(corpus, config, "cpu", None, seed, cell.models)
    system.state.xenc_model = K.init_kimi_linear(CFG, seed, "cpu", dtype=torch.float32)
    return cell, config, corpus, texts[:4], system, seed


def test_retriever_from_state_returns_the_reference_pipelines_answers(placed, monkeypatch):
    from perfbench.reference import judge
    from perfbench.reference.pipeline import Reference
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    cell, config, corpus, texts, system, seed = placed
    ret = system.retriever()
    assert isinstance(ret.reranker, X.CrossEncoderReranker)
    tokens = rag_metrics.counter("rerank_xenc_tokens_total").value()
    got = [judge.served(ret.retrieve(t)) for t in texts]
    assert rag_metrics.counter("rerank_xenc_tokens_total").value() > tokens
    ref_model = cell.models["reranker"].reference
    monkeypatch.setattr(ref_model, "PUBLISHED", TINY)
    monkeypatch.setattr(ref_model, "DOCUMENTS", config["documents"])
    monkeypatch.setattr(ref_model, "CHANNELS", {"first": CHANNELS[0], "count": CHANNELS[1]})
    init = ref_model.Plain.__init__
    monkeypatch.setattr(ref_model.Plain, "__init__",
                        lambda self, cfg, seed, device, bf16_weights=True, channels=None:
                        init(self, cfg, seed, device, bf16_weights=False, channels=channels))
    ref = Reference(corpus, config, "cpu", seed, cell.models)
    answers = ref.answers(texts, "staged")
    for g, a in zip(got, answers):
        assert g.refused == a.refused
        assert g.rows == [row for row, _ in a.final]
        numbers = judge.compare(g, a)
        assert numbers["channel_gap"] <= 1e-5 and numbers["score_gap"] <= 1e-5, numbers
    assert any(g.rows for g in got)

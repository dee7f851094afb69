"""The port's query encoder against the JAX reference (flax) on the same inputs.

The hashing and the identity anchors are bit-equal. The forward of a float32
config, from a random flax init carried over with ``encoder_params_from_flax``,
agrees within 1e-5 (f32 sums in another order). In bf16 the outputs are unit
vectors whose components round to bf16 at every layer; the port holds the flax
forward within ``BF16_ATOL`` = 1e-2, a little over one bf16 ulp at 1.0 (7.8e-3),
on a tiny config and on the packaged 8-layer weights at full width, where XLA and
PyTorch sum the 512- and 2048-wide products in different orders.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.analyzer import Analyzer as RefAnalyzer
from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
from triple_hybrid_rag_tpu.index.dense_index import truncate_matryoshka
from triple_hybrid_rag_tpu.models import encoder as ref
from triple_hybrid_rag_tpu.models import pretrain as ref_pretrain

from torch_port_helpers import flat_params
from triple_hybrid_rag_tpu_torch.analyzer import Analyzer
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.models import encoder as enc
from triple_hybrid_rag_tpu_torch.models import pretrain
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder, get_default_embedder

BF16_ATOL = 1e-2
# a bf16 forward against the f32 forward of the same weights shares no rounding:
# two bf16 ulps at 1.0 (chip_smoke.py holds the card's encoder to it)
BF16_VS_F32_ATOL = 2e-2
TEXTS = [
    "payment invoice overdue",
    "the contract was terminated early by Acme Corp",
    "",
    "fatura cobranca pagamento prazo multa",
    "Quando vence a fatura? A cobrança está atrasada.",
    "bill invoices billing remittance payments settled settling",
    "password reset security portal " * 6,  # longer than the tiny max_tokens
]


def tiny(dtype):
    return dict(
        vocab_buckets=2048, d_model=32, n_layers=2, n_heads=4, d_mlp=64,
        max_tokens=16, out_dim=64, token_dim=16, dtype=dtype,
    )


def carried(dtype):
    """(reference EncoderEmbedder, port EncoderEmbedder) with the same random weights."""
    ref_emb = ref.EncoderEmbedder(ref.EncoderConfig(**tiny(dtype)), RefConfig())
    port = enc.EncoderEmbedder(
        enc.EncoderConfig(**tiny(dtype)), RAGConfig(),
        params=enc.encoder_params_from_flax(flat_params(ref_emb.params)), device="cpu",
    )
    return ref_emb, port


@pytest.fixture(scope="module")
def packaged():
    """The packaged encoder in both packages (loaded once per module)."""
    return ref_pretrain.load_default_encoder(RefConfig()), pretrain.load_default_encoder(
        RAGConfig(), device="cpu"
    )


def test_hash_token_and_text_hasher():
    cfg = ref.EncoderConfig(**tiny("float32"))
    tokens = ["payment", "fatura", "cobrança", "x", "t000123", "Acme"]
    assert [enc.hash_token(t, 2048) for t in tokens] == [ref.hash_token(t, 2048) for t in tokens]
    assert enc.PAD_ID == ref.PAD_ID == 0
    want = ref.TextHasher(cfg, RefConfig()).encode(TEXTS)
    got = enc.TextHasher(enc.EncoderConfig(**tiny("float32")), RAGConfig()).encode(TEXTS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_concepts_copy_is_verbatim():
    assert pretrain.CONCEPTS == ref_pretrain.CONCEPTS
    assert list(pretrain.CONCEPTS) == list(ref_pretrain.CONCEPTS)


@pytest.mark.parametrize("dims", [(64, 16), (1024, 128)], ids=["tiny", "packaged"])
def test_anchor_arrays_bit_equal(dims):
    out_dim, token_dim = dims
    kw = dict(tiny("float32"), out_dim=out_dim, token_dim=token_dim)
    texts = TEXTS + ["the of and", "pagamento payment remittance"]  # stopwords only; synonyms
    a_ref = RefAnalyzer(RefConfig())
    a_port = Analyzer(RAGConfig())
    for text in texts:
        toks = a_ref.tokenize(text)
        assert [enc.anchor_key(t) for t in toks] == [ref.anchor_key(t) for t in toks]
    # surface forms of one concept group share a key
    assert enc.anchor_key("fatura") == enc.anchor_key("cobranca") == ref.anchor_key("fatura")
    assert enc.anchor_key("payment") == enc.anchor_key("pagamento") == "payment"
    want = ref.anchor_arrays(texts, ref.EncoderConfig(**kw), a_ref)
    got = enc.anchor_arrays(texts, enc.EncoderConfig(**kw), a_port)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[0][-2].any() and not got[1][-2].any()  # a token-less text: zero rows


def test_blend_anchors_np_equal():
    rng = np.random.default_rng(0)
    pooled = rng.standard_normal((4, 64)).astype(np.float32)
    tok = rng.standard_normal((4, 16, 16)).astype(np.float32)
    apool = rng.standard_normal((4, 64)).astype(np.float32)
    atok = rng.standard_normal((4, 16, 16)).astype(np.float32)
    apool[1] = 0.0
    atok[:, 10:] = 0.0
    for w2 in ((0.6, 0.5), (0.6, 0.65)):
        kw = dict(tiny("float32"), anchor_token_w2=w2[0], anchor_pool_w2=w2[1])
        want = ref.blend_anchors_np(ref.EncoderConfig(**kw), pooled, tok, apool, atok)
        got = enc.blend_anchors_np(enc.EncoderConfig(**kw), pooled, tok, apool, atok)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", BF16_ATOL)])
def test_forward_matches_flax(dtype, atol):
    ref_emb, port = carried(dtype)
    ids, mask = ref_emb.hasher.encode(TEXTS)
    p_ref, t_ref = ref_emb.model.apply(ref_emb.params, jnp.asarray(ids), jnp.asarray(mask))
    p, t = port.forward(ids, mask)
    assert p.dtype == t.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=atol, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=atol, rtol=0)
    assert not t.numpy()[~mask].any()  # padding stays exactly zero
    # the host path: forward + anchors + truncation
    np.testing.assert_allclose(port.embed_texts(TEXTS), ref_emb.embed_texts(TEXTS), atol=atol, rtol=0)
    np.testing.assert_allclose(
        port.token_embeddings(TEXTS, max_tokens=8, dim=8),
        ref_emb.token_embeddings(TEXTS, max_tokens=8, dim=8), atol=atol, rtol=0,
    )
    assert port.maxsim_calibration == ref_emb.maxsim_calibration == 0.6


def test_packaged_weights_match_flax(packaged):
    """The packaged 8-layer encoder at full width (d_model 512, 96 tokens), bf16."""
    ref_emb, port = packaged
    assert port.enc_cfg == enc.EncoderConfig(**{
        k: getattr(ref_emb.enc_cfg, k) for k in ref_emb.enc_cfg.__dataclass_fields__
    })
    assert port.enc_cfg.d_model == 512 and port.enc_cfg.n_layers == 8
    texts = TEXTS[:2] + TEXTS[3:6]
    ids, mask = ref_emb.hasher.encode(texts)
    p_ref, t_ref = ref_emb._encode(ref_emb.params, jnp.asarray(ids), jnp.asarray(mask))
    p, t = port.forward(ids, mask)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(
        port.token_embeddings(texts, max_tokens=32, dim=128),
        ref_emb.token_embeddings(texts, max_tokens=32, dim=128), atol=BF16_ATOL, rtol=0,
    )


def test_packaged_bf16_against_its_f32_forward(packaged):
    """The packaged weights in bf16 against the same weights in f32, on natural and
    synthetic-corpus texts: the comparison chip_smoke.py makes on the card."""
    _, port = packaged
    with np.load(pretrain.DEFAULT_PARAMS) as npz:
        flat = {name: npz[name] for name in npz.files if name != "__meta__"}
    cfg32 = dataclasses.replace(port.enc_cfg, dtype="float32")
    f32 = enc.EncoderEmbedder(cfg32, RAGConfig(), params=enc.encoder_params_from_flax(flat),
                              device="cpu")
    assert f32.model.tok_embed.dtype == torch.float32
    rng = np.random.default_rng(0)
    texts = TEXTS + [
        "How is Acme00012 related to Acme00345? t000012 t004567 t000001",
        " ".join(f"t{int(t):06d}" for t in np.floor(65536 * rng.random(64) ** 4)),
    ]
    ids, mask = port.hasher.encode(texts)
    for got, want in zip(port.forward(ids, mask), f32.forward(ids, mask)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=BF16_VS_F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_queries_device_parity(dtype):
    """The device encode equals the host path (embed_texts + token_embeddings)
    within f16 rounding, and the reference's device encode within the forward's
    tolerance plus f16 rounding."""
    ref_emb, port = carried(dtype)
    texts = ["payment invoice overdue", "the contract was terminated early", ""]
    out_dim, t_q, tdim = 24, 8, 8
    pooled, tok, mask = port.encode_queries_device(texts, out_dim=out_dim, max_tokens=t_q,
                                                   token_dim=tdim)
    assert pooled.dtype == tok.dtype == torch.float16
    assert pooled.shape == (3, out_dim) and tok.shape == (3, t_q, tdim)
    ref_vec = truncate_matryoshka(port.embed_texts(texts), out_dim)
    ref_tok = port.token_embeddings(texts, max_tokens=t_q, dim=tdim)
    np.testing.assert_allclose(pooled.float().numpy(), ref_vec, atol=2e-3)
    np.testing.assert_allclose(tok.float().numpy(), ref_tok, atol=2e-3)
    np.testing.assert_array_equal(mask, np.any(ref_tok != 0, axis=-1))
    p_ref, t_ref, m_ref = ref_emb.encode_queries_device(texts, out_dim=out_dim, max_tokens=t_q,
                                                        token_dim=tdim)
    atol = 2e-3 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(pooled.float().numpy(), np.asarray(p_ref, np.float32), atol=atol)
    np.testing.assert_allclose(tok.float().numpy(), np.asarray(t_ref, np.float32), atol=atol)
    np.testing.assert_array_equal(mask, m_ref)


def test_encode_queries_device_no_truncation_case():
    _, port = carried("float32")
    cfg = port.enc_cfg
    texts = ["password reset security portal"]
    pooled, tok, mask = port.encode_queries_device(
        texts, out_dim=cfg.out_dim, max_tokens=cfg.max_tokens, token_dim=cfg.token_dim
    )
    np.testing.assert_allclose(pooled.float().numpy(), port.embed_texts(texts), atol=2e-3)
    np.testing.assert_allclose(tok.float().numpy(), port.token_embeddings(texts), atol=2e-3)
    assert mask.shape == (1, cfg.max_tokens)


def test_embed_query_raises_without_tokens():
    ref_emb, port = carried("float32")
    with pytest.raises(ValueError, match="no tokens"):
        port.embed_query("the of and")
    with pytest.raises(ValueError, match="no tokens"):
        port.embed_query("")
    v = port.embed_query("payment invoice")
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-5)
    # images are ported (tests/test_torch_ocr.py): an undecodable payload embeds by
    # its content hash, bit-equal to the reference's
    np.testing.assert_array_equal(port.embed_images([b""]), ref_emb.embed_images([b""]))


def test_token_embeddings_truncate_renormalize_and_keep_padding_zero():
    _, port = carried("float32")
    texts = ["payment invoice overdue", "the of and"]
    full = port.token_embeddings(texts)
    cut = port.token_embeddings(texts, max_tokens=8, dim=8)
    assert cut.shape == (2, 8, 8)
    occupied = np.any(full[:, :8] != 0, axis=-1)
    assert occupied[0, :3].all() and not occupied[0, 3:].any() and not occupied[1].any()
    np.testing.assert_allclose(np.linalg.norm(cut[occupied], axis=-1), 1.0, atol=1e-5)
    assert not cut[~occupied].any()
    want = full[:, :8, :8] / np.maximum(np.linalg.norm(full[:, :8, :8], axis=-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(cut[occupied], want[occupied], atol=1e-6)


def test_load_default_encoder_and_backends(tmp_path, packaged):
    missing = str(tmp_path / "absent.npz")
    assert pretrain.load_default_encoder(RAGConfig(), path=missing, device="cpu") is None
    with pytest.raises(RuntimeError, match="encoder"):
        get_default_embedder(RAGConfig(embedder_backend="encoder", encoder_params_path=missing),
                             device="cpu")
    fallback = get_default_embedder(RAGConfig(encoder_params_path=missing), device="cpu")
    assert isinstance(fallback, BowHashEmbedder)
    # an unreadable file, or a __meta__ that does not parse, counts as absent
    (tmp_path / "garbage.npz").write_bytes(b"not an npz")
    bad_meta = tmp_path / "bad_meta.npz"
    np.savez(bad_meta, __meta__=np.frombuffer(json.dumps({"x": 1}).encode(), np.uint8))
    for path in (tmp_path / "garbage.npz", bad_meta):
        assert pretrain.load_default_encoder(RAGConfig(), path=path, device="cpu") is None
    # "auto" and "encoder" load the packaged weights, with the pooled anchor re-weighted
    _, port = packaged
    for backend in ("auto", "encoder"):
        emb = get_default_embedder(RAGConfig(embedder_backend=backend), device="cpu")
        assert emb is port  # one cached instance per (path, settings, device)
    assert port.enc_cfg.anchor_pool_w2 == 0.65 and port.enc_cfg.anchor_token_w2 == 0.6
    assert port.model.tok_embed.dtype == torch.bfloat16 and port.device.type == "cpu"
    assert port.model.ln_final.scale.dtype == torch.float32
    other = pretrain.load_default_encoder(RAGConfig(encoder_anchor_pool_w2=None), device="cpu")
    assert other is not port and other.enc_cfg.anchor_pool_w2 == 0.5

"""The query encoder: a bidirectional transformer with pooled and per-token heads.

A port of the JAX package's ``models/encoder.py``. Text is tokenized by the
analyzer and hashed into a fixed bucket vocabulary (:class:`TextHasher`); the
transformer gives a pooled sentence embedding (masked mean, projection, L2 norm)
for the dense channel and unit per-token embeddings for the MaxSim rerank. Both
heads are blended with deterministic per-lexeme identity anchors
(:func:`anchor_arrays`, :func:`blend_anchors_np`), bit-exact copies of the
reference's, so two occurrences of one lexeme stay similar on text far from the
training distribution.

The forward follows flax's numerics (``flax.linen`` ``Dense``, ``LayerNorm``,
``MultiHeadDotProductAttention``, ``gelu``): compute in ``compute_dtype`` (bf16 by
default) with parameters cast to it at use, LayerNorm statistics in f32 with
epsilon 1e-6, the query scaled by 1/sqrt(head dim) in the compute dtype, masked
keys at the dtype's lowest value, the softmax in the compute dtype, the tanh GELU,
and each dense layer's bias added after its product. Its matrix products are
PyTorch's (``F.linear``, ``torch.matmul``): the reference computes the encoder
with XLA ops and no Pallas kernel.

:func:`encoder_params_from_flax` maps the reference's flat parameter names (the
packaged npz's, or a flattened flax tree's) onto this module's state dict.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..analyzer import Analyzer, stem_family
from ..config import RAGConfig, get_settings
from ..device import resolve_device

PAD_ID = 0  # reserved token id


@dataclass(frozen=True)
class EncoderConfig:
    vocab_buckets: int = 32768
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    d_mlp: int = 1024
    max_tokens: int = 256
    out_dim: int = 2048  # pooled embedding dim (pre-Matryoshka truncation)
    token_dim: int = 128  # per-token dim for MaxSim
    dtype: str = "bfloat16"
    # squared weights of the deterministic identity anchors in the token and
    # pooled heads (0 = off): each vector becomes norm(a * anchor + b * ctx)
    anchor_token_w2: float = 0.6
    anchor_pool_w2: float = 0.5

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def hash_token(token: str, buckets: int) -> int:
    """Stable token -> [1, buckets) hash (id 0 reserved for padding)."""
    h = int.from_bytes(hashlib.blake2s(token.encode("utf-8"), digest_size=8).digest(), "little")
    return 1 + (h % (buckets - 1))


class TextHasher:
    """Host-side text -> padded (ids, mask) arrays via the analyzer."""

    _CACHE_CAP = 262144  # str -> int memo, cleared when full

    def __init__(self, enc_cfg: EncoderConfig, rag_cfg: Optional[RAGConfig] = None) -> None:
        self.cfg = enc_cfg
        self.analyzer = Analyzer(rag_cfg or get_settings())
        self._cache: dict[str, int] = {}

    def _tid(self, token: str) -> int:
        v = self._cache.get(token)
        if v is None:
            if len(self._cache) > self._CACHE_CAP:
                self._cache.clear()
            v = hash_token(token, self.cfg.vocab_buckets)
            self._cache[token] = v
        return v

    def encode(
        self, texts: Sequence[str], max_tokens: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        t = max_tokens or self.cfg.max_tokens
        ids = np.zeros((len(texts), t), np.int32)
        mask = np.zeros((len(texts), t), bool)
        for i, text in enumerate(texts):
            for j, tok in enumerate(self.analyzer.tokenize(text)[:t]):
                ids[i, j] = self._tid(tok)
                mask[i, j] = True
        return ids, mask


# ---------------------------------------------------------------------------
# identity anchors: deterministic per-lexeme unit directions (bit-exact copies of
# the reference's; the trained weights were fitted with the same anchors)
# ---------------------------------------------------------------------------

_ANCHOR_DIR_CACHE: dict = {}
_SYN_KEY_CACHE: Optional[dict] = None


def _syn_key_map() -> dict:
    """stem family -> synonym-group key of the concept lexicon: the single-word
    surface forms of one group share one anchor direction."""
    global _SYN_KEY_CACHE
    if _SYN_KEY_CACHE is None:
        from .pretrain import CONCEPTS

        m: dict = {}
        for group, forms in CONCEPTS.items():
            for form in forms:
                words = form.split()
                if len(words) == 1:
                    m[stem_family(words[0])] = group
        _SYN_KEY_CACHE = m
    return _SYN_KEY_CACHE


def anchor_key(token: str) -> str:
    stem = stem_family(token)
    return _syn_key_map().get(stem, stem)


def anchor_dir(key: str, dim: int) -> np.ndarray:
    cache = _ANCHOR_DIR_CACHE.setdefault(dim, {})
    v = cache.get(key)
    if v is None:
        seed = int.from_bytes(
            hashlib.blake2s(("anchor:" + key).encode("utf-8"), digest_size=8).digest(),
            "little",
        )
        v = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
        v /= max(float(np.linalg.norm(v)), 1e-12)
        cache[key] = v
    return v


def anchor_arrays(
    texts: Sequence[str], enc_cfg: EncoderConfig, analyzer: Analyzer,
    max_tokens: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(pooled f32[B, out_dim], token f32[B, T, token_dim]) anchor components.

    The pooled anchor is the L2-normalized sum of the text's lexeme directions; the
    token anchors are per-position lexeme directions. Rows are zero where a text
    has no tokens, and at padding positions."""
    t = max_tokens or enc_cfg.max_tokens
    apool = np.zeros((len(texts), enc_cfg.out_dim), np.float32)
    atok = np.zeros((len(texts), t, enc_cfg.token_dim), np.float32)
    for i, text in enumerate(texts):
        toks = analyzer.tokenize(text)[:t]
        if not toks:
            continue
        for j, token in enumerate(toks):
            key = anchor_key(token)
            atok[i, j] = anchor_dir(key, enc_cfg.token_dim)
            apool[i] += anchor_dir(key, enc_cfg.out_dim)
        apool[i] /= max(float(np.linalg.norm(apool[i])), 1e-12)
    return apool, atok


def _anchor_weights(enc_cfg: EncoderConfig) -> Tuple[float, float, float, float]:
    """(a_token, b_token, a_pool, b_pool): the square roots of the blend weights."""
    w_t, w_p = enc_cfg.anchor_token_w2, enc_cfg.anchor_pool_w2
    return (float(np.sqrt(w_t)), float(np.sqrt(1.0 - w_t)),
            float(np.sqrt(w_p)), float(np.sqrt(1.0 - w_p)))


def blend_anchors_np(
    enc_cfg: EncoderConfig, pooled: np.ndarray, tok: np.ndarray,
    apool: np.ndarray, atok: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """The anchor blend on the host (the reference's numpy mirror of its in-loss blend)."""
    a_t, b_t, a_p, b_p = _anchor_weights(enc_cfg)
    has_tok = np.any(atok != 0, axis=-1, keepdims=True)  # [B, T, 1] anchor present
    t_mix = a_t * atok + b_t * tok
    t_norm = np.maximum(np.linalg.norm(t_mix, axis=-1, keepdims=True), 1e-12)
    tok = np.where(has_tok, t_mix / t_norm, tok)
    has_pool = np.any(apool != 0, axis=-1, keepdims=True)
    p_mix = a_p * apool + b_p * pooled
    p_norm = np.maximum(np.linalg.norm(p_mix, axis=-1, keepdims=True), 1e-12)
    return np.where(has_pool, p_mix / p_norm, pooled), tok


def _blend_anchors_torch(enc_cfg, pooled, tok, apool, atok):
    """The same blend on the tensors' device, op for op."""
    a_t, b_t, a_p, b_p = _anchor_weights(enc_cfg)
    has_tok = (atok != 0).any(dim=-1, keepdim=True)
    t_mix = a_t * atok + b_t * tok
    t_norm = torch.clamp(torch.linalg.vector_norm(t_mix, dim=-1, keepdim=True), min=1e-12)
    tok = torch.where(has_tok, t_mix / t_norm, tok)
    has_pool = (apool != 0).any(dim=-1, keepdim=True)
    p_mix = a_p * apool + b_p * pooled
    p_norm = torch.clamp(torch.linalg.vector_norm(p_mix, dim=-1, keepdim=True), min=1e-12)
    return torch.where(has_pool, p_mix / p_norm, pooled), tok


# ---------------------------------------------------------------------------
# the transformer, in flax's numerics
# ---------------------------------------------------------------------------


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``nn.Dense`` with ``dtype=x.dtype``: the product rounded to the compute
    dtype, then the bias added in it."""
    dt = x.dtype
    return F.linear(x, weight.to(dt)) + bias.to(dt)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``nn.LayerNorm`` (epsilon 1e-6): mean and E[x^2] - mean^2 in f32, the
    normalized value in f32, rounded once to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + 1e-6) * scale.float()
    return ((xf - mu) * mul + bias.float()).to(x.dtype)


def _const(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar rounded to ``dtype`` first, as JAX rounds a weakly typed constant."""
    return torch.tensor(value, dtype=torch.float64).to(device=device, dtype=dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, op for op in x's dtype."""
    c = _const(np.sqrt(2 / np.pi), x.dtype, x.device)
    k = _const(0.044715, x.dtype, x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


class _LayerNorm(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return _layer_norm(x, self.scale, self.bias)


class _Dense(nn.Module):
    """A dense layer with an ``F.linear`` weight [out, in]."""

    def __init__(self, d_in: int, d_out: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return _dense(x, self.weight, self.bias)


class Attention(nn.Module):
    """``MultiHeadDotProductAttention`` over a key mask: q/k/v and out as dense
    layers of width heads x head dim, explicit scores, mask and softmax."""

    def __init__(self, d: int, n_heads: int) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.query = _Dense(d, d)
        self.key = _Dense(d, d)
        self.value = _Dense(d, d)
        self.out = _Dense(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        dh = d // h
        dt = x.dtype
        q, k, v = (m(x).view(b, t, h, dh).transpose(1, 2) for m in (self.query, self.key, self.value))
        q = q / _const(math.sqrt(dh), dt, x.device)
        scores = torch.matmul(q, k.transpose(-1, -2))  # [B, H, Tq, Tk]
        scores = torch.where(mask[:, None, None, :], scores, torch.finfo(dt).min)
        # jax.nn.softmax in the compute dtype; its sum accumulates in f32
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(dt)
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, t, d)
        return self.out(o)


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.ln_attn = _LayerNorm(cfg.d_model)
        self.attn = Attention(cfg.d_model, cfg.n_heads)
        self.ln_mlp = _LayerNorm(cfg.d_model)
        self.mlp_in = _Dense(cfg.d_model, cfg.d_mlp)
        self.mlp_out = _Dense(cfg.d_mlp, cfg.d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), mask)
        return x + self.mlp_out(_gelu_tanh(self.mlp_in(self.ln_mlp(x))))


class Encoder(nn.Module):
    """Bidirectional transformer with pooled and token-level heads. Returns
    (pooled f32[B, out_dim] unit rows, tok f32[B, T, token_dim] unit rows, zero at
    padding)."""

    def __init__(self, cfg: EncoderConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_buckets, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_tokens, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_final = _LayerNorm(cfg.d_model)
        self.pool_proj = _Dense(cfg.d_model, cfg.out_dim)
        self.token_proj = _Dense(cfg.d_model, cfg.token_dim)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        c = self.cfg
        dt = c.compute_dtype
        t = ids.shape[1]
        x = F.embedding(ids.long(), self.tok_embed).to(dt) + self.pos_embed[:t].to(dt)
        for blk in self.blocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        m = mask[..., None].to(dt)
        denom = torch.clamp(m.sum(dim=1, dtype=torch.float32).to(dt), min=1.0)
        pooled = (x * m).sum(dim=1, dtype=torch.float32).to(dt) / denom
        pooled = self.pool_proj(pooled).float()
        pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-6)
        tok = self.token_proj(x).float()
        tok = tok / torch.clamp(torch.linalg.vector_norm(tok, dim=-1, keepdim=True), min=1e-6)
        return pooled, tok * mask[..., None].float()

    def cast_for_compute(self) -> "Encoder":
        """Hold the parameters that the forward casts to the compute dtype in that
        dtype already (the same single rounding, done once); LayerNorm parameters
        stay f32, as flax promotes them."""
        dt = self.cfg.compute_dtype
        with torch.no_grad():
            for name, p in self.named_parameters():
                parts = name.split(".")
                if not (len(parts) > 1 and parts[-2].startswith("ln_")):
                    p.data = p.data.to(dt)
        return self


def encoder_params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's flat parameter names -> this module's state dict.

    ``flat`` maps names such as ``params/block_0/attn/query/kernel`` (the packaged
    npz's, or a flax tree flattened with ``/``; the ``params/`` prefix is optional)
    to arrays. Dense kernels [in, out] become ``F.linear`` weights [out, in]; the
    attention's q/k/v kernels [d, H, Dh] and biases [H, Dh] become [H*Dh, d] and
    [H*Dh], its out kernel [H, Dh, d] becomes [d, H*Dh]. Values keep their dtype."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        parts = name.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        a = np.asarray(arr)
        if parts[0].startswith("block_"):
            parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
        leaf = parts[-1]
        if parts[:1] == ["tok_embed"]:
            key = "tok_embed"
        elif leaf == "kernel":
            if a.ndim == 3 and parts[-2] == "out":  # [H, Dh, d]
                a = a.reshape(-1, a.shape[-1])
            elif a.ndim == 3:  # [d, H, Dh]
                a = a.reshape(a.shape[0], -1)
            a = a.T
            key = ".".join(parts[:-1] + ["weight"])
        elif leaf == "bias" and a.ndim == 2:  # q/k/v bias [H, Dh]
            a = a.reshape(-1)
            key = ".".join(parts)
        else:
            key = ".".join(parts)
        out[key] = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    return out


class EncoderEmbedder:
    """Embedder-protocol adapter over :class:`Encoder` on one device.

    ``params`` is the state dict of trained weights (:func:`encoder_params_from_flax`
    of the packaged npz, or of a flax tree); the port has no random init.
    ``embed_texts``/``token_embeddings`` run the forward and blend the anchors on
    the host, as the reference does; ``encode_queries_device`` blends, truncates
    and casts to the engine's f16 wire on the device and leaves the result there.
    Images are not ported (ROADMAP.md, Queue 1 item 5)."""

    def __init__(
        self,
        enc_cfg: EncoderConfig,
        rag_cfg: Optional[RAGConfig] = None,
        *,
        params: Mapping[str, torch.Tensor],
        batch_size: int = 64,
        device=None,
    ) -> None:
        self.enc_cfg = enc_cfg
        self.device = resolve_device(device)
        model = Encoder(enc_cfg)
        model.load_state_dict(params)
        self.model = model.cast_for_compute().to(self.device).eval()
        self.hasher = TextHasher(enc_cfg, rag_cfg)
        self.batch_size = batch_size
        self.dim = self.enc_cfg.out_dim

    @property
    def maxsim_calibration(self) -> float:
        """Divisor renormalizing anchored MaxSim scores so an exact match scores
        about 1.0 (``ops.maxsim.calibrate_maxsim``); 1.0 without token anchors."""
        w2 = self.enc_cfg.anchor_token_w2
        return float(w2) if w2 > 0 else 1.0

    @property
    def _blend(self) -> bool:
        return self.enc_cfg.anchor_token_w2 > 0 or self.enc_cfg.anchor_pool_w2 > 0

    @torch.no_grad()
    def forward(self, ids: np.ndarray, mask: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder's raw heads (no anchors) for hashed ids and mask, on the device."""
        dev = self.device
        return self.model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))

    def _run(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        pooled_out: List[np.ndarray] = []
        tokens_out: List[np.ndarray] = []
        bs = self.batch_size
        for i in range(0, len(texts), bs):
            batch = list(texts[i : i + bs])
            pooled, tok = (x.cpu().numpy() for x in self.forward(*self.hasher.encode(batch)))
            if self._blend:
                apool, atok = anchor_arrays(batch, self.enc_cfg, self.hasher.analyzer)
                pooled, tok = blend_anchors_np(self.enc_cfg, pooled, tok, apool, atok)
            pooled_out.append(pooled)
            tokens_out.append(tok)
        if not pooled_out:
            return (np.zeros((0, self.dim), np.float32),
                    np.zeros((0, self.enc_cfg.max_tokens, self.enc_cfg.token_dim), np.float32))
        return np.concatenate(pooled_out), np.concatenate(tokens_out)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self._run(texts)[0]

    def embed_query(self, text: str) -> np.ndarray:
        # a token-less text still embeds (to the pooled head's bias direction), so
        # the guard is on the token count, not on the vector
        _, mask = self.hasher.encode([text])
        if not mask.any():
            raise ValueError(f"query produced no tokens to embed: {text!r}")
        return self._run([text])[0][0]

    def embed_images(self, images, *args, **kwargs):
        raise NotImplementedError(
            "image embedding is not ported (ROADMAP.md, Queue 1 item 5: the OCR/image mixin)"
        )

    def token_embeddings(
        self, texts: Sequence[str], max_tokens: Optional[int] = None, dim: Optional[int] = None
    ) -> np.ndarray:
        """f32[N, T, dim] unit token embeddings (MaxSim store and query side).

        ``dim`` below token_dim prefix-truncates and re-normalizes (Matryoshka);
        padding rows stay exactly zero."""
        out = self._run(texts)[1]
        if max_tokens is not None:
            out = out[:, :max_tokens]
        if dim is not None and dim < out.shape[-1]:
            out = out[..., :dim]
            norms = np.linalg.norm(out, axis=-1, keepdims=True)
            out = np.where(norms > 1e-9, out / np.maximum(norms, 1e-9), 0.0)
        return out

    def query_inputs(self, texts: Sequence[str]):
        """The host half of :meth:`encode_queries_device`: (ids, mask, apool, atok)
        as numpy, from the analyzer, the hash and the anchors."""
        ids, mask = self.hasher.encode(texts)
        apool, atok = anchor_arrays(texts, self.enc_cfg, self.hasher.analyzer)
        return ids, mask, apool, atok

    @torch.no_grad()
    def encode_device(self, ids, mask, apool, atok, *, out_dim: int, max_tokens: int,
                      token_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device half of :meth:`encode_queries_device`: forward, anchor blend,
        Matryoshka truncation of both heads, cast to f16. ``max_tokens`` must not
        exceed the encoder's."""
        dev = self.device
        pooled, tok = self.forward(ids, mask)
        if self._blend:
            pooled, tok = _blend_anchors_torch(
                self.enc_cfg, pooled, tok,
                torch.from_numpy(apool).to(dev, non_blocking=True),
                torch.from_numpy(atok).to(dev, non_blocking=True),
            )
        if out_dim < pooled.shape[-1]:  # truncate_matryoshka
            pooled = pooled[:, :out_dim]
            pooled = pooled / torch.clamp(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)
        tok = tok[:, :max_tokens]
        if token_dim < tok.shape[-1]:  # token_embeddings' truncation and renorm
            tok = tok[..., :token_dim]
            norms = torch.linalg.vector_norm(tok, dim=-1, keepdim=True)
            tok = torch.where(norms > 1e-9, tok / torch.clamp(norms, min=1e-9), 0.0)
        return pooled.half(), tok.half()

    def encode_queries_device(
        self, texts: Sequence[str], *, out_dim: int, max_tokens: int, token_dim: int
    ):
        """Encode a query batch for the engine without a copy back to the host.

        Returns ``(pooled f16[B, out_dim], tok f16[B, T, token_dim], mask bool[B, T])``:
        the two tensors stay on the device and feed the search program directly;
        ``mask`` is the host's token-occupancy mask (equal to ``tok != 0`` along the
        last axis, since padding positions stay zero). The same values, up to f16
        rounding, as ``embed_texts`` and ``token_embeddings`` give."""
        t = min(max_tokens, self.enc_cfg.max_tokens)
        ids, mask, apool, atok = self.query_inputs(texts)
        pooled, tok = self.encode_device(
            ids, mask, apool, atok, out_dim=out_dim, max_tokens=t, token_dim=token_dim
        )
        return pooled, tok, mask[:, :t]

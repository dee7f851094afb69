"""An LLM cross-encoder reranker on the device: a DeepSeek-V3 decoder (latent
attention and sparse experts) that reads a (query, document) prompt and scores it by
the probability of "yes" against "no" at its last token.

The reference's precision stage is an LLM judge behind an HTTP server (the port's
``models/http_clients.py`` ``HTTPRerankerFn``, chat rung: the system prompt
``RERANK_SYSTEM_PROMPT``, the user message built from the query and the document,
``softmax(logprob yes, logprob no)[yes]``). :class:`CrossEncoderReranker` runs the
same judgement on the device, over the placed document-token store of
:class:`DocumentStore`, with the model of :class:`CrossEncoder`.

**The model** (:class:`CrossEncoderConfig`, preset ``"moonlight-16b-a3b"``: the
published ``config.json`` of Moonlight-16B-A3B, ``model_type`` deepseek_v3; the layer
equations of DeepSeek-V3, arXiv:2412.19437, with ``q_lora_rank`` null):

* pre-norm residual blocks, RMSNorm (statistics in f32, eps ``rms_norm_eps``);
* multi-head latent attention: ``q = x Wq`` split into a 128-wide part and a 64-wide
  rotary part per head; ``[c, k_rope] = x Wkv_a``, ``c`` normed and expanded by
  ``Wkv_b`` into each head's 128-wide key part and 128-wide value; the rotary key
  part is one for all heads; RoPE (theta ``rope_theta``, pairs interleaved as the
  published code reads them) on the rotary parts; softmax scale 192^-0.5; causal;
* layer 0 a dense SwiGLU MLP (``intermediate_size``); the others a mixture of
  experts: ``s = sigmoid(x Wg)`` in f32, the top ``num_experts_per_tok`` chosen on
  ``s + e_score_correction_bias`` (``noaux_tc`` with one group), weighted by the
  unbiased ``s`` normalised over the chosen and times ``routed_scaling_factor``;
  plus the shared experts as one SwiGLU of ``n_shared_experts * moe_intermediate_size``;
* untied embedding and output head; the head computes only the "yes" and "no"
  rows at each prompt's last token (:meth:`CrossEncoder.yes_probability`;
  :meth:`CrossEncoder.logits` gives every row, for tests).

The routed experts run as grouped GEMMs over the tokens sorted by expert
(``torch._grouped_mm``: one launch for the gate and up projections together and
one for the down projection, per layer). Prompts are packed: each is its own causal
sequence with positions from 0; attention pads them to the longest of the call.
Weights, GEMM inputs and outputs are bf16; the residual stream between the blocks
stays f32 (as Megatron's ``fp32_residual_connection``), and the router reads the f32
normed stream, which halves the routes that bf16 rounding flips
(``weight_dtype="float8_e4m3fn"`` stores the matrices as e4m3 codes with a per-row
scale, dequantized to bf16 at use; it exists as the configuration's lower-precision
control).

**Shared with Kimi-Linear** (``models/kimi_linear.py``): the latent attention
(:func:`mla_attention`, with RoPE or without), the router (:func:`route`), the routed
experts (:func:`routed_experts`), the draws and the fp8 store (:func:`build_weights`),
and the layer loop, MLP and head of :class:`Decoder`. A config's ``moe`` names the
channels of each routed expert's width held here (Kimi-Linear's ``channels_first``,
``channels_held``): every route is computed, over the held channels only, which is
this chip's part of the routed sum under tensor parallelism (without its exchange).
Moonlight holds every channel, so its path and bits are as before.

**Weights.** No published checkpoint is in the repository: :func:`init_cross_encoder`
draws every tensor from a seed, each from its own generator seeded by ``(seed,
name)`` (:func:`tensor_seed`), in f32 on the device: matrices N(0, 0.02), norm
weights 1, the selection bias N(0, 0.01). A layer's routed experts are upcycled
(sparse upcycling, arXiv:2212.05055: experts start as copies of one MLP): one base
matrix plus 0.03 of each expert's own deviation, scaled back to N(0, 0.02).
Independent random experts make the 27 layers chaotic: a near-tied route that bf16
rounding flips (about 4 % of tokens in the first expert layer) changes a token's
expert outright, and by the last layer most tokens route apart from an f32
forward pass, so no tolerance would tell bf16 from fp8 weights; upcycled experts
keep a flipped route's effect small. The plain reference draws the same.

**Stand-in tokenizer** (:func:`token_ids`): the published tokenizer is not in the
repository either. Text is lower-cased and split into words and single punctuation
marks (``\\w+|[^\\w\\s]``); "yes" and "no" are the fixed ids 1 and 2, id 0 pads, and
every other token is ``3 + blake2s(token) mod (vocab_size - 3)``.

While a profiler records, a score opens, inside the caller's
``engine.staged.rerank``: ``engine.staged.rerank.pack`` (the prompts on the host
and their layout on the device), and per layer ``.attention``, ``.router``,
``.experts`` (permute, routed grouped GEMMs, combine) and ``.shared`` (the shared
experts, and layer 0's dense MLP), then ``.head``. Counters (host values only):
``rerank_xenc_prompts_total``, ``rerank_xenc_tokens_total``,
``rerank_xenc_padded_tokens_total`` (attention's padding) and
``rerank_xenc_attention_pairs_total`` (the causal pairs, sum of L (L + 1) / 2).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RAGConfig, get_settings
from ..observability import rag_metrics
from ..observability.profiling import annotate
from .http_clients import RERANK_SYSTEM_PROMPT

PAD_ID, YES_ID, NO_ID = 0, 1, 2
_FIRST_HASHED = 3
_WORD = re.compile(r"\w+|[^\w\s]")
PROMPT_QUERY = "Query: {query}\n\nDocument:\n"
PROMPT_ASK = "\n\nIs this document relevant to the query? Answer yes or no."
INIT_STD = 0.02  # matrices
BIAS_STD = 0.01  # e_score_correction_bias
UPCYCLE_EPS = 0.03  # a routed expert's own deviation from its layer's base
WEIGHT_DTYPES = ("bfloat16", "float8_e4m3fn")
_E4M3_MAX = 448.0


@dataclass(frozen=True)
class CrossEncoderConfig:
    """The decoder's shape, under the published ``config.json`` keys (every expert held)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192

    # what the equations here implement; a config that asks for another is refused
    _FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
              "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
              "tie_word_embeddings": False, "attention_bias": False, "rope_scaling": None}

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def moe(self) -> "MoEShape":
        return MoEShape(self.n_routed_experts, self.num_experts_per_tok, self.norm_topk_prob,
                        self.routed_scaling_factor, self.first_k_dense_replace,
                        (0, self.moe_intermediate_size))

    @classmethod
    def from_hf(cls, config: Mapping[str, object]) -> "CrossEncoderConfig":
        """The shape of a published ``config.json`` (other keys ignored); raises where
        it asks for a mechanism this module does not implement."""
        refuse_unsupported(config, cls._FIXED)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in names})


class MoEShape(NamedTuple):
    """The expert layers' shape under one set of names for both models: the router's
    width, its experts a token, renormalisation and scale, the leading dense layers,
    and the channels of each routed expert's width held here (first, count)."""

    experts: int
    top_k: int
    renormalize: bool
    scale: float
    dense_layers: int
    channels: Tuple[int, int]


def refuse_unsupported(config: Mapping[str, object], fixed: Mapping[str, object]) -> None:
    """Raise where a published config asks for a mechanism other than ``fixed``'s."""
    for key, want in fixed.items():
        if config.get(key, want) != want:
            raise ValueError(f"{key}={config[key]!r} is not supported (only {want!r})")


PRESETS: Dict[str, CrossEncoderConfig] = {"moonlight-16b-a3b": CrossEncoderConfig()}


def _config(preset: Union[str, CrossEncoderConfig]) -> CrossEncoderConfig:
    return PRESETS[preset] if isinstance(preset, str) else preset


# ---------------------------------------------------------------------- tokenizer


def token_id(token: str, vocab_size: int) -> int:
    if token == "yes":
        return YES_ID
    if token == "no":
        return NO_ID
    h = int.from_bytes(hashlib.blake2s(token.encode("utf-8"), digest_size=8).digest(), "little")
    return _FIRST_HASHED + h % (vocab_size - _FIRST_HASHED)


def token_ids(text: str, vocab_size: int) -> List[int]:
    """The stand-in tokenizer: one id per lower-cased word or punctuation mark."""
    return [token_id(t, vocab_size) for t in _WORD.findall(text.lower())]


def prompt_parts(query: str, vocab_size: int) -> Tuple[List[int], List[int]]:
    """The ids before and after the document in the chat rung's prompt: the system
    prompt and ``Query: ... Document:``, then the question that asks for yes or no."""
    head = RERANK_SYSTEM_PROMPT + "\n" + PROMPT_QUERY.format(query=query)
    return token_ids(head, vocab_size), token_ids(PROMPT_ASK, vocab_size)


# ---------------------------------------------------------------------- weights


def tensor_seed(seed: int, name: str) -> int:
    """The seed of one tensor's generator: 63 bits of SHA-256 of ``seed`` and ``name``."""
    digest = hashlib.sha256(f"{int(seed)}\x00{name}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(name: str, seed: int, device) -> torch.Generator:
    """The generator of the tensor ``name`` under ``seed`` on ``device``."""
    return torch.Generator(device=torch.device(device)).manual_seed(tensor_seed(seed, name))


def draw(name: str, shape: Sequence[int], seed: int, device, std: float) -> torch.Tensor:
    """f32 N(0, std^2) of ``shape`` from the generator of ``(seed, name)`` on ``device``."""
    dev = torch.device(device)
    gen = generator(name, seed, dev)
    return torch.randn(tuple(shape), generator=gen, device=dev, dtype=torch.float32) * std


def mla_shapes(cfg, p: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The latent attention's tensors of the layer with prefix ``p`` (``cfg`` has the
    DeepSeek-V3 attention keys)."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    return {
        p + "self_attn.q_proj.weight": ((nh * cfg.qk_head_dim, h), "matrix"),
        p + "self_attn.kv_a_proj_with_mqa.weight":
            ((cfg.kv_lora_rank + cfg.qk_rope_head_dim, h), "matrix"),
        p + "self_attn.kv_a_layernorm.weight": ((cfg.kv_lora_rank,), "norm"),
        p + "self_attn.kv_b_proj.weight":
            ((nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank), "matrix"),
        p + "self_attn.o_proj.weight": ((h, nh * cfg.v_head_dim), "matrix"),
    }


def ffn_shapes(cfg, i: int, shared_width: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Layer ``i``'s MLP: the dense SwiGLU of ``intermediate_size`` in the leading dense
    layers, else the router (its bias), the routed experts stacked over the router's
    whole width, and the shared SwiGLU of ``shared_width``."""
    h, p, moe = cfg.hidden_size, f"model.layers.{i}.", cfg.moe
    if i < moe.dense_layers:
        w = cfg.intermediate_size
        return {p + "mlp.gate_proj.weight": ((w, h), "matrix"),
                p + "mlp.up_proj.weight": ((w, h), "matrix"),
                p + "mlp.down_proj.weight": ((h, w), "matrix")}
    e, w, sw = moe.experts, cfg.moe_intermediate_size, shared_width
    return {
        p + "mlp.gate.weight": ((e, h), "matrix"),
        p + "mlp.gate.e_score_correction_bias": ((e,), "bias"),
        p + "mlp.experts.gate_proj.weight": ((e, w, h), "matrix"),
        p + "mlp.experts.up_proj.weight": ((e, w, h), "matrix"),
        p + "mlp.experts.down_proj.weight": ((e, h, w), "matrix"),
        p + "mlp.shared_experts.gate_proj.weight": ((sw, h), "matrix"),
        p + "mlp.shared_experts.up_proj.weight": ((sw, h), "matrix"),
        p + "mlp.shared_experts.down_proj.weight": ((h, sw), "matrix"),
    }


def weight_shapes(cfg: CrossEncoderConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every tensor of the model: name -> (shape, kind), kind "matrix", "norm" or "bias".
    Names follow the published checkpoint's, with each layer's routed experts
    stacked (``mlp.experts.gate_proj.weight`` [experts, width, hidden])."""
    h = cfg.hidden_size
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "model.embed_tokens.weight": ((cfg.vocab_size, h), "matrix")}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = ((h,), "norm")
        out.update(mla_shapes(cfg, p))
        out[p + "post_attention_layernorm.weight"] = ((h,), "norm")
        out.update(ffn_shapes(cfg, i, cfg.n_shared_experts * cfg.moe_intermediate_size))
    out["model.norm.weight"] = ((h,), "norm")
    out["lm_head.weight"] = ((cfg.vocab_size, h), "matrix")
    return out


def init_tensor(name: str, shape: Sequence[int], kind: str, seed: int, device) -> torch.Tensor:
    """One tensor in f32 as :func:`init_cross_encoder` draws it. A layer's routed
    experts are upcycled: each is one base matrix (drawn under the name with
    ``mlp.experts.base.``) plus ``UPCYCLE_EPS`` of a deviation of its own, scaled back
    to N(0, 0.02)."""
    if kind == "norm":
        return torch.ones(tuple(shape), dtype=torch.float32, device=torch.device(device))
    if kind == "bias":
        return draw(name, shape, seed, device, BIAS_STD)
    if ".mlp.experts." not in name:
        return draw(name, shape, seed, device, INIT_STD)
    base = draw(name.replace(".mlp.experts.", ".mlp.experts.base."), shape[1:], seed, device, 1.0)
    out = draw(name, shape, seed, device, UPCYCLE_EPS)
    out += base[None]
    return out.mul_(INIT_STD / (1.0 + UPCYCLE_EPS ** 2) ** 0.5)


class Fp8Weight(NamedTuple):
    """A matrix as e4m3 codes and one f32 scale per output row (absmax / 448)."""

    codes: torch.Tensor
    scale: torch.Tensor  # f32[..., rows, 1]

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.codes.to(torch.float32) * self.scale).to(dtype)


def quantize_e4m3(w: torch.Tensor) -> Fp8Weight:
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=-1, keepdim=True), min=1e-12) / _E4M3_MAX
    return Fp8Weight((w / scale).to(torch.float8_e4m3fn), scale)


Weight = Union[torch.Tensor, Fp8Weight]


def _dense(w: Weight, dtype) -> torch.Tensor:
    return w.dequant(dtype) if isinstance(w, Fp8Weight) else w


# the experts' gate and up projections, kept as one stacked matrix a layer
EXPERT_STACK = ((".mlp.experts.gate_proj.", ".mlp.experts.up_proj."), "mlp.experts.gate_up", 1)
KEEP_DENSE = ("model.embed_tokens.weight", "lm_head.weight", "mlp.gate.weight")


def build_weights(shapes: Mapping[str, Tuple[Sequence[int], str]], seed: int, device,
                  weight_dtype: str, dtype: torch.dtype, channels: Tuple[int, int],
                  init=init_tensor, stacks=(EXPERT_STACK,), keep_dense=KEEP_DENSE,
                  keep_f32=("bias",)) -> Dict[str, Weight]:
    """Draw every tensor of ``shapes`` with ``init`` and store it: in ``dtype``, f32
    for names ending in ``keep_f32``; under ``weight_dtype`` "float8_e4m3fn" every
    matrix not named in ``keep_dense`` as e4m3 with per-row scales. The routed experts
    are drawn whole and keep the ``channels`` (first, count) of their width: the gate
    and up projections' rows, the down projection's columns. Each ``stacks`` entry
    (member markers, name, axis) joins a layer's members into one tensor under
    ``<layer prefix>.<name>``."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"cross_encoder_weight_dtype must be one of {WEIGHT_DTYPES}")
    fp8 = weight_dtype == "float8_e4m3fn"
    first, count = channels
    weights: Dict[str, Weight] = {}

    def store(name: str, t: torch.Tensor) -> None:
        if fp8 and t.dim() >= 2 and not name.endswith(keep_dense):
            weights[name] = quantize_e4m3(t.to(dtype))
        else:
            weights[name] = t.to(torch.float32 if name.endswith(keep_f32) else dtype)

    pending: Dict[str, List[torch.Tensor]] = {}
    for name, (shape, kind) in shapes.items():
        t = init(name, shape, kind, seed, device)
        if ".mlp.experts." in name:
            axis = 2 if "down_proj" in name else 1
            if count != t.shape[axis]:
                t = t.narrow(axis, first, count)
        for members, target, axis in stacks:
            marker = next((m for m in members if m in name), None)
            if marker is None:
                continue
            key = name.rsplit(marker, 1)[0] + "." + target
            pending.setdefault(key, []).append(t.to(dtype))
            if len(pending[key]) == len(members):
                store(key, torch.cat(pending.pop(key), axis))
            break
        else:
            store(name, t)
        del t
    return weights


# ---------------------------------------------------------------------- the blocks


class Packed(NamedTuple):
    """A call's prompts, packed on the device: ``tokens`` i64[T] (prompt after
    prompt), ``pos`` i64[T] each token's position in its prompt, ``pad_index``
    i64[T] its slot in the [B, width] padded layout attention reads, ``source``
    i64[B * width] the packed token each slot reads (token 0 past a prompt's end),
    ``last`` i64[B] each prompt's last token in the packed order."""

    tokens: torch.Tensor
    pos: torch.Tensor
    pad_index: torch.Tensor
    source: torch.Tensor
    last: torch.Tensor
    batch: int
    width: int


def _layout(lengths: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """(pos, pad_index, source, last) of prompts of host ``lengths``, computed on the
    host and copied to ``device`` at once."""
    b, width = len(lengths), int(lengths.max())
    starts = np.cumsum(lengths) - lengths
    t = int(lengths.sum())
    pos = np.arange(t, dtype=np.int64) - np.repeat(starts, lengths)
    slot = np.repeat(np.arange(b, dtype=np.int64) * width, lengths) + pos
    source = np.zeros(b * width, np.int64)
    source[slot] = np.arange(t)
    idx = torch.from_numpy(np.concatenate([pos, slot, source, starts + lengths - 1])).to(device)
    return idx[:t], idx[t:2 * t], idx[2 * t:2 * t + b * width], idx[2 * t + b * width:]


def pack(prompts: Sequence[Sequence[int]], device) -> Packed:
    """Pack prompts of host ids (each at least one token) on ``device``."""
    lengths = np.array([len(p) for p in prompts], np.int64)
    tokens = torch.from_numpy(np.concatenate([np.asarray(p, np.int64) for p in prompts]))
    return Packed(tokens.to(device), *_layout(lengths, device), len(prompts), int(lengths.max()))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics, cast back before the weight (the published code)."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE over the last axis: pairs (2i, 2i + 1) de-interleaved, then rotated by
    half (the published ``apply_rotary_pos_emb``); ``cos``/``sin`` [T, 1, d]."""
    t, h, d = x.shape
    x = x.reshape(t, h, d // 2, 2).transpose(-1, -2).reshape(t, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + half * sin


def linear(x: torch.Tensor, w: Weight, dtype) -> torch.Tensor:
    return F.linear(x, _dense(w, dtype))


def mla_attention(x: torch.Tensor, w: Mapping[str, Weight], p: str, batch: Packed, cfg,
                  dtype, rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """``x`` plus the latent attention of the layer with prefix ``p`` over the packed
    prompts: the input norm, the projections, RoPE on the 64-wide parts where
    ``rope`` gives (cos, sin) and none where it is None (the parts stay, unrotated),
    causal attention at scale ``qk_head_dim``^-1/2, the output projection."""
    t, nh = x.shape[0], cfg.num_attention_heads
    h = rms_norm(x, w[p + "input_layernorm.weight"], cfg.rms_norm_eps).to(dtype)
    q = linear(h, w[p + "self_attn.q_proj.weight"], dtype).view(t, nh, cfg.qk_head_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    latent, k_rope = linear(h, w[p + "self_attn.kv_a_proj_with_mqa.weight"], dtype).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    latent = rms_norm(latent, w[p + "self_attn.kv_a_layernorm.weight"], cfg.rms_norm_eps)
    kv = linear(latent, w[p + "self_attn.kv_b_proj.weight"], dtype).view(
        t, nh, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    k_rope = k_rope[:, None, :]
    if rope is not None:
        q_rope, k_rope = _rotate(q_rope, *rope), _rotate(k_rope, *rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(t, nh, cfg.qk_rope_head_dim)], dim=-1)
    b, width = batch.batch, batch.width

    def padded(a: torch.Tensor) -> torch.Tensor:
        if b == 1:
            return a[None].transpose(1, 2)
        return a[batch.source].view(b, width, nh, a.shape[-1]).transpose(1, 2)

    # right-padded prompts under a causal mask: a real token sees only its own
    # prompt's earlier tokens, so no padding mask is needed, and the slots past
    # a prompt's end may hold any token's values (they read token 0's)
    o = F.scaled_dot_product_attention(padded(q), padded(k), padded(v), is_causal=True,
                                       scale=cfg.qk_head_dim ** -0.5)
    o = o.transpose(1, 2).reshape(b * width, nh * cfg.v_head_dim)
    if b > 1:
        o = o[batch.pad_index]
    return x + linear(o, w[p + "self_attn.o_proj.weight"], dtype)


def swiglu(h: torch.Tensor, w: Mapping[str, Weight], p: str, dtype) -> torch.Tensor:
    g = linear(h, w[p + "gate_proj.weight"], dtype)
    u = linear(h, w[p + "up_proj.weight"], dtype)
    return linear(F.silu(g) * u, w[p + "down_proj.weight"], dtype)


def route(h: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
          moe: MoEShape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts i64[T, k], weights f32[T, k]) over the router's whole width: chosen on
    the sigmoid scores (f32) plus the selection bias, weighted by the unbiased
    scores, normalised over the chosen and scaled."""
    scores = F.linear(h.float(), gate.float()).sigmoid()
    idx = torch.topk(scores + bias, moe.top_k, dim=-1, sorted=False).indices
    wts = scores.gather(1, idx)
    if moe.renormalize:
        wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, wts * moe.scale


def routed_experts(h: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor, gate_up: torch.Tensor,
                   down: torch.Tensor, experts: int) -> torch.Tensor:
    """The routed experts' weighted sum over the channels that ``gate_up`` / ``down``
    hold of each expert's width: the (token, expert) pairs sorted by expert, two
    grouped GEMMs (gate and up together, then down), the weights applied and summed in
    f32 in each token's own order."""
    t, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.cumsum(torch.bincount(flat, minlength=experts), 0).to(torch.int32)
    xs = h[order // k]
    g, u = torch._grouped_mm(xs, gate_up.transpose(-2, -1), offs=ends).chunk(2, dim=-1)
    del xs
    y = torch._grouped_mm(F.silu(g) * u, down.transpose(-2, -1), offs=ends)
    del g, u
    out = y[torch.argsort(order)]  # each token's k rows back in its own order
    del y
    return (out.view(t, k, -1).float() * wts[..., None]).sum(dim=1)


class Decoder:
    """What the cross-encoder models share: the weights on one device, the MLP of each
    layer (the dense SwiGLU, or the router, the routed experts' held channels and the
    shared SwiGLU), the final norm and the yes/no head. A model gives the token mixer
    of each layer (:meth:`_mixer`) and what its mixers read of a call
    (:meth:`_context`)."""

    def __init__(self, cfg, weights: Dict[str, Weight], dtype: torch.dtype = torch.bfloat16) -> None:
        self.cfg = cfg
        self.moe: MoEShape = cfg.moe
        self.dtype = dtype
        self.w = weights
        self.device = weights["model.embed_tokens.weight"].device
        self.yes_no = weights["lm_head.weight"][[YES_ID, NO_ID]].float()

    def nbytes(self) -> int:
        total = 0
        for w in self.w.values():
            for t in (w if isinstance(w, Fp8Weight) else (w,)):
                total += t.numel() * t.element_size()
        return total

    def _lin(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return linear(x, self.w[name], self.dtype)

    def route(self, h: torch.Tensor, p: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(experts i64[T, k], weights f32[T, k]) of layer ``p``'s router."""
        return route(h, self.w[p + "mlp.gate.weight"], self.w[p + "mlp.gate.e_score_correction_bias"],
                     self.moe)

    def _experts(self, h: torch.Tensor, p: str, idx: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
        return routed_experts(h, idx, wts, _dense(self.w[p + "mlp.experts.gate_up"], self.dtype),
                              _dense(self.w[p + "mlp.experts.down_proj.weight"], self.dtype),
                              self.moe.experts)

    def _ffn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        cfg = self.cfg
        p = f"model.layers.{i}."
        if i < self.moe.dense_layers:
            with annotate("engine.staged.rerank.shared"):
                h = rms_norm(x, self.w[p + "post_attention_layernorm.weight"], cfg.rms_norm_eps)
                return x + swiglu(h.to(self.dtype), self.w, p + "mlp.", self.dtype)
        with annotate("engine.staged.rerank.router"):
            h = rms_norm(x, self.w[p + "post_attention_layernorm.weight"], cfg.rms_norm_eps)
            idx, wts = self.route(h, p)
            h = h.to(self.dtype)
        with annotate("engine.staged.rerank.experts"):
            routed = self._experts(h, p, idx, wts)
        with annotate("engine.staged.rerank.shared"):
            return x + (routed + swiglu(h, self.w, p + "mlp.shared_experts.", self.dtype))

    def _context(self, batch: Packed):
        return None

    def _mixer(self, x: torch.Tensor, i: int, batch: Packed, ctx) -> torch.Tensor:
        raise NotImplementedError

    def hidden(self, batch: Packed) -> torch.Tensor:
        """The last layer's output of every packed token, before the final norm."""
        # the residual stream between the blocks stays f32
        x = _dense(self.w["model.embed_tokens.weight"], self.dtype)[batch.tokens].float()
        ctx = self._context(batch)
        for i in range(self.cfg.num_hidden_layers):
            x = self._mixer(x, i, batch, ctx)
            x = self._ffn(x, i)
        return x

    @torch.no_grad()
    def logits(self, batch: Packed) -> torch.Tensor:
        """f32[T, vocab]: every position's logits (the whole head in f32; for tests)."""
        h = rms_norm(self.hidden(batch), self.w["model.norm.weight"], self.cfg.rms_norm_eps)
        return F.linear(h.float(), _dense(self.w["lm_head.weight"], self.dtype).float())

    @torch.no_grad()
    def yes_probability(self, batch: Packed) -> torch.Tensor:
        """f32[B]: softmax over the "yes" and "no" logits at each prompt's last token.
        The head computes those two rows only, in f32."""
        x = self.hidden(batch)
        with annotate("engine.staged.rerank.head"):
            h = rms_norm(x[batch.last], self.w["model.norm.weight"], self.cfg.rms_norm_eps)
            return torch.softmax(h.float() @ self.yes_no.T, dim=-1)[:, 0]


class CrossEncoder(Decoder):
    """Moonlight's decoder: latent attention with RoPE in every layer."""

    def __init__(self, cfg: CrossEncoderConfig, weights: Dict[str, Weight],
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(cfg, weights, dtype)
        half = cfg.qk_rope_head_dim // 2
        self.inv_freq = 1.0 / (cfg.rope_theta ** (
            torch.arange(0, half, dtype=torch.float32, device=self.device) * 2.0 / cfg.qk_rope_head_dim))

    def _context(self, batch: Packed) -> Tuple[torch.Tensor, torch.Tensor]:
        freqs = batch.pos.float()[:, None] * self.inv_freq[None, :]
        emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
        return emb.cos().to(self.dtype), emb.sin().to(self.dtype)

    def _mixer(self, x: torch.Tensor, i: int, batch: Packed, ctx) -> torch.Tensor:
        with annotate("engine.staged.rerank.attention"):
            return mla_attention(x, self.w, f"model.layers.{i}.", batch, self.cfg, self.dtype, ctx)


def init_cross_encoder(preset: Union[str, CrossEncoderConfig], seed: int, device,
                       weight_dtype: str = "bfloat16",
                       dtype: torch.dtype = torch.bfloat16) -> CrossEncoder:
    """The decoder with weights drawn from ``seed`` on ``device`` (module docstring),
    cast to ``dtype``; under ``weight_dtype`` "float8_e4m3fn" every projection matrix
    (attention, MLPs, experts) is stored as e4m3 with per-row scales. Each layer's
    routed gate and up projections are kept as one stacked matrix
    (``mlp.experts.gate_up``, [experts, 2 * width, hidden])."""
    cfg = _config(preset)
    weights = build_weights(weight_shapes(cfg), seed, device, weight_dtype, dtype, cfg.moe.channels)
    return CrossEncoder(cfg, weights, dtype)


# ---------------------------------------------------------------------- documents

PROMPT_ROOM = 256  # positions kept for the prompt around a document


def document_budget(cfg: CrossEncoderConfig) -> int:
    """The most tokens of a document that a prompt holds."""
    return cfg.max_position_embeddings - PROMPT_ROOM


class DocumentStore:
    """Each parent's document as token ids, placed: ``ids`` i32[P, width] (0 past the
    end), ``lengths`` i32[P]; the lengths are kept on the host too, so a call knows its
    prompts' lengths without reading the device."""

    def __init__(self, ids: torch.Tensor, lengths: torch.Tensor) -> None:
        self.ids = ids.to(torch.int32).contiguous()
        self.lengths = lengths.to(torch.int32).to(self.ids.device)
        self.lengths_host = lengths.cpu().numpy().astype(np.int64)

    @classmethod
    def from_texts(cls, texts: Sequence[str], vocab_size: int, max_tokens: int,
                   device) -> "DocumentStore":
        """Tokenize each text once (at most ``max_tokens`` ids; an empty text keeps one
        pad)."""
        docs = [token_ids(t, vocab_size)[:max_tokens] or [PAD_ID] for t in texts]
        n = max(len(docs), 1)
        width = max([len(d) for d in docs] + [1])
        ids = np.zeros((n, width), np.int32)
        lengths = np.ones(n, np.int32)
        for i, d in enumerate(docs):
            ids[i, : len(d)] = d
            lengths[i] = len(d)
        dev = torch.device(device)
        return cls(torch.from_numpy(ids).to(dev), torch.from_numpy(lengths))

    def prompts(self, head: torch.Tensor, n_head: int, tail: torch.Tensor,
                parents: np.ndarray) -> Tuple[Packed, np.ndarray]:
        """The packed prompts ``head + document + tail`` of ``parents`` (host rows),
        built on the device from the store, and their lengths."""
        dev = self.ids.device
        doc_len = self.lengths_host[parents]
        n_doc, n_tail = int(doc_len.max()), tail.shape[0]
        lengths = n_head + doc_len + n_tail
        b = parents.shape[0]
        rows = torch.from_numpy(parents.astype(np.int64)).to(dev)
        pos, pad_index, source, last = _layout(lengths, dev)
        width = int(lengths.max())
        grid = torch.zeros((b, width), dtype=torch.int64, device=dev)
        grid[:, :n_head] = head
        grid[:, n_head:n_head + n_doc] = self.ids[rows, :n_doc]
        at = n_head + self.lengths[rows].long()[:, None] + torch.arange(n_tail, device=dev)
        grid.scatter_(1, at, tail.expand(b, n_tail))
        return Packed(grid.view(-1)[pad_index], pos, pad_index, source, last, b, width), lengths


def document_arrays(model: CrossEncoder, texts: Sequence[str], device) -> Dict[str, object]:
    """What ``rerank_backend="cross_encoder"`` places for a corpus, under the keys of
    :meth:`IndexState.from_numpy <triple_hybrid_rag_tpu_torch.index.state.IndexState.from_numpy>`:
    each parent text tokenized once (``xenc_doc_ids``, ``xenc_doc_len``; at most the
    model's document budget) and the model (``xenc_model``)."""
    store = DocumentStore.from_texts(texts, model.cfg.vocab_size, document_budget(model.cfg), device)
    return {"xenc_doc_ids": store.ids, "xenc_doc_len": store.lengths, "xenc_model": model}


class CrossEncoderReranker:
    """The ``Reranker`` protocol over the cross-encoder: the valid candidates in fused
    order, at most ``rerank_max_candidates``, each distinct parent judged once; f32[K]
    yes-probabilities, invalid and capped-off slots 0. The query context may hold
    ``xenc_head`` / ``xenc_tail`` (the prompt's ids around the document, on the
    device, as :meth:`query_context` makes them); else they are made here from
    ``query_text``. ``doc_ids``, ``doc_len``: the placed :func:`document_arrays`."""

    def __init__(self, model: CrossEncoder, doc_ids: torch.Tensor, doc_len: torch.Tensor,
                 config: Optional[RAGConfig] = None) -> None:
        self.model = model
        self.store = DocumentStore(doc_ids, doc_len)
        self.config = config or get_settings()

    def query_context(self, query: str) -> Dict[str, torch.Tensor]:
        """The query's prompt ids around the document, made on the host (in the range
        ``engine.staged.rerank.pack``) and copied to the model's device (in the
        caller's range)."""
        with annotate("engine.staged.rerank.pack"):
            head, tail = prompt_parts(query, self.model.cfg.vocab_size)
            ids = torch.tensor(head + tail, dtype=torch.int64)
        ids = ids.to(self.model.device)
        return {"xenc_head": ids[: len(head)], "xenc_tail": ids[len(head):]}

    def score(self, query_ctx: dict, ids: torch.Tensor, fused_scores: torch.Tensor) -> torch.Tensor:
        ids_np = ids.cpu().numpy()
        out = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        valid = np.flatnonzero(ids_np >= 0)[: max(1, int(self.config.rerank_max_candidates))]
        if valid.size == 0:
            return out
        with annotate("engine.staged.rerank.pack"):
            parents, inverse = np.unique(ids_np[valid], return_inverse=True)
            ctx = query_ctx if "xenc_head" in query_ctx else self.query_context(
                str(query_ctx.get("query_text", "")))
            head, tail = ctx["xenc_head"], ctx["xenc_tail"]
            batch, lengths = self.store.prompts(head, head.shape[0], tail, parents)
        p = self.model.yes_probability(batch)
        with annotate("engine.staged.rerank.head"):
            sel = torch.from_numpy(np.stack([valid, inverse]).astype(np.int64)).to(ids.device)
            out[sel[0]] = p[sel[1]].to(out.device)
        if self.config.metrics_enabled:
            tokens = int(lengths.sum())
            rag_metrics.counter("rerank_xenc_prompts_total").inc(len(lengths))
            rag_metrics.counter("rerank_xenc_tokens_total").inc(tokens)
            rag_metrics.counter("rerank_xenc_padded_tokens_total").inc(
                len(lengths) * int(lengths.max()) - tokens)
            rag_metrics.counter("rerank_xenc_attention_pairs_total").inc(
                int((lengths * (lengths + 1) // 2).sum()))
        return out

"""Kimi-Linear-48B-A3B-Instruct as the on-device cross-encoder: a hybrid decoder of
Kimi Delta Attention (KDA, a gated linear recurrence) and latent attention, with
sparse experts, behind the same reranker rung as Moonlight
(:class:`~triple_hybrid_rag_tpu_torch.models.cross_encoder.CrossEncoderReranker`).

**The model** (:class:`KimiLinearConfig`, preset ``"kimi-linear-48b-a3b"`` of
:data:`PRESETS`: the
published ``config.json``, ``model_type`` kimi_linear; the layer equations of the Kimi
Linear technical report, arXiv:2510.26692), pre-norm residual blocks with RMSNorm:

* the layers of ``linear_attn_config.kda_layers`` (counted from 1 as published) mix
  tokens by KDA, 32 heads of 128: ``q, k, v = SiLU(conv4(W x))``, a causal depthwise
  convolution of width ``short_conv_kernel_size`` that restarts at each prompt's
  first token; q and k L2-normalised per head; the per-channel log-decay ``g =
  -exp(A_log[h]) softplus(W_fb W_fa x + dt_bias)``; the write strength ``beta =
  sigmoid(W_b x)`` a head; the chunked delta rule, its state f32 and zero at each
  prompt's start, scale 128^-1/2; then the per-head RMSNorm of the output times
  ``sigmoid(W_gb W_ga x)``, and the output projection. Everything between the
  projections and the output projection is ``ops/kda.kda_layer`` (in f32; one kernel,
  ``csrc/kda.cu``, on the card);
* the layers of ``full_attn_layers`` are Moonlight's latent attention with no
  rotation (``mla_use_nope``; the 64-wide query and key parts stay, unrotated; scale
  192^-1/2), through the shared ``cross_encoder.mla_attention``;
* layer 1 a dense SwiGLU of ``intermediate_size``; the others the shared expert
  layer of ``cross_encoder``: the router over all ``num_experts`` (sigmoid in f32,
  top ``num_experts_per_token`` on the scores plus a selection bias, the unbiased
  weights renormalised and times ``routed_scaling_factor``), the routed experts'
  held channels by grouped GEMMs, and one shared SwiGLU of ``num_shared_experts *
  moe_intermediate_size``.

**The expert share.** The config names the channels of each routed expert's width
held here (``channels_first``, ``channels_held``; default all): the gate and up
projections' rows and the down projection's columns. The router keeps its width and
its top 8, and every route is computed over the held channels: this chip's part of
the routed sum under tensor parallelism, which the other chips' parts complete by a
sum (not made on one chip). A route that rounding flips between two experts swaps
two near-equal (upcycled) experts' parts, as in the uncut model; a share by whole
experts would add or drop an expert's whole part there. The shared expert is whole
on each chip.

**Weights** from a seed, as Moonlight's (``cross_encoder.build_weights``: each tensor
from its own generator of ``(seed, name)``, the upcycled experts drawn whole and cut
to the held channels, so that two shares draw the uncut layer's), and for KDA's own
parameters the published code's initialisations: ``A_log`` = log U(1, 16), ``dt_bias`` the inverse softplus of
a dt log-uniform in [1e-3, 1e-1] (floored at 1e-4), the convolutions U(-1/2, 1/2);
the gated norm's weight 1. ``A_log`` and ``dt_bias`` stay f32; under
``weight_dtype="float8_e4m3fn"`` (the control) every projection, the KDA ones too, is
stored as e4m3 with per-row scales, and the convolutions stay in ``dtype``.

While a profiler records, each KDA layer opens ``engine.staged.rerank.kda`` (the
input norm, the projections, convolutions, gates, the kernel, the gated norm and the
output projection); the latent attention layers ``.attention``; the expert layers
``.router``, ``.experts`` and ``.shared`` as Moonlight's.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..observability.profiling import annotate
from ..ops.kda import kda_layer
from . import cross_encoder as X

CONV_BOUND = 0.5  # U(-1/2, 1/2): nn.Conv1d's default, 1 / sqrt(the fan-in of 4)
A_LOG_RANGE = (1.0, 16.0)  # A = exp(A_log) ~ U(1, 16)
DT_RANGE = (1e-3, 1e-1)  # dt log-uniform, floored at DT_FLOOR
DT_FLOOR = 1e-4
_KDA = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)
_MLA = (4, 8, 12, 16, 20, 24, 27)


@dataclass(frozen=True)
class KimiLinearConfig:
    """The decoder's shape, under the published ``config.json`` keys (those of
    ``linear_attn_config`` flattened), and the channels of each routed expert held here."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    rms_norm_eps: float = 1e-5
    model_max_length: int = 1048576
    kda_layers: Tuple[int, ...] = _KDA  # counted from 1, as published
    full_attn_layers: Tuple[int, ...] = _MLA
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    channels_first: int = 0
    channels_held: Optional[int] = None

    # what the equations here implement; a config that asks for another is refused
    _FIXED = {"model_type": "kimi_linear", "q_lora_rank": None, "mla_use_nope": True,
              "moe_router_activation_func": "sigmoid", "use_grouped_topk": True,
              "num_expert_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
              "tie_word_embeddings": False, "rope_scaling": None}

    def __post_init__(self) -> None:
        layers = set(range(1, self.num_hidden_layers + 1))
        kda, mla = set(self.kda_layers), set(self.full_attn_layers)
        if kda & mla or kda | mla != layers:
            raise ValueError("kda_layers and full_attn_layers must split the layers 1..num_hidden_layers")
        channel_range(self.moe_intermediate_size, self.channels_first, self.channels_held)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def max_position_embeddings(self) -> int:
        return self.model_max_length

    @property
    def kda_index(self) -> frozenset:
        """The KDA layers, counted from 0."""
        return frozenset(i - 1 for i in self.kda_layers)

    @property
    def moe(self) -> X.MoEShape:
        return X.MoEShape(self.num_experts, self.num_experts_per_token, self.moe_renormalize,
                          self.routed_scaling_factor, self.first_k_dense_replace,
                          channel_range(self.moe_intermediate_size, self.channels_first, self.channels_held))

    @classmethod
    def from_hf(cls, config: Mapping[str, object], channels_first: int = 0,
                channels_held: Optional[int] = None) -> "KimiLinearConfig":
        """The shape of a published ``config.json`` (other keys ignored), holding
        ``channels_held`` channels of each routed expert from ``channels_first`` (default
        all); raises where it asks for a mechanism this module does not implement."""
        X.refuse_unsupported(config, cls._FIXED)
        lac = dict(config.get("linear_attn_config") or {})
        flat = {"kda_layers": tuple(lac.get("kda_layers", _KDA)),
                "full_attn_layers": tuple(lac.get("full_attn_layers", _MLA)),
                "kda_num_heads": lac.get("num_heads", 32), "kda_head_dim": lac.get("head_dim", 128),
                "short_conv_kernel_size": lac.get("short_conv_kernel_size", 4)}
        names = {f.name for f in dataclasses.fields(cls)} - set(flat) - {"channels_first", "channels_held"}
        kw = {k: v for k, v in config.items() if k in names}
        return cls(**kw, **flat, channels_first=channels_first, channels_held=channels_held)


def channel_range(width: int, first: int, held: Optional[int]) -> Tuple[int, int]:
    """(first, count) of the channels of each routed expert's ``width`` held here;
    ``held`` None is every channel from ``first``."""
    count = width - first if held is None else int(held)
    if first < 0 or count < 1 or first + count > width:
        raise ValueError(f"channels {first}..{first + count - 1} are not within the experts' width {width}")
    return int(first), count


PRESETS: Dict[str, KimiLinearConfig] = {"kimi-linear-48b-a3b": KimiLinearConfig()}


# ---------------------------------------------------------------------- weights


def kda_shapes(cfg: KimiLinearConfig, p: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """A KDA layer's tensors under the published checkpoint's names (the convolutions
    [channels, width])."""
    h, nh, hd = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim
    width, a = nh * hd, p + "self_attn."
    out = {}
    for z in "qkv":
        out[a + f"{z}_proj.weight"] = ((width, h), "matrix")
        out[a + f"{z}_conv1d.weight"] = ((width, cfg.short_conv_kernel_size), "conv")
    out.update({
        a + "A_log": ((nh,), "a_log"),
        a + "f_a_proj.weight": ((hd, h), "matrix"),
        a + "f_b_proj.weight": ((width, hd), "matrix"),
        a + "dt_bias": ((width,), "dt_bias"),
        a + "b_proj.weight": ((nh, h), "matrix"),
        a + "g_a_proj.weight": ((hd, h), "matrix"),
        a + "g_b_proj.weight": ((width, hd), "matrix"),
        a + "o_norm.weight": ((hd,), "norm"),
        a + "o_proj.weight": ((h, width), "matrix"),
    })
    return out


def weight_shapes(cfg: KimiLinearConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every tensor of the model: name -> (shape, kind). Latent attention and the
    expert layers under Moonlight's names (``cross_encoder.mla_shapes`` /
    ``ffn_shapes``, the experts stacked whole)."""
    h = cfg.hidden_size
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "model.embed_tokens.weight": ((cfg.vocab_size, h), "matrix")}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = ((h,), "norm")
        out.update(kda_shapes(cfg, p) if i in cfg.kda_index else X.mla_shapes(cfg, p))
        out[p + "post_attention_layernorm.weight"] = ((h,), "norm")
        out.update(X.ffn_shapes(cfg, i, cfg.num_shared_experts * cfg.moe_intermediate_size))
    out["model.norm.weight"] = ((h,), "norm")
    out["lm_head.weight"] = ((cfg.vocab_size, h), "matrix")
    return out


def init_tensor(name: str, shape: Sequence[int], kind: str, seed: int, device) -> torch.Tensor:
    """One tensor in f32: KDA's convolutions, ``A_log`` and ``dt_bias`` as the module
    docstring says; every other kind as ``cross_encoder.init_tensor``."""
    dev = torch.device(device)
    if kind not in ("conv", "a_log", "dt_bias"):
        return X.init_tensor(name, shape, kind, seed, device)
    u = torch.rand(tuple(shape), generator=X.generator(name, seed, dev), device=dev, dtype=torch.float32)
    if kind == "conv":
        return (u * 2 - 1) * CONV_BOUND
    if kind == "a_log":
        lo, hi = A_LOG_RANGE
        return torch.log(u * (hi - lo) + lo)
    lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
    dt = torch.exp(u * (hi - lo) + lo).clamp(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt


# ---------------------------------------------------------------------- the model


class KimiLinear(X.Decoder):
    """Kimi-Linear's decoder: KDA and latent attention layers, the shared expert layer."""

    def _context(self, batch: X.Packed) -> torch.Tensor:
        """The prompts' bounds i32[B + 1] in the packed order, made on the device."""
        zero = torch.zeros(1, dtype=batch.last.dtype, device=batch.last.device)
        return torch.cat([zero, batch.last + 1]).to(torch.int32)

    def _mixer(self, x: torch.Tensor, i: int, batch: X.Packed, cu_seqlens: torch.Tensor) -> torch.Tensor:
        p = f"model.layers.{i}."
        if i in self.cfg.kda_index:
            with annotate("engine.staged.rerank.kda"):
                return self._kda(x, p, cu_seqlens)
        with annotate("engine.staged.rerank.attention"):
            return X.mla_attention(x, self.w, p, batch, self.cfg, self.dtype, None)

    def _kda(self, x: torch.Tensor, p: str, cu_seqlens: torch.Tensor) -> torch.Tensor:
        """``x`` plus the KDA block: the input norm, the projections, then
        ``ops/kda.kda_layer`` (the convolutions, gates, recurrence and gated norm in one
        kernel on the card), the output projection."""
        cfg = self.cfg
        a = p + "self_attn."
        h = X.rms_norm(x, self.w[p + "input_layernorm.weight"], cfg.rms_norm_eps).to(self.dtype)
        proj = [self._lin(h, a + f"{z}_proj.weight") for z in "qkv"]
        o = kda_layer(*proj, [self.w[a + f"{z}_conv1d.weight"] for z in "qkv"],
                      self._lin(self._lin(h, a + "f_a_proj.weight"), a + "f_b_proj.weight"),
                      self.w[a + "A_log"], self.w[a + "dt_bias"], self._lin(h, a + "b_proj.weight"),
                      self._lin(self._lin(h, a + "g_a_proj.weight"), a + "g_b_proj.weight"),
                      self.w[a + "o_norm.weight"], cu_seqlens, cfg.kda_num_heads, cfg.rms_norm_eps,
                      cfg.kda_head_dim ** -0.5)
        return x + self._lin(o, a + "o_proj.weight")


def init_kimi_linear(preset: Union[str, KimiLinearConfig], seed: int, device,
                     weight_dtype: str = "bfloat16", dtype: torch.dtype = torch.bfloat16) -> KimiLinear:
    """The decoder with weights drawn from ``seed`` on ``device`` (module docstring),
    holding the config's channels of the experts, cast to ``dtype`` (``A_log`` and the
    biases f32); under ``weight_dtype`` "float8_e4m3fn" every projection matrix is
    stored as e4m3."""
    cfg = PRESETS[preset] if isinstance(preset, str) else preset
    weights = X.build_weights(weight_shapes(cfg), seed, device, weight_dtype, dtype, cfg.moe.channels,
                              init=init_tensor, keep_dense=X.KEEP_DENSE + ("conv1d.weight",),
                              keep_f32=("bias", "A_log"))
    return KimiLinear(cfg, weights, dtype)

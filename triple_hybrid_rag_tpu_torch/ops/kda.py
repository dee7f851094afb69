"""Kimi Delta Attention's token mixer over packed prompts, from its projections to its
gated output, with its recurrence computed chunkwise.

Per head, with a state ``S`` f32[d, d] that starts at zero at each prompt's first
token, per-channel decay ``alpha_t = exp(g_t)`` (``g_t <= 0``) and write strength
``beta_t`` (Kimi Linear, arXiv:2510.26692; the gated delta rule of arXiv:2412.06464):

    S' = Diag(alpha_t) S_{t-1}
    S_t = S' + beta_t k_t (v_t - S'^T k_t)^T
    o_t = scale * S_t^T q_t

computed chunkwise (the delta rule's WY form, arXiv:2406.06484) over chunks of
``CHUNK`` tokens that never cross a prompt. Within a chunk starting from the state
``S_0``, with ``G_t`` the cumulative log-decay from the chunk's start (inclusive):

* ``A[t, i] = beta_t sum_d k_t k_i exp(G_t - G_i)`` for ``i < t`` and
  ``P[t, i] = sum_d q_t k_i exp(G_t - G_i)`` for ``i <= t`` (each factor
  ``exp(G_t - G_i) <= 1``, so nothing overflows whatever the decay);
* ``(I + A) U = diag(beta) (V - (K * exp(G)) S_0)``, solved forward;
* ``O = scale ((Q * exp(G)) S_0 + P U)``;
* ``S <- Diag(exp(G_n)) S_0 + (K * exp(G_n - G))^T U``.

Around it, the layer's steps that read one token or one prompt (:func:`kda_layer`):
``q, k, v = SiLU(conv(projection))``, the causal depthwise convolution restarting at
each prompt's first token; q and k L2-normalised per head (eps ``L2_EPS``); ``g =
-exp(A_log[h]) softplus(f + dt_bias)``; ``beta = sigmoid(b)``; and after the recurrence
the per-head RMSNorm of ``o`` times its weight and ``sigmoid(gate)``.

:func:`kda_layer_plain` is all of that in plain PyTorch and f32 (the recurrence by
:func:`kda_chunked_plain`); :func:`kda_layer` runs it for a CPU tensor and launches
``csrc/kda.cu`` (``kda_layer_*``: one block a (prompt, head), the state in shared
memory in f32) for a CUDA tensor. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

CHUNK = 64  # tokens a chunk (the kernel's too)
KERNEL_HEAD_DIM = 128  # the kernel's head width (Kimi Linear's)
L2_EPS = 1e-6  # q and k's L2 norm (the published kernel's)


def kda_chunked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      beta: torch.Tensor, cu_seqlens: Sequence[int], scale: float,
                      chunk: int = CHUNK) -> torch.Tensor:
    """f32[T, H, D]: the recurrence over the prompts ``[cu_seqlens[b], cu_seqlens[b+1])``
    of ``q``, ``k``, ``v`` [T, H, D], ``g`` [T, H, D] (log-decay) and ``beta`` [T, H],
    chunk by chunk in f32 (module docstring)."""
    t_all, nh, d = q.shape
    q, k, v, g, beta = (a.float() for a in (q, k, v, g, beta))
    out = torch.zeros((t_all, nh, d), dtype=torch.float32, device=q.device)
    eye = torch.eye(chunk, dtype=torch.float32, device=q.device)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    bounds = [int(x) for x in cu_seqlens]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        s = torch.zeros((nh, d, d), dtype=torch.float32, device=q.device)  # [H, dk, dv]
        for c0 in range(lo, hi, chunk):
            n = min(chunk, hi - c0)
            qc, kc, vc = (a[c0:c0 + n].transpose(0, 1) for a in (q, k, v))  # [H, n, D]
            gam = g[c0:c0 + n].transpose(0, 1).cumsum(1)  # [H, n, D]
            bc = beta[c0:c0 + n].transpose(0, 1)  # [H, n]
            lower = causal[:n, :n]
            diff = gam[:, :, None, :] - gam[:, None, :, :]  # [H, t, i, D]
            decay = torch.where(lower[None, :, :, None], diff, float("-inf")).exp()
            a = torch.einsum("htd,hid,htid->hti", kc, kc, decay) * bc[:, :, None]
            a = a * (~eye[:n, :n].bool())[None]  # strictly lower
            p = torch.einsum("htd,hid,htid->hti", qc, kc, decay)
            eg = gam.exp()
            w = bc[:, :, None] * (vc - (kc * eg) @ s)
            u = torch.linalg.solve_triangular(eye[:n, :n][None] + a, w, upper=False,
                                              unitriangular=True)
            o = (qc * eg) @ s + p @ u
            out[c0:c0 + n] = (o * scale).transpose(0, 1)
            last = gam[:, -1:, :]  # [H, 1, D]
            s = last.transpose(1, 2).exp() * s + (kc * (last - gam).exp()).transpose(1, 2) @ u
    return out


def short_conv_plain(x: torch.Tensor, w: torch.Tensor, cu_seqlens: Sequence[int]) -> torch.Tensor:
    """f32[T, C]: ``y_t = sum_m w[:, m] x_{t - K + 1 + m}`` over each prompt of the packed
    ``x`` [T, C] alone (zero before its first token), ``w`` [C, K]."""
    x, w = x.float(), w.float()
    kw = w.shape[1]
    out = torch.empty_like(x)
    bounds = [int(b) for b in cu_seqlens]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        xp = F.pad(x[lo:hi], (0, 0, kw - 1, 0))
        out[lo:hi] = sum(w[:, m] * xp[m:m + hi - lo] for m in range(kw))
    return out


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda_layer_plain(qp, kp, vp, conv_w: Sequence[torch.Tensor], fp, a_log, dt_bias, bp, gate, norm_w,
                    cu_seqlens: Sequence[int], heads: int, eps: float, scale: float = None) -> torch.Tensor:
    """f32[T, heads * d]: the token mixer (module docstring) from the projections ``qp``,
    ``kp``, ``vp``, ``fp`` and ``gate`` [T, heads * d] and ``bp`` [T, heads], the
    convolutions ``conv_w`` (q, k, v, each [heads * d, K]), ``a_log`` [heads],
    ``dt_bias`` [heads * d] and the norm's weight ``norm_w`` [d], in f32."""
    t = qp.shape[0]
    d = qp.shape[1] // heads
    scale = d ** -0.5 if scale is None else scale
    q, k, v = (F.silu(short_conv_plain(x, w, cu_seqlens)).view(t, heads, d) for x, w in zip((qp, kp, vp), conv_w))
    q, k = _l2norm(q), _l2norm(k)
    g = -a_log.float().exp()[:, None] * F.softplus((fp.float() + dt_bias.float()).view(t, heads, d))
    beta = bp.float().sigmoid()
    o = kda_chunked_plain(q, k, v, g, beta, cu_seqlens, scale)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps) * norm_w.float()
    return (o * gate.float().view(t, heads, d).sigmoid()).reshape(t, heads * d)


def _launch(qp, kp, vp, conv_w, fp, a_log, dt_bias, bp, gate, norm_w, cu_seqlens, heads, eps, scale):
    from ..kernels.build import launch

    t, width = qp.shape
    d = width // heads
    if d != KERNEL_HEAD_DIM or width != heads * d:
        raise ValueError(f"the KDA kernel takes heads of {KERNEL_HEAD_DIM}, not {width} / {heads}")
    dtype = qp.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the projections must be bf16 or f32, not {dtype}")
    if any(w.shape != (width, 4) for w in conv_w):
        raise ValueError("the KDA kernel takes convolutions of width 4")
    mats = [x.to(dtype).contiguous() for x in (qp, kp, vp, *conv_w, fp)]
    if any(x.shape != (t, width) for x in (kp, vp, fp, gate)) or bp.shape != (t, heads):
        raise ValueError("the projections must be [T, heads * 128] and b [T, heads]")
    a_log, dt_bias = a_log.float().contiguous(), dt_bias.float().contiguous()
    bp, gate, norm_w = (x.to(dtype).contiguous() for x in (bp, gate, norm_w))
    cu = cu_seqlens.to(device=qp.device, dtype=torch.int32).contiguous()
    out = torch.empty((t, width), dtype=dtype, device=qp.device)
    b = cu.numel() - 1
    if t == 0 or b < 1:
        return out
    fn = "kda_layer_bf16" if dtype == torch.bfloat16 else "kda_layer_f32"
    launch("kda", fn, qp.device, *(x.data_ptr() for x in (*mats, a_log, dt_bias, bp, gate, norm_w, cu, out)),
           b, heads, float(scale), float(eps))
    return out


def kda_layer(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, conv_w: Sequence[torch.Tensor],
              fp: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor, bp: torch.Tensor,
              gate: torch.Tensor, norm_w: torch.Tensor, cu_seqlens: torch.Tensor, heads: int,
              eps: float, scale: float = None) -> torch.Tensor:
    """[T, heads * d] in the projections' dtype: KDA's gated output over the packed
    prompts bounded by ``cu_seqlens`` (i64 or i32 [B + 1], on the projections'
    device), at ``scale`` (default d^-1/2); arguments as :func:`kda_layer_plain`. The
    kernel on a CUDA tensor (or raise), the plain version on a CPU tensor."""
    d = qp.shape[1] // heads
    scale = d ** -0.5 if scale is None else scale
    if qp.device.type == "cuda":
        return _launch(qp, kp, vp, conv_w, fp, a_log, dt_bias, bp, gate, norm_w, cu_seqlens, heads, eps, scale)
    return kda_layer_plain(qp, kp, vp, conv_w, fp, a_log, dt_bias, bp, gate, norm_w, cu_seqlens.tolist(),
                           heads, eps, scale).to(qp.dtype)

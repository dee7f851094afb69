"""Late-interaction MaxSim rerank scores, batched over [B, K] candidates.

The port of the JAX package's ``ops/maxsim.py`` and of its Pallas kernel
``ops/pallas/maxsim_kernel.py``:

    score(q, d) = sum_i max(0, max_t q_i . d_t) * w_i / max(sum_i w_i, 1)

over the unmasked doc tokens ``t`` of the candidate's parent, with both operands
rounded to bf16 and f32 sums. Invalid candidates and parents without tokens score
0. The token store is bf16 or int8 (``quantize_tokens``, the reference's
``index/maxsim_index._pack_tokens`` rule), and int8 tokens are dequantized only
as they are scored. :func:`maxsim_scores` launches the hand-written kernel
``csrc/maxsim.cu`` on a CUDA tensor (it gathers the parents' token rows itself,
with a bf16 and an int8 body, at any number of query tokens and any width, as the
reference's einsum) and runs :func:`maxsim_scores_plain` on a CPU tensor. The
kernel's launcher picks one of three plans by shape (:func:`maxsim_plan`):
``staged`` (the served shapes: every query of a block in shared memory),
``wgmma`` (past them, where TMA reaches the rows: the query rounded to bf16 once,
then wgmma over whole rows) and ``general`` (the rest: rows TMA cannot address).
"""

from __future__ import annotations

import ctypes

import torch

INT8_TOKEN_SCALE = 127.0
_BODIES = {torch.bfloat16: "bf16", torch.int8: "int8"}  # token dtype -> kernel body
PLANS = ("staged", "wgmma", "general")  # csrc/maxsim.cu's PlanKind, in order


def calibrate_maxsim(scores: torch.Tensor, calibration: float) -> torch.Tensor:
    """Rescale anchored-encoder MaxSim scores (divide by ``calibration``, clip to
    [0, 1]); the identity for calibration outside (0, 1)."""
    if calibration >= 1.0 or calibration <= 0.0:
        return scores
    return torch.clamp(scores * (1.0 / calibration), 0.0, 1.0)


def quantize_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """Unit-vector token rows -> int8 ``clip(round(x * 127), -127, 127)`` (the
    reference's int8 token store; the scale is static, no per-row scales)."""
    x = torch.round(tokens.float() * INT8_TOKEN_SCALE)
    return torch.clamp(x, -INT8_TOKEN_SCALE, INT8_TOKEN_SCALE).to(torch.int8)


def dequantize_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """int8 token rows -> bf16 unit-ish vectors; pass-through for float dtypes."""
    if tokens.dtype == torch.int8:
        scale = torch.tensor(1.0 / INT8_TOKEN_SCALE, dtype=torch.bfloat16, device=tokens.device)
        return tokens.to(torch.bfloat16) * scale
    return tokens


def maxsim_scores_plain(
    tokens: torch.Tensor,  # [P, Td, D] parent token store
    tok_mask: torch.Tensor,  # bool[P, Td]
    parent_ids: torch.Tensor,  # i[B, K] parent rows (-1 = invalid candidate)
    q_tokens: torch.Tensor,  # f32[B, Tq, D]
    q_weights: torch.Tensor,  # f32[B, Tq] per-token weights (0 = padding)
) -> torch.Tensor:
    """Plain PyTorch version: f32[B, K] MaxSim scores."""
    p_rows = tokens.shape[0]
    safe = parent_ids.long().clamp(0, p_rows - 1)
    doc = dequantize_tokens(tokens[safe]).to(torch.bfloat16).float()  # [B, K, Td, D]
    dmask = tok_mask.bool()[safe]  # [B, K, Td]
    q = q_tokens.to(torch.bfloat16).float()  # [B, Tq, D]
    sim = torch.einsum("bktd,bqd->bktq", doc, q)
    sim = sim.masked_fill(~dmask[..., None], float("-inf"))
    per_q = sim.amax(dim=2)  # [B, K, Tq]
    has_doc = dmask.any(dim=2)  # [B, K]
    per_q = torch.where(has_doc[..., None], torch.clamp(per_q, min=0.0), torch.zeros_like(per_q))
    qm = q_weights.float()
    n_q = torch.clamp(qm.sum(dim=1), min=1.0)  # [B]
    score = (per_q * qm[:, None, :]).sum(dim=2) / n_q[:, None]
    return torch.where((parent_ids >= 0) & has_doc, score, torch.zeros_like(score))


def _tma_rows(tok: torch.Tensor) -> int:
    """1 when TMA can address the store's rows: 16-byte multiples from a 16-byte
    aligned store."""
    d = tok.shape[-1]
    return int((d * tok.element_size()) % 16 == 0 and tok.data_ptr() % 16 == 0)


def _plan(body: str, tok: torch.Tensor, b: int, k: int, tq: int):
    """(plan name, scratch bytes) the kernel's launcher takes for this shape on the
    store's device."""
    from ..kernels.build import check, load

    plan, scratch = ctypes.c_int(-1), ctypes.c_int64(0)
    fn = f"maxsim_plan_{body}"
    with torch.cuda.device(tok.device):
        err = getattr(load("maxsim"), fn)(
            tok.shape[-1], tq, b, k, _tma_rows(tok), ctypes.addressof(plan), ctypes.addressof(scratch)
        )
    check(err, fn)
    return PLANS[plan.value], scratch.value


def maxsim_plan(tokens: torch.Tensor, parent_ids: torch.Tensor, q_tokens: torch.Tensor) -> str:
    """The plan the kernel takes for these inputs: ``staged``, ``wgmma`` or
    ``general`` on a CUDA store, ``plain`` on a CPU one."""
    if tokens.device.type != "cuda":
        return "plain"
    body = _BODIES.get(tokens.dtype)
    if body is None:
        raise TypeError(f"the MaxSim kernel takes a bf16 or int8 token store, not {tokens.dtype}")
    b, k = parent_ids.shape
    return _plan(body, tokens.contiguous(), b, k, q_tokens.shape[1])[0]


def _launch_maxsim(tokens, tok_mask, parent_ids, q_tokens, q_weights):
    from ..kernels.build import check, load

    body = _BODIES.get(tokens.dtype)
    if body is None:
        raise TypeError(f"the MaxSim kernel takes a bf16 or int8 token store, not {tokens.dtype}")
    p_rows, td, d = tokens.shape
    b, k = parent_ids.shape
    tq = q_tokens.shape[1]
    if q_tokens.shape != (b, tq, d) or q_weights.shape != (b, tq) or tok_mask.shape != (p_rows, td):
        raise ValueError("inconsistent MaxSim shapes")
    dev = tokens.device
    tok = tokens.contiguous()
    msk = tok_mask.contiguous()
    msk = msk.view(torch.uint8) if msk.dtype == torch.bool else msk.to(torch.uint8)
    if msk.data_ptr() % 4:  # the kernel copies the mask as aligned words
        msk = msk.clone()
    pid = parent_ids.to(torch.int64).contiguous()
    q = q_tokens.float().contiguous()
    w = q_weights.float().contiguous()
    for t in (msk, pid, q, w):
        if t.device != dev:
            raise ValueError("all inputs must be on the token store's device")
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b * k == 0:
        return out
    plan, scratch_bytes = _plan(body, tok, b, k, tq)
    # the wgmma plan's query, rounded to bf16 by the launch
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    fn = f"maxsim_scores_{body}"
    with torch.cuda.device(dev):  # the launch code's state is the current device's
        err = getattr(load("maxsim"), fn)(
            tok.data_ptr(), msk.data_ptr(), pid.data_ptr(), q.data_ptr(), w.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(), p_rows, td, d, tq,
            b, k, _tma_rows(tok), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, fn)
    maxsim_scores.launches_by_tokens[body] += 1
    maxsim_scores.launches_by_plan[plan] += 1
    return out


def maxsim_scores(
    tokens: torch.Tensor,
    tok_mask: torch.Tensor,
    parent_ids: torch.Tensor,
    q_tokens: torch.Tensor,
    q_weights: torch.Tensor,
) -> torch.Tensor:
    """f32[B, K] MaxSim scores: the CUDA kernel on a CUDA tensor (or raise), the
    plain version on a CPU tensor. The kernel's entry, over a parent store and
    the candidates' rows in it. The reference's single-query
    ``maxsim_scores(doc_tokens, doc_mask, q_tokens, q_mask, valid)`` over gathered
    tokens is :func:`maxsim_scores_batch` on a leading axis of 1."""
    if tokens.device.type == "cuda":
        return _launch_maxsim(tokens, tok_mask, parent_ids, q_tokens, q_weights)
    return maxsim_scores_plain(tokens, tok_mask, parent_ids, q_tokens, q_weights)


def maxsim_scores_batch(
    doc_tokens: torch.Tensor,  # [B, K, Td, D] gathered doc tokens, bf16 or int8 (or f32)
    doc_mask: torch.Tensor,  # bool[B, K, Td]
    q_tokens: torch.Tensor,  # [B, Tq, D]
    q_mask: torch.Tensor,  # bool[B, Tq]
    valid: torch.Tensor,  # bool[B, K] candidate validity
) -> torch.Tensor:
    """f32[B, K] MaxSim scores of gathered doc tokens (the reference's
    ``maxsim_scores_batch``): invalid candidates and candidates without doc tokens
    score 0, each query token's best match is clipped at 0, and the sum is divided
    by ``max(sum(q_mask), 1)``. The tokens are viewed as a store of B*K parents
    (no copy for contiguous input), candidate (b, k) is row b*K + k, and
    :func:`maxsim_scores` scores them: the hand-written kernel on a CUDA tensor,
    the plain version on a CPU tensor. f32 tokens are rounded to bf16 first, as
    the reference's einsum rounds them."""
    b, k, td, d = doc_tokens.shape
    store = doc_tokens if doc_tokens.dtype in _BODIES else doc_tokens.to(torch.bfloat16)
    store = store.reshape(b * k, td, d)
    mask = doc_mask.reshape(b * k, td)
    rows = torch.arange(b * k, device=doc_tokens.device).view(b, k)
    parent_ids = torch.where(valid.bool(), rows, -1)
    return maxsim_scores(store, mask, parent_ids, q_tokens, q_mask.float())


# kernel launches by token dtype and by plan (CUDA tensors only)
maxsim_scores.launches_by_tokens = dict.fromkeys(_BODIES.values(), 0)
maxsim_scores.launches_by_plan = dict.fromkeys(PLANS, 0)

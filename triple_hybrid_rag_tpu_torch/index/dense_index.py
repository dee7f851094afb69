"""Dense channel: Matryoshka truncation, row quantizers, the index build and its
incremental append, batched scores (bf16/f32, int8, packed int4), the blocked int4
top-k, the zero-vector guard. The port of the JAX package's ``index/dense_index.py``.

:func:`build_dense_index` and :meth:`DenseIndex.append` give the reference's rows bit
for bit: truncation and renormalization in host NumPy as the reference does them,
then on the device the bf16 rounding (to nearest even, as ``jnp.asarray`` rounds)
or the row quantizers (round half to even, as ``np.rint``).

Quantized scores are exact and in one order everywhere (here, the fused kernel and
its rescore): the int32 dot of the int8 row codes and the int8-quantized query,
then ``(float(acc) * row_scale) * q_scale`` in f32, so every path gives the same
bits. PyTorch has no integer matmul on CUDA, so :func:`int_dot` goes through
``torch._int_mm`` there and through the int32 matmul on the CPU.

The staged retriever's semantic channel (:func:`semantic_scores`,
:func:`semantic_search`, the ports of ``DenseIndex.score`` / ``search``) scans the
rows of the placed :class:`~triple_hybrid_rag_tpu_torch.index.state.IndexState`,
the engine's own copy: bf16 and f32 rows through the dense-scores kernel on CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RAGConfig
from ..device import resolve_device
from ..ops.topk import NEG_INF, lax_top_k, masked_top_k, sort_topk_desc

_QUANT_ROWS = 1 << 16  # rows per quantizer block (bounds the f32 transients)
RESCORE_QUERIES = 16  # queries per member-rescore block


def truncate_matryoshka(vectors: np.ndarray, dim: int) -> np.ndarray:
    """Prefix-truncate + re-L2-normalize (host numpy, as the reference does)."""
    v = np.asarray(vectors, dtype=np.float32)[..., :dim]
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(norms, 1e-12)


# ---------------------------------------------------------------- quantizers


def _quantize_codes(mat: torch.Tensor, levels: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax codes in [-levels, levels] (int8) and f32 scales.
    ``torch.round`` rounds half to even, as the reference's ``np.rint`` does."""
    m = mat.float()
    absmax = m.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    codes = torch.clamp(torch.round(m / scale[:, None]), -levels, levels).to(torch.int8)
    return codes, scale


def _in_row_blocks(mat: torch.Tensor, width: int, dtype: torch.dtype, fn):
    """Apply ``fn(block) -> (rows, scales)`` to blocks of rows on ``mat``'s device."""
    n = mat.shape[0]
    rows = torch.empty((n, width), dtype=dtype, device=mat.device)
    scales = torch.empty((n,), dtype=torch.float32, device=mat.device)
    for lo in range(0, n, _QUANT_ROWS):
        rows[lo:lo + _QUANT_ROWS], scales[lo:lo + _QUANT_ROWS] = fn(mat[lo:lo + _QUANT_ROWS])
    return rows, scales


def quantize_rows_int8(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int8: (codes i8[N, D], scales f32[N]); an all-zero
    row gets scale 1. Works in row blocks on the tensor's device."""
    return _in_row_blocks(mat, mat.shape[1], torch.int8, lambda m: _quantize_codes(m, 127.0))


def quantize_rows_int4(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int4: codes in [-7, 7], the column pair (j, j + D/2)
    packed into one byte with column j in the low nibble. Returns (packed
    u8[N, D/2], scales f32[N]). Low nibbles are columns [0, D/2), high nibbles
    columns [D/2, D), so unpacking splits into two half-width products."""
    d = mat.shape[1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")

    def pack(m):
        v, scale = _quantize_codes(m, 7.0)
        nib = v.view(torch.uint8) & 0xF
        return nib[:, : d // 2] | (nib[:, d // 2:] << 4), scale

    return _in_row_blocks(mat, d // 2, torch.uint8, pack)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low i8[..., D/2], high i8[..., D/2]): the sign-extended nibbles of packed
    rows. Column j of ``low`` is original column j, of ``high`` column j + D/2."""
    low = ((packed & 0xF) ^ 8).view(torch.int8) - 8
    high = ((packed >> 4) ^ 8).view(torch.int8) - 8
    return low, high


def _store_rows(mat: np.ndarray, embedding_dtype: str, device: torch.device):
    """Truncated f32 rows -> (stored rows, row scales | None) on ``device`` in the
    configured storage: f32, bf16, int8 or packed int4 with per-row scales."""
    m = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.float32)).to(device)
    if embedding_dtype in ("int8", "int4"):
        quantize = quantize_rows_int4 if embedding_dtype == "int4" else quantize_rows_int8
        return quantize(m)
    return m.to(torch.bfloat16 if embedding_dtype == "bfloat16" else torch.float32), None


@dataclass
class DenseIndex:
    """The dense rows of one corpus snapshot on one device, capacity-padded: f32 or
    bf16 rows, or int8 / packed-int4 rows with per-row scales (1 on padding)."""

    embeddings: torch.Tensor  # f32|bf16|i8[n_pad, D] or packed u8[n_pad, D/2]
    valid: torch.Tensor  # bool[n_pad] occupancy
    n_docs: int
    n_pad: int
    dim: int
    config: RAGConfig
    scales: Optional[torch.Tensor] = None  # f32[n_pad] (int8 / int4 only)

    def append(self, vectors: np.ndarray) -> "DenseIndex":
        """Write new rows into spare capacity (the reference's in-place update);
        past the capacity the index grows to the next capacity multiple first.
        Returns a new index; this one stays valid."""
        n_new = int(vectors.shape[0])
        if n_new == 0:
            return self
        new_total = self.n_docs + n_new
        n_pad = self.n_pad
        if new_total > n_pad:
            n_pad = self.config.round_capacity(new_total)
        emb = _grow(self.embeddings, n_pad, 0)
        valid = _grow(self.valid, n_pad, False)
        scales = None if self.scales is None else _grow(self.scales, n_pad, 1.0)
        rows, new_scales = _store_rows(
            truncate_matryoshka(vectors, self.dim), self.config.embedding_dtype,
            self.embeddings.device,
        )
        emb[self.n_docs:new_total] = rows
        valid[self.n_docs:new_total] = True
        if scales is not None:
            scales[self.n_docs:new_total] = new_scales
        return DenseIndex(
            embeddings=emb, valid=valid, n_docs=new_total, n_pad=n_pad, dim=self.dim,
            config=self.config, scales=scales,
        )


def _grow(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    """A copy of ``t`` with its leading axis padded to ``n`` with ``fill``."""
    out = t.new_full((n,) + tuple(t.shape[1:]), fill)
    out[: t.shape[0]] = t
    return out


def build_dense_index(vectors: np.ndarray, config: RAGConfig, device=None) -> DenseIndex:
    """Matryoshka-truncate and renormalize ``vectors`` f32[N, D_full], pad to the
    capacity and place on ``device`` (CUDA unless ``device="cpu"``) in
    ``config.embedding_dtype``."""
    dev = resolve_device(device)
    n_docs = int(vectors.shape[0])
    dim = config.embedding_dim
    n_pad = config.round_capacity(max(n_docs, 1))
    mat = np.zeros((n_pad, dim), dtype=np.float32)
    if n_docs:
        mat[:n_docs] = truncate_matryoshka(vectors, dim)
    valid = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    valid[:n_docs] = True
    rows, scales = _store_rows(mat, config.embedding_dtype, dev)
    return DenseIndex(
        embeddings=rows, valid=valid, n_docs=n_docs, n_pad=n_pad, dim=dim, config=config,
        scales=scales,
    )


def quantize_queries_int8(query_vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric absmax int8: (q i8[B, D], q_scale f32[B, 1])."""
    q = query_vecs.float()
    q_absmax = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12)
    q_scale = q_absmax / 127.0  # [B, 1]
    q_i8 = torch.clamp(torch.round(q / q_scale), -127, 127).to(torch.int8)
    return q_i8, q_scale


# ---------------------------------------------------------------- scores


def dense_scores_batch(embeddings: torch.Tensor, query_vecs: torch.Tensor) -> torch.Tensor:
    """Batched scores f32[B, N] = q . e, queries cast to the row dtype.

    The reference's dot with ``preferred_element_type=f32``: on CUDA a bf16 GEMM
    with f32 output. The CPU has no such GEMM, so there the rows widen to f32
    first, which gives the same exact products summed in f32."""
    q = query_vecs.to(embeddings.dtype)
    if embeddings.device.type == "cuda" and embeddings.dtype == torch.bfloat16:
        return torch.mm(q, embeddings.T, out_dtype=torch.float32)
    return q.float() @ embeddings.float().T


def _pad_axis(t: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    if t.shape[axis] == size:
        return t
    shape = list(t.shape)
    shape[axis] = size - t.shape[axis]
    return torch.cat([t, t.new_zeros(shape)], axis)


def int_dot(q_i8: torch.Tensor, rows_i8: torch.Tensor) -> torch.Tensor:
    """Exact int32[B, N] = q_i8[B, D] . rows_i8[N, D] (int8 operands).

    On CUDA through ``torch._int_mm``, which wants more than 16 rows on the left
    and D, N multiples of 8: narrower operands are zero-padded and the result cut."""
    if q_i8.device.type != "cuda":
        return q_i8.int() @ rows_i8.int().T
    b, d = q_i8.shape
    n = rows_i8.shape[0]
    d8, n8 = -(-d // 8) * 8, -(-n // 8) * 8
    q = _pad_axis(_pad_axis(q_i8, 1, d8), 0, max(b, 32)).contiguous()
    rows = _pad_axis(_pad_axis(rows_i8, 1, d8), 0, n8).contiguous()
    return torch._int_mm(q, rows.T)[:b, :n]


def int_scores(
    rows: torch.Tensor,  # i8[N, D], or packed u8[N, D/2]
    scales: torch.Tensor,  # f32[N]
    q_i8: torch.Tensor,  # i8[B, D]
    q_scale: torch.Tensor,  # f32[B, 1]
) -> torch.Tensor:
    """f32[B, N] dequantized scores of quantized rows against quantized queries:
    ``(float(acc) * scales) * q_scale``, in that order."""
    if rows.dtype == torch.uint8:
        low, high = unpack_int4(rows)
        d2 = rows.shape[1]
        acc = int_dot(q_i8[:, :d2], low) + int_dot(q_i8[:, d2:], high)
    else:
        acc = int_dot(q_i8, rows)
    return acc.float() * scales[None, :] * q_scale


def dense_scores_int8_batch(
    values: torch.Tensor, scales: torch.Tensor, query_vecs: torch.Tensor
) -> torch.Tensor:
    """Batched int8 scoring f32[B, N]."""
    return int_scores(values, scales, *quantize_queries_int8(query_vecs))


def dense_scores_int4_batch(
    packed: torch.Tensor, scales: torch.Tensor, query_vecs: torch.Tensor
) -> torch.Tensor:
    """Batched int4 scoring f32[B, N] via a full unpack: it holds both unpacked
    int8 halves, so it is the small-corpus path; :func:`int4_topk_blocked` bounds
    the unpack to one row block."""
    return int_scores(packed, scales, *quantize_queries_int8(query_vecs))


def int_member_scores(
    rows: torch.Tensor,  # i8[N, D], or packed u8[N, D/2]
    scales: torch.Tensor,  # f32[N]
    member_rows: torch.Tensor,  # i64[B, C] row of each candidate
    q_i8: torch.Tensor,
    q_scale: torch.Tensor,
) -> torch.Tensor:
    """f32[B, C] scores of each query's own candidate rows, the same bits as
    :func:`int_scores`: a blocked elementwise int32 multiply-and-sum (there is no
    batched integer matmul)."""
    b, c = member_rows.shape
    acc = torch.empty((b, c), dtype=torch.int32, device=rows.device)
    for lo in range(0, b, RESCORE_QUERIES):  # bounds the [b, C, D] int32 products
        hi = min(b, lo + RESCORE_QUERIES)
        cand = rows[member_rows[lo:hi]]
        q = q_i8[lo:hi, None, :].int()
        if rows.dtype == torch.uint8:
            low, high = unpack_int4(cand)
            d2 = rows.shape[1]
            acc[lo:hi] = (low.int() * q[..., :d2]).sum(-1, dtype=torch.int32) + (
                high.int() * q[..., d2:]
            ).sum(-1, dtype=torch.int32)
        else:
            acc[lo:hi] = (cand.int() * q).sum(-1, dtype=torch.int32)
    return acc.float() * scales[member_rows] * q_scale


def int4_topk_blocked(
    packed: torch.Tensor,  # u8[N, D/2] packed nibble rows
    scales: torch.Tensor,  # f32[N]
    valid: torch.Tensor,  # bool[N]
    query_vecs: torch.Tensor,  # f32[B, D]
    k: int,
    collection_of: Optional[torch.Tensor] = None,  # i32[N]
    coll_cid: Optional[torch.Tensor] = None,  # i32[B]
    *,
    invalid_score_floor: float = -2.0,
    bucket: int = 16,
    block: int = 1 << 18,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched int4 top-k without the fused kernel: unpack and score one row
    block at a time, keep per-bucket maxima (masked rows and scores at or below
    the floor count as -inf before the max), then rescore the members of the k
    best buckets. ids equal :func:`dense_scores_int4_batch` + ``masked_top_k``."""
    n = packed.shape[0]
    b = query_vecs.shape[0]
    q_i8, q_scale = quantize_queries_int8(query_vecs)
    scoped = collection_of is not None and coll_cid is not None
    cid = coll_cid.long()[:, None] if scoped else None
    block = max(bucket, block // bucket * bucket)
    nb = -(-n // bucket)
    bmax = torch.empty((b, nb), dtype=torch.float32, device=packed.device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        s = int_scores(packed[lo:hi], scales[lo:hi], q_i8, q_scale)  # [B, rows]
        bad = ~valid.bool()[None, lo:hi] | (s <= invalid_score_floor)
        if scoped:
            bad = bad | ((cid != -1) & (collection_of.long()[None, lo:hi] != cid))
        s = s.masked_fill(bad, NEG_INF)
        width = -(-(hi - lo) // bucket) * bucket
        if width != hi - lo:  # the ragged end of the last block
            s = torch.cat([s, s.new_full((b, width - (hi - lo)), NEG_INF)], 1)
        bmax[:, lo // bucket: lo // bucket + width // bucket] = s.reshape(
            b, width // bucket, bucket
        ).amax(dim=2)

    kk = min(k, nb)
    _, bucket_ids = lax_top_k(bmax, kk)
    member = (
        bucket_ids[:, :, None] * bucket
        + torch.arange(bucket, device=bmax.device)[None, None, :]
    ).reshape(b, kk * bucket)
    rows = member.clamp(max=n - 1)
    cand = int_member_scores(packed, scales, rows, q_i8, q_scale)
    ok = valid.bool()[rows] & (member < n) & (cand > invalid_score_floor)
    if scoped:
        ok = ok & ((cid == -1) | (collection_of.long()[rows] == cid))
    return sort_topk_desc(cand.masked_fill(~ok, NEG_INF), member, k)


def zero_query_guard(
    q_vec: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Silence the dense channel for all-zero query vectors (a failed embed).

    A zero vector scores every row exactly 0.0 (with quantized rows too: it
    quantizes to zero codes) and would return rows 0..k-1 by the id tie-break;
    the guard empties the list instead (ids -1, scores 0), so fusion degrades to
    the lexical and graph channels."""
    q_ok = (q_vec != 0.0).any(dim=-1, keepdim=True)
    return (
        torch.where(q_ok, ids, torch.full_like(ids, -1)),
        torch.where(q_ok, scores, torch.zeros_like(scores)),
    )


# ---------------------------------------------------------------- staged channel


def semantic_scores(state, query_vec: torch.Tensor) -> torch.Tensor:
    """Cosine scores f32[n_pad] of one unit query vector against every placed row,
    in row order (the reference's ``DenseIndex.score``). bf16 and f32 rows go
    through :func:`~triple_hybrid_rag_tpu_torch.ops.dense_kernel.dense_scores` (the
    kernel on CUDA), int8 and packed-int4 rows through the exact integer scores.
    Under ``semantic_backend="ivf"`` the placed rows are cluster-major: their
    scores go back to row order through ``ivf_perm`` (dead slots dropped), since
    the reference's staged scan covers every row in row order."""
    from ..ops.dense_kernel import dense_scores

    rows, q = state.embeddings, query_vec.float()[None, :]
    if rows.dtype == torch.uint8:
        scores = dense_scores_int4_batch(rows, state.dense_scales, q)[0]
    elif rows.dtype == torch.int8:
        scores = dense_scores_int8_batch(rows, state.dense_scales, q)[0]
    else:
        scores = dense_scores(rows, q)[0]
    if not state.ivf_mode:
        return scores
    out = torch.zeros((state.n_pad + 1,), dtype=torch.float32, device=scores.device)
    out[state.ivf_perm] = scores
    return out[: state.n_pad]


def semantic_search(
    state, query_vec: torch.Tensor, top_k: Optional[int] = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staged semantic channel: (ids i64[k], scores f32[k]) of the exact top-k
    over the occupied rows (the reference's ``DenseIndex.search``); scores <= -2
    never surface, so a negative cosine still can. ``row_mask`` bool[n_pad]
    scopes the rows."""
    k = top_k or state.config.semantic_top_k
    valid = state.valid if row_mask is None else state.valid & row_mask
    return masked_top_k(semantic_scores(state, query_vec), k, valid=valid, invalid_score_floor=-2.0)

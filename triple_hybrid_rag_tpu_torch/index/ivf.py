"""Blocked-IVF approximate dense search (``semantic_backend="ivf"``).

The port of the JAX package's ``index/ivf.py``. The build clusters the rows with
spherical k-means, reorders them cluster-major, chops the reordered matrix into
fixed ``w``-row blocks and keeps each block's mean as its probe centroid. A query
scores every block centroid, probes the top ``p`` blocks, scores their rows in f32
and takes the top-k with the exact path's (score desc, id asc) order, so probing
every block returns the exact scan's ids.

The numerics follow the reference where they decide bits: the centroid update sums
bf16-rounded rows through a bf16 one-hot matrix into f32; the initialization is
strided over valid rows only; the reorder is a stable argsort; probe scores are the
unscaled row dot the query, times the row scale afterwards; the probe choice is
``jax.lax.top_k``'s (ties to the lower block). The matrix products are
``torch.matmul``: the reference computes IVF with XLA ops, no Pallas kernel.

Transients are bounded: the k-means works in blocks of rows, the block centroids in
groups of blocks, and the probe scoring gathers the probed windows for a few
queries at a time (``PROBE_BYTES``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.topk import lax_top_k, sort_topk_desc
from .dense_index import unpack_int4

KMEANS_BLOCK = 16384  # rows per k-means step (the reference's ``block``)
CENTROID_ROWS = 1 << 16  # rows dequantized at once for the block centroids
PROBE_BYTES = 1 << 30  # f32 bytes of gathered probe windows held at once
_DEAD_ID = 2**30  # id of an invalid candidate slot before the top-k


def dequant_f32(rows: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 view of dense rows (the reference's ``_dequant_f32``): f32/bf16 as they
    are, int8 times the row scale, packed int4 unpacked then scaled. The width is
    the logical dim (twice the stored width for int4)."""
    if rows.dtype == torch.uint8:
        r = torch.cat(unpack_int4(rows), dim=-1).float()
    else:
        r = rows.float()
    if scales is not None and rows.dtype in (torch.int8, torch.uint8):
        r = r * scales[:, None]
    return r


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-9)


def _scores(rf: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    return rf @ cent.T


def _onehot_sum(onehot: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """f32[C, D] = onehot.T @ bf16(rf), bf16 operands summed in f32 (the reference's
    ``preferred_element_type=f32`` dot). The CPU has no such GEMM: there the exact
    bf16 values widen to f32 first, which gives the same products summed in f32."""
    r16 = rf.to(torch.bfloat16)
    if rf.device.type == "cuda":
        return torch.mm(onehot.T, r16, out_dtype=torch.float32)
    return onehot.T.float() @ r16.float()


@torch.no_grad()
def kmeans_assign(
    rows: torch.Tensor,  # f32|bf16|i8[n, D] or packed int4 u8[n, D/2]
    scales: Optional[torch.Tensor],  # f32[n] | None
    valid: torch.Tensor,  # bool[n]
    *,
    n_clusters: int,
    iters: int = 8,
    block: int = KMEANS_BLOCK,
) -> torch.Tensor:
    """Spherical k-means cluster assignment i64[n]; invalid rows get ``n_clusters``.

    Deterministic: strided initialization over the valid rows, no RNG."""
    n = rows.shape[0]
    dev = rows.device
    valid = valid.bool()
    # strided init over VALID rows only, renormalized
    valid_pos = torch.nonzero(valid).flatten()
    if valid_pos.numel() == 0:
        valid_pos = torch.zeros((1,), dtype=torch.long, device=dev)
    n_valid = max(int(valid.sum()), 1)
    stride = max(n_valid // n_clusters, 1)
    init = valid_pos[(torch.arange(n_clusters, device=dev) * stride) % n_valid]
    cent = _unit(dequant_f32(rows[init], scales[init] if scales is not None else None))

    def blocks():
        for lo in range(0, n, block):
            s = scales[lo:lo + block] if scales is not None else None
            yield lo, dequant_f32(rows[lo:lo + block], s)

    for _ in range(iters):
        acc = torch.zeros((n_clusters, cent.shape[1]), dtype=torch.float32, device=dev)
        cnt = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
        for lo, rf in blocks():
            a = torch.argmax(_scores(rf, cent), dim=1)
            onehot = torch.zeros((rf.shape[0], n_clusters), dtype=torch.bfloat16, device=dev)
            onehot[torch.arange(rf.shape[0], device=dev), a] = 1.0
            onehot *= valid[lo:lo + block, None].to(torch.bfloat16)
            acc += _onehot_sum(onehot, rf)
            cnt += onehot.float().sum(dim=0)
        new = acc / torch.clamp(cnt[:, None], min=1.0)
        norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        cent = torch.where(norm > 1e-9, new / torch.clamp(norm, min=1e-9), cent)

    assign = torch.cat([torch.argmax(_scores(rf, cent), dim=1) for _, rf in blocks()])
    return torch.where(valid, assign, torch.full_like(assign, n_clusters))


@torch.no_grad()
def ivf_build_local(
    rows: torch.Tensor,  # f32|bf16|i8[n, D] or packed int4 u8[n, D/2]
    scales: Optional[torch.Tensor],  # f32[n] | None
    valid: torch.Tensor,  # bool[n]
    *,
    block_rows: int,
    n_clusters: int = 0,
    iters: int = 8,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Cluster-major reorder and fixed-width block centroids of one device's rows.

    Returns (rows_reordered [n, *] in the rows' dtype, scales_reordered | None,
    perm i64[n] the original row of each slot (n for a dead slot), centroids
    f32[W, D] the block means, W = n // block_rows). ``n`` must be a multiple of
    ``block_rows``."""
    n = rows.shape[0]
    w = block_rows
    if n % w:
        raise ValueError(f"{n} rows are not a multiple of the block width {w}")
    # auto: one cluster per block, capped at 4096
    n_clusters = n_clusters or max(min(n // w, 4096), 1)
    assign = kmeans_assign(rows, scales, valid, n_clusters=n_clusters, iters=iters)
    # stable cluster-major order; within a cluster, ascending original row
    perm = torch.sort(assign, stable=True).indices
    rows_r = rows[perm]
    scales_r = scales[perm] if scales is not None else None
    perm = torch.where(valid.bool()[perm], perm, torch.full_like(perm, n))
    # block means, dequantized a group of blocks at a time
    alive = (perm < n).float().view(n // w, w, 1)
    per = max(CENTROID_ROWS // w, 1)
    cents = []
    for b in range(0, n // w, per):
        lo, hi = b * w, min(b + per, n // w) * w
        s = scales_r[lo:hi] if scales_r is not None else None
        deq = dequant_f32(rows_r[lo:hi], s)
        deq = deq.view(-1, w, deq.shape[1])
        a = alive[b:b + per]
        cents.append((deq * a).sum(dim=1) / torch.clamp(a.sum(dim=1), min=1.0))
    return rows_r, scales_r, perm, torch.cat(cents)


@torch.no_grad()
def ivf_topk_local(
    rows_r: torch.Tensor,  # cluster-major rows, the layout of ivf_build_local
    scales_r: Optional[torch.Tensor],  # f32[n] | None
    perm: torch.Tensor,  # i[n] original row per slot (n = dead)
    centroids: torch.Tensor,  # f32[W, D]
    q_vec: torch.Tensor,  # f32[B, D]
    *,
    probes: int,
    top_k: int,
    row_mask: Optional[torch.Tensor] = None,  # bool[B, n] over original rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed top-k over the block-IVF layout: (ids i64[B, k] original rows,
    scores f32[B, k]), -1 / -inf in invalid slots, ordered (score desc, id asc)."""
    n = rows_r.shape[0]
    n_blocks = centroids.shape[0]
    w = n // n_blocks
    p = min(probes, n_blocks)
    q = q_vec.float()
    d = q.shape[1]
    perm = perm.long()
    quantized = scales_r is not None and rows_r.dtype in (torch.int8, torch.uint8)
    _, probe = lax_top_k(q @ centroids.T, p)  # [B, p] block ids
    offs = torch.arange(w, device=q.device)
    step = max(1, PROBE_BYTES // (p * w * d * 4))
    found = []
    for lo in range(0, q.shape[0], step):
        qb, pb = q[lo:lo + step], probe[lo:lo + step]
        slots = (pb[:, :, None] * w + offs).reshape(qb.shape[0], p * w)  # [b, p*w]
        cand = dequant_f32(rows_r[slots.flatten()], None).view(qb.shape[0], p * w, d)
        s = torch.bmm(cand, qb[:, :, None])[..., 0]
        if quantized:
            s = s * scales_r[slots]
        ids = perm[slots]
        ok = ids < n
        if row_mask is not None:
            ok = ok & torch.gather(row_mask[lo:lo + step].bool(), 1, ids.clamp(0, n - 1))
        found.append(sort_topk_desc(
            s.masked_fill(~ok, float("-inf")), ids.masked_fill(~ok, _DEAD_ID), top_k
        ))
    ids, vals = (torch.cat(x, 0) for x in zip(*found))
    return ids, vals

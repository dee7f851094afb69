"""Dense scores f32[B, N] through a hand-written kernel.

The port of the JAX package's Pallas kernel ``ops/pallas/dense_kernel.py``
(``dense_scores_pallas``): queries cast to the row dtype, ``q . e`` with f32 sums,
every score written out. As in the JAX package no engine path calls it: the engine's
dense channel either never writes the score matrix (``ops/fused_topk.py``) or leaves
the product to ``torch.matmul`` (``index/dense_index.dense_scores_batch``).
:func:`dense_scores` launches ``csrc/dense_scores.cu`` on a CUDA tensor and runs
:func:`dense_scores_plain` on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..index.dense_index import dense_scores_batch


def dense_scores_plain(embeddings: torch.Tensor, query_vecs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32[B, N]."""
    if embeddings.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported row dtype {embeddings.dtype}")
    return dense_scores_batch(embeddings, query_vecs)


def _launch_dense_scores(embeddings, query_vecs):
    from ..kernels.build import f32_query_tile, launch

    n, d = embeddings.shape
    b = query_vecs.shape[0]
    if query_vecs.shape[1] != d or d == 0 or d * embeddings.element_size() % 16:
        raise ValueError(
            f"bad shapes: rows {tuple(embeddings.shape)} (a row must take a positive multiple "
            f"of 16 bytes), queries {tuple(query_vecs.shape)}"
        )
    emb = embeddings.contiguous()
    q = query_vecs.to(emb.dtype).contiguous()
    if q.device != emb.device:
        raise ValueError("queries must be on the rows' device")
    if emb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("rows and queries must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.float32, device=emb.device)
    if b * n == 0:
        return out
    args = [emb.data_ptr(), q.data_ptr(), out.data_ptr(), n, d, b]
    if emb.dtype == torch.bfloat16:
        fn = "dense_scores_bf16"
    else:
        fn = "dense_scores_f32"
        args.append(f32_query_tile(b))
    launch("dense_scores", fn, emb.device, *args)
    return out


def dense_scores(
    embeddings: torch.Tensor,  # bf16|f32[N, D]
    query_vecs: torch.Tensor,  # f32[B, D]
) -> torch.Tensor:
    """f32[B, N] scores: the CUDA kernel on a CUDA tensor (or raise), the plain
    version on a CPU tensor."""
    if embeddings.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported row dtype {embeddings.dtype}")
    if embeddings.device.type == "cuda":
        return _launch_dense_scores(embeddings, query_vecs)
    return dense_scores_plain(embeddings, query_vecs)

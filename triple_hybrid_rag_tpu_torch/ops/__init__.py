"""Batched torch ops of the query program (and their CUDA kernels' wrappers)."""

from .topk import masked_top_k, merge_topk

__all__ = ["masked_top_k", "merge_topk"]

"""Batched torch ops of the query program (and their CUDA kernels' wrappers)."""

"""The yardstick's arithmetic: the card's peaks, the least time of a piece of work,
the work counts behind each roofline metric, and percentiles.

``HBM_BYTES_PER_S`` and the peaks, ``bound`` and ``percentile`` are frozen copies
of ``chip_smoke.py``'s. The work counts follow the shapes alone, never the kernel that
happens to run, so a roofline share reads the same work whatever implements it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
INT8_OPS = 1979e12  # dense int8 tensor-core peak, same source
F32_FLOPS = 67e12  # f32 outside the tensor cores, same source

# row dtype -> (bytes a row element, bytes a query element as the kernel reads it, peak)
ROW_TYPES = {
    "bfloat16": (2.0, 2.0, BF16_FLOPS),
    "float32": (4.0, 4.0, F32_FLOPS),
    "int8": (1.0, 1.0, INT8_OPS),
    "int4": (0.5, 1.0, INT8_OPS),
}


def bound(bytes_: float, ops: float, peak: float = BF16_FLOPS) -> Tuple[float, str]:
    """Least ms for the work: bytes at the memory rate against ``ops`` at ``peak``."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_work(n_pad: int, dim: int, batch: int, row_dtype: str) -> Tuple[float, float, float]:
    """(bytes, operations, peak) of the dense channel's scan of ``n_pad`` rows of
    width ``dim`` for ``batch`` queries: every row read once, with its scale where
    the rows are quantized, and the queries (with theirs); two operations a
    multiply-add."""
    row_b, q_b, peak = ROW_TYPES[row_dtype]
    quantized = row_dtype in ("int8", "int4")
    bytes_ = n_pad * dim * row_b + batch * dim * q_b
    if quantized:
        bytes_ += 4.0 * (n_pad + batch)
    return bytes_, 2.0 * batch * n_pad * dim, peak


def dense_least_ms(n_pad: int, dim: int, batch: int, row_dtype: str) -> float:
    bytes_, ops, peak = dense_work(n_pad, dim, batch, row_dtype)
    return bound(bytes_, ops, peak)[0]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's default,
    as ``chip_smoke.percentile_ms``)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))

"""``dense_roofline.staged``: the staged semantic channel's bf16 dense-scores kernel
(``csrc/dense_scores.cu``, one query a launch) at its least time over its device
time a launch, in %. The least time is the larger of the rows and the query read
once and the f32[1, N] scores written once at the HBM rate, and its multiply-adds at
the bf16 peak (``lib/work.dense_work``), counted from the shapes."""

from perfbench.lib.trace import kernel_ms_per_launch
from perfbench.lib.work import bound, dense_work

KERNEL = "dense_scores_bf16"  # part of the kernel's name in the trace


def read(t):
    ms = kernel_ms_per_launch(t, KERNEL)
    w = t.work
    if not ms or "rows" not in w or w["row_dtype"] != "bfloat16":
        return None
    bytes_, ops, peak = dense_work(w["rows"], w["dim"], 1, "bfloat16")
    return 100.0 * bound(bytes_ + 4.0 * w["rows"], ops, peak)[0] / ms

"""``dense_roofline.batch``: the dense channel's least time over its device time a
batch, in %. The least time is the larger of its inputs' bytes read once at the
HBM rate and its multiply-adds at the row type's peak (``lib/work.dense_work``),
counted from the shapes."""

from perfbench.lib.trace import stage_ms_per_unit
from perfbench.lib.work import dense_least_ms


def read(t):
    ms = stage_ms_per_unit(t, "engine.dense")
    w = t.work
    if not ms or "rows" not in w:
        return None
    return 100.0 * dense_least_ms(w["rows"], w["dim"], w["batch"], w["row_dtype"]) / ms

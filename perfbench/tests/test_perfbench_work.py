"""The work counts behind ``dense_roofline.batch`` and ``dense_roofline.staged``
against hand-worked numbers, and the percentile."""

from __future__ import annotations

import pytest

from perfbench.lib import work

N_PAD, DIM, B = 1_000_448, 1024, 128  # the 1M-chunk cells' rows, width and batch


def test_bf16_dense_work():
    bytes_, ops, peak = work.dense_work(N_PAD, DIM, B, "bfloat16")
    # rows: 1,000,448 x 1,024 x 2 B = 2,048,917,504; queries: 128 x 1,024 x 2 B = 262,144
    assert bytes_ == 2_048_917_504 + 262_144
    # 2 x 128 x 1,000,448 x 1,024
    assert ops == 262_261_440_512
    assert peak == 989e12
    least, what = work.bound(bytes_, ops, peak)
    assert what == "bytes"
    assert least == pytest.approx(2_049_179_648 / 3.35e12 * 1e3)  # 0.6117 ms
    assert least == pytest.approx(0.61169, abs=1e-5)


def test_int8_dense_work():
    bytes_, ops, peak = work.dense_work(N_PAD, DIM, B, "int8")
    # rows 1,024,458,752 B + row scales 4,001,792 + queries 131,072 + query scales 512
    assert bytes_ == 1_024_458_752 + 4_001_792 + 131_072 + 512
    assert ops == 262_261_440_512
    assert peak == 1979e12
    least, what = work.bound(bytes_, ops, peak)
    assert what == "bytes" and least == pytest.approx(0.30704, abs=1e-5)  # 1,028,592,128 B


def test_int4_and_single_query():
    bytes_, ops, _ = work.dense_work(N_PAD, DIM, 1, "int4")
    # packed rows 512,229,376 B + scales 4,001,792 + one int8 query 1,024 + its scale 4
    assert bytes_ == 512_229_376 + 4_001_792 + 1_024 + 4
    assert ops == 2 * N_PAD * DIM


def test_bound_picks_operations_when_they_dominate():
    assert work.bound(0.0, 989e9)[1] == "operations"
    assert work.bound(0.0, 989e9)[0] == pytest.approx(1.0)


def test_percentile():
    assert work.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)


def test_stage_intervals():
    from perfbench.lib.trace import _overlap, _union

    ivs = _union([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0)])
    assert ivs == [(0.0, 3.0), (5.0, 7.0)]
    assert _overlap(ivs, 2.0, 6.0) == pytest.approx(2.0)  # [2, 3] and [5, 6]
    assert _overlap(ivs, 3.5, 4.5) == 0.0 and _overlap(ivs, -1.0, 10.0) == pytest.approx(5.0)


def staged_summary(ops, row_dtype="bfloat16"):
    from perfbench.lib.trace import TraceSummary

    return TraceSummary(unit="query", units=150, queries=150, window_s=3.0, busy_s=1.2,
                        device_ops=77000, stage_s={}, idle_s=[],
                        op_s=sorted(((n, s) for n, s, _ in ops), key=lambda x: -x[1]),
                        op_n={n: c for n, _, c in ops},
                        work={"rows": N_PAD, "dim": DIM, "batch": 1, "row_dtype": row_dtype})


def test_dense_roofline_staged():
    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.trace import kernel_ms_per_launch

    bench = load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == "dense_roofline.staged")
    assert entry["workloads"] == ["rag1m-bf16.staged"] and entry["moves"] == "query_p95_ms"
    reader = resolve(bench, "rag1m-bf16.staged").per_layer["dense_roofline.staged"][1]
    kernel = "void dense_scores_bf16_kernel<64>(bf16 const*, bf16 const*, float*, int, int, int)"
    # 148 launches in 0.1 s, and another kernel that must not count
    t = staged_summary([(kernel, 0.1, 148), ("bucket_max_bf16_kernel", 5.0, 1)])
    assert kernel_ms_per_launch(t, "dense_scores_bf16") == pytest.approx(100.0 / 148)
    # rows 2,048,917,504 B + one query 2,048 + f32 scores 4,001,792, at 3.35 TB/s
    least = (2_048_917_504 + 2_048 + 4_001_792) / 3.35e12 * 1e3
    assert least == pytest.approx(0.61281, abs=1e-5)
    assert reader.read(t) == pytest.approx(100.0 * least / (100.0 / 148))
    assert reader.read(staged_summary([("bucket_max_bf16_kernel", 5.0, 1)])) is None
    assert reader.read(staged_summary([(kernel, 0.1, 148)], "int8")) is None


"""The work counts behind ``dense_roofline.batch`` against hand-worked numbers, and
the percentile."""

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

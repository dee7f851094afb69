"""The port's two timed entries against the plain reference on the CPU, at a small
corpus from the frozen generator, for both configurations: sound runs compare
within every limit, and the lower-precision control (the program's int8 rows for
the bf16 configuration, its int4 rows for the int8 one) fails one of them."""

from __future__ import annotations

import pytest

from perfbench.lib.runner import run

CELLS = ["rag1m-bf16.batch128", "rag1m-int8.staged", "rag1m-bf16.staged"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    out, checks = run(small_cell(name), 2147483801, 1.0, False, "cpu")
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in checks.values():
        assert c["value"] < 1e-5  # float32 sums in other orders


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_fails(small_cell, name):
    cell = small_cell(name)
    out, checks = run(cell, 2147483802, 1.0, False, "cpu", variant=cell.config["control"])
    assert not out["correct"], checks
    assert max(c["value"] / c["limit"] for c in checks.values()) > 10


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(small_cell, name):
    out, _ = run(small_cell(name), 2147483803, 0.5, False, "cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert {"queries_per_s", "peak_gb", "setup_s"} <= set(out["metrics"])
    assert all(v["value"] > 0 for k, v in out["metrics"].items() if k != "peak_gb")

"""On the card: each cell runs end to end through ``run.py`` for a short window,
traced and not, and reads ``correct`` with every metric finite."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest

from perfbench.lib.cell import HERE, ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", cell, "--seed",
                          "2147483806", "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["metrics"] and all(math.isfinite(m["value"]) for m in res["metrics"].values())
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for k, m in res["metrics"].items():
            if m["unit"] == "%":
                assert 0.0 <= m["value"] <= 100.0, k

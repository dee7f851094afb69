"""The staged cell's readers of the program's ranges, on a hand-built trace: a
device reader reads its range's device seconds a query; an idle reader sums the
idle gaps whose label chain holds its range anywhere, over the units; both read
None where the program has no such range (the parent of the ranges)."""

from __future__ import annotations

import pytest

from perfbench.lib.cell import load_benchmark, resolve
from perfbench.lib.trace import TraceSummary

CELL = "rag1m-int8.staged"
STAGED = ["rag1m-int8.staged", "rag1m-bf16.staged"]
DEVICE = {"lexical_ms.staged": "engine.staged.lexical",
          "semantic_ms.staged": "engine.staged.semantic",
          "graph_ms.staged": "engine.staged.graph",
          "rerank_ms.staged": "engine.staged.rerank"}
IDLE = {"tokens_idle_ms.staged": "engine.staged.tokens",
        "fusion_idle_ms.staged": "engine.staged.fusion",
        "gate_idle_ms.staged": "engine.staged.gate",
        "decode_idle_ms.staged": "engine.staged.decode"}
Q = "bench.query>engine.staged.query"


def summary(units=4, stage_s=None, idle_s=None) -> TraceSummary:
    return TraceSummary(unit="query", units=units, queries=units, window_s=1.0, busy_s=0.5,
                        device_ops=100, stage_s=stage_s or {}, op_s=[], idle_s=idle_s or [])


@pytest.fixture(scope="module")
def readers():
    per_layer = resolve(load_benchmark(), CELL).per_layer
    return {name: per_layer[name][1] for name in {**DEVICE, **IDLE}}


@pytest.mark.parametrize("metric", sorted({**DEVICE, **IDLE}))
def test_missing_range_reads_none(readers, metric):
    bare = summary(stage_s={"engine.lexical": 0.2},
                   idle_s=[("bench.query", 0.3), ("bench.query>bench.staged.rerank", 0.1),
                           ("harness", 0.01)])
    assert readers[metric].read(bare) is None
    assert readers[metric].read(summary(units=0)) is None


@pytest.mark.parametrize("metric", sorted(DEVICE))
def test_device_reader_divides_by_units(readers, metric):
    rng = DEVICE[metric]
    t = summary(units=4, stage_s={rng: 0.02, rng + "x": 9.0, "engine.staged.query": 5.0})
    assert readers[metric].read(t) == pytest.approx(5.0)  # 20 ms over 4 queries


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_reader_sums_every_chain_holding_its_range(readers, metric):
    rng = IDLE[metric]
    parent = "engine.staged.rerank" if rng == "engine.staged.tokens" else "engine.staged.query"
    t = summary(units=4, idle_s=[
        (f"{Q}>{rng}", 0.004),  # the range innermost
        (f"{Q}>{parent}>{rng}>bench.staged.x>engine.staged.y", 0.002),  # ranges inside it
        (rng, 0.002),  # alone
        (f"{Q}>{rng}x", 1.0),  # another range whose name starts the same
        (Q, 1.0), ("harness", 1.0),
    ])
    assert readers[metric].read(t) == pytest.approx(1e3 * 0.008 / 4)


def test_entries_are_the_staged_cells():
    bench = load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in {**DEVICE, **IDLE}:
        m = entries[name]
        assert m["workloads"] == STAGED and m["moves"] == "query_p95_ms"
        assert (m["unit"], m["better"], m["layer"]) == ("ms", "lower", "staged retriever")
        assert m["source"] == ("device_trace" if name in DEVICE else "program_span")
    assert not set(DEVICE) & set(resolve(bench, "rag1m-bf16.batch128").per_layer)

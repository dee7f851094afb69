"""A run whose timed path is broken underneath reads ``correct`` false: an answer
altered where the program produces it (the decode of device rows into results),
in each entry; and a unit that raises counts as failed."""

from __future__ import annotations

import pytest

import triple_hybrid_rag_tpu_torch.engine as engine_mod
import triple_hybrid_rag_tpu_torch.retrieval as retrieval_mod
from perfbench.lib.runner import run

ENTRIES = [("rag1m-bf16.batch128", engine_mod), ("rag1m-int8.staged", retrieval_mod),
           ("rag1m-bf16.staged", retrieval_mod)]


def altered(decode):
    """``decode`` with the last returned chunk swapped for its neighbour row."""
    def inner(corpus, fused, rerank, ids, scores):
        ids = ids.copy()
        live = [i for i, v in enumerate(ids) if v >= 0]
        if live:
            ids[live[-1]] = (ids[live[-1]] + 1) % len(corpus)
        return decode(corpus, fused, rerank, ids, scores)
    return inner


@pytest.mark.parametrize("name,module", ENTRIES)
def test_altered_answer_is_not_correct(small_cell, monkeypatch, name, module):
    monkeypatch.setattr(module, "decode_results", altered(module.decode_results))
    out, checks = run(small_cell(name), 2147483804, 0.5, False, "cpu")
    assert not out["correct"]
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]


@pytest.mark.parametrize("name", [n for n, _ in ENTRIES])
def test_failed_unit_is_not_correct(small_cell, name):
    def fault(driver):
        def step(texts):
            raise RuntimeError("a unit that fails")
        driver.step = step

    cell = small_cell(name)
    cell.traffic = dict(cell.traffic, texts=600)
    out, _ = run(cell, 2147483805, 0.2, False, "cpu", fault=fault)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0

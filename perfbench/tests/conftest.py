"""Settings of the benchmark's own tests: the ``card`` marker and a small cell.

Tests marked ``card`` need a CUDA card; the ``card`` fixture decides at run time
and skips on a machine without one. The others run on the CPU, at the
``small_cell`` size: the shipped configurations with the corpus and the widths cut
so that a window and the reference take seconds.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def shrink(cell, n: int = 20000):
    """``cell`` at a CPU test's size: 20,000 chunks, 1,000 entities, 4,096 terms,
    rows 256 wide cut to 128, MaxSim 16 x 32 with 8 query tokens, two warm-up units."""
    c = copy.deepcopy(cell.config)
    c["corpus"].update(n_chunks=n, n_entities=1000, vocab=4096, embedding_dim=128,
                       embedding_dim_full=256, maxsim_dim=32, maxsim_doc_tokens=16)
    c["rag_config"].update(embedding_dim=128, embedding_dim_full=256, maxsim_dim=32,
                           maxsim_doc_tokens=16, maxsim_query_tokens=8)
    cell.config = c
    cell.traffic = dict(cell.traffic, texts=3000, check_answers=48, trace_units=2, warm_units=2)
    return cell


@pytest.fixture
def small_cell():
    from perfbench.lib.cell import load_benchmark, resolve

    bench = load_benchmark()
    return lambda name: shrink(resolve(bench, name))

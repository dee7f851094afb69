"""The configuration's models are plug-ins found by name (``lib/cell.py``):

* each shipped cell serves, through the default plug-ins, the answers and check
  numbers that the program gives with its embedder and MaxSim store built directly
  here, as the harness built them before the plug-ins; the plain side gives the
  parent's reference answers (their digest pinned for one seed);
* a configuration that names a new reranker (``fused``) runs end to end from new
  files and new entries alone, reads ``correct``, and reads not correct when the
  plug-in's program side is broken;
* a traced run hands its readers the configuration and the program's counters;
* the harness modules that build the system and the reference name no model.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import shutil
from types import SimpleNamespace

import pytest

import perfbench.lib.runner as runner_mod
from perfbench.lib.cell import HERE, load_benchmark, load_module, models, resolve
from perfbench.lib.runner import run

from conftest import shrink

SEED = 2147483811
JUDGE = runner_mod.judge.judge
# One traced window of fixed units a cell (batch: 2 of 128; staged: 12 queries), and
# the digest of the reference answers the parent's inline code gave at SEED.
PINNED = {
    "rag1m-bf16.batch128": {"units": 2, "ref": "519b99a309ff8cdb"},
    "rag1m-int8.staged": {"units": 12, "ref": "f65287880b6be868"},
}


def digest(value) -> str:
    return hashlib.sha256(repr(value).encode()).hexdigest()[:16]


def fixed_run(cell, seed, monkeypatch, units, **kw):
    """A traced run of exactly ``units`` units (a window of 0 s), with the served and
    reference answers the comparison read and the ``check detail`` lines."""
    seen = {}

    def keep(progs, refs):
        seen["served"] = [(p.text, p.refused, p.max_score, p.rows, p.final, p.lexical,
                           p.semantic, p.graph, p.rrf, p.rerank, p.bits) for p in progs]
        seen["ref"] = [(r.refused, r.max_score, r.final,
                        sorted((k, sorted(v.items())) for k, v in r.cand.items())) for r in refs]
        return JUDGE(progs, refs)

    monkeypatch.setattr(runner_mod.judge, "judge", keep)
    cell.traffic = dict(cell.traffic, trace_units=units)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out, checks = run(cell, seed, 0.0, True, "cpu", **kw)
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("check detail")]
    return out, checks, seen, lines


def direct(cell):
    """``cell`` with the program sides of its plug-ins written out here: the
    program's ``BowHashEmbedder`` at the full width, and the generator's MaxSim
    store, int8 under int8 or int4 rows."""
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
    from triple_hybrid_rag_tpu_torch.ops.maxsim import quantize_tokens

    def place(inputs):
        tokens = inputs.corpus.tokens
        if inputs.cfg.embedding_dtype in ("int8", "int4"):
            tokens = quantize_tokens(tokens)
        return {"maxsim_tokens": tokens, "maxsim_mask": inputs.corpus.tok_mask}

    cell.models["embedder"].program = SimpleNamespace(
        build=lambda inputs, state: BowHashEmbedder(dim=inputs.cfg.embedding_dim_full,
                                                    config=inputs.cfg))
    cell.models["reranker"].program = SimpleNamespace(place=place)
    return cell


@pytest.mark.parametrize("name", sorted(PINNED))
def test_shipped_cells_read_as_before(small_cell, monkeypatch, name):
    units = PINNED[name]["units"]
    out, _, seen, lines = fixed_run(small_cell(name), SEED, monkeypatch, units)
    out_d, _, seen_d, lines_d = fixed_run(direct(small_cell(name)), SEED, monkeypatch, units)
    assert out["correct"] and out_d["correct"]
    assert len(lines) == 3 and lines == lines_d
    assert seen["served"] == seen_d["served"]
    assert digest(seen["ref"]) == digest(seen_d["ref"]) == PINNED[name]["ref"]


def test_default_models():
    bench = load_benchmark()
    for w in bench["workloads"]:
        m = resolve(bench, w["name"]).models
        assert {r: x.name for r, x in m.items()} == {"embedder": "bowhash", "reranker": "maxsim"}
    with pytest.raises(KeyError):
        models({"models": {"generator": "x"}})


FUSED_PROGRAM = '''"""Reranker ``fused`` (program side): no rerank model. Its configuration asks
for the program's "rerank unavailable" rung (``rerank_backend`` "none"): each
candidate's fused score min-max normalised over the query's candidates. It places
no token store, so the batched engine falls back to the same normalisation."""
'''
FUSED_PLAIN = '''"""Reranker ``fused`` (plain side): each candidate's fused score min-max
normalised over the query's candidates, all equal reading 1."""

import numpy as np


class Reranker:
    def scores(self, text, path, parents, rrf):
        if rrf.size == 0:
            return np.zeros(0, np.float32)
        lo, hi = rrf.min(), rrf.max()
        return ((rrf - lo) / (hi - lo) if hi - lo > 0 else np.ones_like(rrf)).astype(np.float32)


def build(ref, seed):
    return Reranker()
'''


def fused_checkout(tmp_path, base: str):
    """A checkout at ``tmp_path`` whose benchmark adds, to a copy of this one, only new
    files (the ``fused`` plug-in's two sides and a configuration that names it) and
    new entries; returns the new cell's name and the bytes of every file that was
    there."""
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / HERE.name).rglob("*") if p.is_file()}
    for side, text in (("models", FUSED_PROGRAM), ("reference/models", FUSED_PLAIN)):
        path = tmp_path / HERE.name / side / "fused.py"
        assert not path.exists()
        path.write_text(text)
    bench = load_benchmark()
    src = resolve(bench, base)
    conf = copy.deepcopy(src.config)
    conf["name"] = conf["name"] + "-fused"
    conf["models"] = {"reranker": "fused"}
    conf["rag_config"]["rerank_backend"] = "none"
    (tmp_path / HERE.name / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    entry = next(c for c in bench["configs"] if c["name"] == src.entry["config"])
    bench["configs"].append(dict(entry, name=conf["name"], file=f"{HERE.name}/configs/{conf['name']}.json"))
    cell = f"{conf['name']}.{src.entry['traffic']}"
    bench["workloads"].append(dict(src.entry, name=cell, config=conf["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell, before


@pytest.mark.parametrize("base", ["rag1m-bf16.batch128", "rag1m-int8.staged"])
def test_fused_reranker_is_new_files_only(tmp_path, base):
    name, before = fused_checkout(tmp_path, base)
    cell = shrink(resolve(json.loads((tmp_path / "BENCHMARK.json").read_text()), name, root=tmp_path))
    for side in ("program", "reference"):
        assert getattr(cell.models["reranker"], side).__file__.startswith(str(tmp_path))
    out, checks = run(cell, 2147483812, 0.5, False, "cpu")
    assert out["correct"], checks
    assert all(c["value"] < 1e-5 for c in checks.values()), checks
    assert all(p.read_bytes() == b for p, b in before.items()), "no file that was there changed"


def test_broken_fused_program_side_is_not_correct(tmp_path):
    """The ``fused`` program side broken: it places the MaxSim token store, by which
    the batched engine then reranks; the plain side stays the min-max of the fused
    scores. (On the staged path the program builds its reranker from
    ``rerank_backend`` alone, so the plug-in's program side places nothing it reads.)"""
    name, _ = fused_checkout(tmp_path, "rag1m-bf16.batch128")
    cell = shrink(resolve(json.loads((tmp_path / "BENCHMARK.json").read_text()), name, root=tmp_path))
    store = load_module(HERE / "models" / "maxsim.py", "perfbench_broken_fused")
    cell.models["reranker"].program = SimpleNamespace(place=store.place)
    out, checks = run(cell, 2147483813, 0.5, False, "cpu")
    assert not out["correct"], checks
    assert max(c["value"] / c["limit"] for c in checks.values()) > 10


@pytest.mark.parametrize("name", ["rag1m-int8.staged", "rag1m-bf16.batch128"])
def test_traced_run_hands_readers_config_and_counters(small_cell, monkeypatch, name):
    seen = {}
    summarize = runner_mod.tr.summarize

    def keep(*a, **k):
        seen["t"] = summarize(*a, **k)
        return seen["t"]

    monkeypatch.setattr(runner_mod.tr, "summarize", keep)
    cell = small_cell(name)
    units = 5 if cell.driver.UNIT == "query" else 1
    fixed_run(cell, 2147483814, monkeypatch, units)
    t = seen["t"]
    assert t.config == cell.config and t.config["name"] == name.split(".")[0]
    staged = cell.driver.UNIT == "query"
    assert t.counters.get("retrieval_queries_total", 0.0) == (t.queries if staged else 0.0)
    assert t.work == {"rows": t.work["rows"], "dim": 128, "batch": 1 if staged else 128,
                      "row_dtype": cell.config["rag_config"]["embedding_dtype"]}


def test_plugin_kernels_merge_per_cell():
    from perfbench.lib.trace import OWN_KERNELS, merge_kernels

    merged = merge_kernels(OWN_KERNELS, {"engine.tail": ("cross_encoder",), "engine.embed": ("gemm_x",)})
    assert merged["engine.tail"] == OWN_KERNELS["engine.tail"] + ("cross_encoder",)
    assert merged["engine.embed"] == ("gemm_x",) and merged["engine.dense"] == OWN_KERNELS["engine.dense"]
    assert merge_kernels(OWN_KERNELS, OWN_KERNELS) == OWN_KERNELS


@pytest.mark.parametrize("path", ["lib/system.py", "lib/runner.py", "lib/cell.py",
                                  "reference/pipeline.py", "reference/judge.py", "reference/text.py"])
def test_harness_names_no_model(path):
    """Only the plug-in files name a model (the generator's inputs and the frozen
    kernel table of ``lib/trace.py`` name kernels and stores, not a choice of model)."""
    text = (HERE / path).read_text().lower()
    assert "bowhash" not in text and "maxsim" not in text


def test_plugins_come_in_pairs():
    program = {p.stem for p in (HERE / "models").glob("[!_]*.py")}
    plain = {p.stem for p in (HERE / "reference" / "models").glob("[!_]*.py")}
    assert program == plain and json.loads((HERE / "models" / "defaults.json").read_text()) == {
        "embedder": "bowhash", "reranker": "maxsim"}

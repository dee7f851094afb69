"""The harness is driven by data: every cell's configuration, traffic, driver and
metric readers resolve from ``BENCHMARK.json`` by name; names and units keep to
the contract's characters; each per-layer metric's cells report the end-to-end
metric it moves; no cell asks for more than one chip; and a new cell with a new
traffic mix and a new per-layer metric needs only new files and new entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench.lib.cell import HERE, ROOT, load_benchmark, reports, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_counts():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_one_chip_each():
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = resolve(BENCH, cell)
    assert c.traffic["driver"] in ("batch", "staged")
    assert hasattr(c.driver, "Driver") and c.driver.UNIT in ("batch", "query")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "queries_per_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for name, (_, reader) in c.per_layer.items():
        assert callable(reader.read)
    assert c.config["limits"] and set(c.config["limits"]) <= {"channel_gap", "score_gap", "rank_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS and reports(moved, cell), (metric, cell)
    assert (HERE / "metrics" / f"{metric}.py").is_file()


def test_config_files_hold_their_keys():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["rag_config"]["embedding_dim"] == conf["corpus"]["embedding_dim"]
        assert set(conf["replaced"]) == set(conf["reduced"])


def test_configs_differ_from_the_defaults_only_where_they_say():
    """Every ``RAGConfig`` key a configuration sets away from its default is in
    ``reduced``, or is the row type that the configuration's source names; the
    corpus is built with the sizes the program is configured with."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    default = RAGConfig()
    shared = ("embedding_dim", "embedding_dim_full", "bm25_df_cap", "maxsim_dim",
              "maxsim_doc_tokens", "graph_max_degree", "graph_max_entities_per_chunk")
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        rc = conf["rag_config"]
        changed = {k for k, v in rc.items() if getattr(default, k) != v} - set(c["reduced"])
        assert changed <= {"embedding_dtype"}, (c["name"], changed)
        if "embedding_dtype" in changed:
            assert "embedding_dtype=" + rc["embedding_dtype"] in c["source"]
        for k in shared:
            assert conf["corpus"][k] == rc[k], (c["name"], k)


@pytest.mark.parametrize("mix", sorted(p.stem for p in (HERE / "traffic").glob("*.json")))
def test_traffic_names_its_sources(mix):
    t = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    assert {"query_terms", "relation_share", "null_share", "targets", "batch"} <= set(t["source"])
    assert 0.0 <= t["relation_share"] + t["null_share"] <= 1.0


def test_new_cell_is_new_files_only(tmp_path):
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__", "out"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / HERE.name).rglob("*")
              if p.is_file()}
    b = json.loads(json.dumps(BENCH))
    (tmp_path / HERE.name / "traffic" / "batch32.json").write_text(json.dumps(
        dict(json.loads((HERE / "traffic" / "batch128.json").read_text()), batch=32)))
    (tmp_path / HERE.name / "metrics" / "tail_ms.batch.py").write_text(
        "def read(t):\n    return None\n")
    b["workloads"].append({"name": "rag1m-bf16.batch32", "config": "rag1m-bf16",
                           "traffic": "batch32", "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "tail_ms.batch", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device program",
                           "moves": "queries_per_s", "workloads": ["rag1m-bf16.batch32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = resolve(b, "rag1m-bf16.batch32", root=tmp_path)
    assert c.traffic["batch"] == 32 and "tail_ms.batch" in c.per_layer
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / HERE.name).rglob("*")
             if p.is_file() and p.suffix != ".pyc"}
    assert all(after[k] == v for k, v in before.items()), "no file that was there changed"

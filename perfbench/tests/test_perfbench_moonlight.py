"""The ``moonlight`` reranker plug-in and the two cells of its configuration:

* the plug-in pair resolves, and the configuration file states the published model
  key for key (the reference's copy, the program's preset);
* at a tiny model and corpus on the CPU the program side's placed model and store,
  served through the staged path, read ``correct`` against the plain side's scores,
  and the fp8 control reads further from them;
* the configuration and the new traffic keep the harness's rules;
* the two cells are new files and new entries only.
"""

from __future__ import annotations

import copy
import json
import shutil

import pytest

from perfbench.lib.cell import HERE, load_benchmark, resolve
from perfbench.lib.runner import run

from conftest import shrink

CELLS = ("rag1m-moonlight.staged-xenc", "rag1m-int8.batch128")
NEW_FILES = ("configs/rag1m-moonlight.json", "traffic/staged-xenc.json", "models/moonlight.py",
             "reference/models/moonlight.py", "lib/prompts.py", "lib/xenc_work.py",
             "metrics/xenc_ms.staged-xenc.py", "metrics/xenc_attention_ms.staged-xenc.py",
             "metrics/xenc_experts_ms.staged-xenc.py", "metrics/xenc_experts_roofline.staged-xenc.py",
             "metrics/xenc_mfu.staged-xenc.py")
TINY = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=4,
            num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            vocab_size=512)
DOCS = {"doc_tokens_min": 330, "doc_tokens_max": 360}


def tiny_cell(monkeypatch):
    """The cell at the CPU tests' corpus size with a tiny model on both sides; the gate
    at 0.3, under the tiny random model's yes-probabilities near 0.5."""
    cell = shrink(resolve(load_benchmark(), "rag1m-moonlight.staged-xenc"))
    cell.config.update(TINY)
    cell.config["documents"] = DOCS
    cell.config["rag_config"]["safety_threshold"] = 0.3
    ref = cell.models["reranker"].reference
    monkeypatch.setattr(ref, "PUBLISHED", dict(ref.PUBLISHED, **TINY))
    monkeypatch.setattr(ref, "DOCUMENTS", DOCS)
    cell.traffic = dict(cell.traffic, check_answers=6, trace_units=3, warm_units=2)
    return cell


def test_plugin_pair_resolves_and_states_the_published_model():
    from triple_hybrid_rag_tpu_torch.models.cross_encoder import PRESETS, CrossEncoderConfig

    cell = resolve(load_benchmark(), "rag1m-moonlight.staged-xenc")
    m = cell.models["reranker"]
    assert m.name == "moonlight" and cell.models["embedder"].name == "bowhash"
    assert hasattr(m.program, "place") and hasattr(m.reference, "build")
    conf = cell.config
    assert {k: conf[k] for k in m.reference.PUBLISHED} == m.reference.PUBLISHED
    assert conf["documents"] == m.reference.DOCUMENTS
    assert CrossEncoderConfig.from_hf(conf) == PRESETS["moonlight-16b-a3b"]
    assert conf["rag_config"]["rerank_backend"] == "cross_encoder"
    assert conf["control"] == {"cross_encoder_weight_dtype": "float8_e4m3fn"}
    assert set(conf["limits"]) <= {"channel_gap", "score_gap", "rank_gap"}


def test_place_and_reference_scores_agree_at_a_tiny_model(monkeypatch):
    cell = tiny_cell(monkeypatch)
    out, checks = run(cell, 2147483911, 0.5, False, "cpu")
    assert out["correct"], checks
    assert out["attempted"] - out["failed"] > 0
    sound = max(c["value"] for c in checks.values())
    _, control = run(tiny_cell(monkeypatch), 2147483911, 0.5, False, "cpu",
                     variant=cell.config["control"])
    assert max(c["value"] for c in control.values()) > 2 * sound


def test_traced_run_reads_the_new_metrics(monkeypatch):
    cell = tiny_cell(monkeypatch)
    seen = {}
    import perfbench.lib.runner as runner_mod

    summarize = runner_mod.tr.summarize

    def keep(*a, **k):
        seen["t"] = summarize(*a, **k)
        return seen["t"]

    monkeypatch.setattr(runner_mod.tr, "summarize", keep)
    run(cell, 2147483912, 0.0, True, "cpu")
    t = seen["t"]
    for name in ("rerank_xenc_prompts_total", "rerank_xenc_tokens_total",
                 "rerank_xenc_padded_tokens_total", "rerank_xenc_attention_pairs_total"):
        assert t.counters.get(name, 0.0) > 0, name
    from perfbench.lib.xenc_work import active_weights, experts_least_s, model_flops, per_query

    n = per_query(t)
    assert n["rerank_xenc_prompts_total"] <= 50
    assert model_flops(t.config, n) > 2 * sum(active_weights(t.config).values()) * n["rerank_xenc_tokens_total"]
    assert experts_least_s(t.config, n["rerank_xenc_tokens_total"]) > 0


def test_published_active_weights():
    from perfbench.lib.xenc_work import active_weights

    conf = resolve(load_benchmark(), "rag1m-moonlight.staged-xenc").config
    w = active_weights(conf)
    assert abs(sum(w.values()) / 1e9 - 2.24) < 0.01  # about 2.24B active parameters a token
    assert w["routed"] == 26 * 6 * 3 * 2048 * 1408


@pytest.mark.parametrize("cell", CELLS)
def test_new_cells_keep_the_harness_rules(cell):
    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    c = resolve(load_benchmark(), cell)
    assert c.entry["chips"] == 1 and len(c.entry["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "queries_per_s", "peak_gb"}
    conf = json.loads(json.dumps(c.config))
    default = RAGConfig()
    changed = {k for k, v in conf["rag_config"].items() if getattr(default, k) != v}
    assert changed - set(conf["reduced"]) <= {"embedding_dtype"}
    assert set(conf["replaced"]) == set(conf["reduced"])
    assert {"query_terms", "relation_share", "null_share", "targets", "batch"} <= set(c.traffic["source"])
    if c.config["name"] == "rag1m-moonlight":
        assert set(c.per_layer) == {"xenc_ms.staged-xenc", "xenc_attention_ms.staged-xenc",
                                    "xenc_experts_ms.staged-xenc", "xenc_experts_roofline.staged-xenc",
                                    "xenc_mfu.staged-xenc"}


def test_new_cells_are_new_files_and_entries_only(tmp_path):
    """A copy of the benchmark without this configuration's files and entries takes
    them back as new files and appended entries, and every file it had stays as it was."""
    bench = load_benchmark()
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    for f in NEW_FILES:
        (tmp_path / HERE.name / f).unlink()
    before = {p: p.read_bytes() for p in (tmp_path / HERE.name).rglob("*") if p.is_file()}
    old = copy.deepcopy(bench)
    old["configs"] = [c for c in old["configs"] if c["name"] != "rag1m-moonlight"]
    old["workloads"] = [w for w in old["workloads"] if w["name"] not in CELLS]
    old["per_layer"] = [m for m in old["per_layer"] if not m["name"].startswith("xenc_")]
    for m in old["per_layer"]:  # the batch cell's readers: the new cell appended to their lists
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for was, now in zip(old[kind], bench[kind]):
            grown = dict(now, workloads=now["workloads"][: len(was.get("workloads", []))]) \
                if "workloads" in now else now
            assert grown == was, "entries stay; new ones and new cells in a list come last"
    for f in NEW_FILES:
        (tmp_path / HERE.name / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(HERE / f, tmp_path / HERE.name / f)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in CELLS:
        assert resolve(bench, cell, root=tmp_path).per_layer
    assert all(p.read_bytes() == b for p, b in before.items())

"""The ``kimilinear`` reranker plug-in and the two cells it comes with:

* the plug-in pair resolves, and the configuration file states the published model
  key for key, beside the share of each routed expert's channels held here, which
  the reference holds too;
* at a tiny model and corpus on the CPU the program side's placed model and store,
  served through the staged path, read ``correct`` against the plain side's scores,
  and the fp8 control reads further from them;
* a traced run counts the four new metrics' inputs (the counters; the ``.kda`` range
  has device time only on the card),
  and ``kda_work``'s counts equal a hand count at the published widths;
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

CELLS = ("rag1m-bf16.batch128-nograph", "rag1m-kimilinear.staged-xenc")
NEW_FILES = ("configs/rag1m-kimilinear.json", "traffic/batch128-nograph.json", "models/kimilinear.py",
             "reference/models/kimilinear.py", "lib/kda_work.py", "metrics/xenc_kda_ms.staged-xenc.py",
             "metrics/xenc_kda_roofline.staged-xenc.py", "metrics/xenc_kimi_mfu.staged-xenc.py",
             "metrics/xenc_kimi_experts_roofline.staged-xenc.py")
NEW_METRICS = ("xenc_kda_ms.staged-xenc", "xenc_kda_roofline.staged-xenc", "xenc_kimi_mfu.staged-xenc",
               "xenc_kimi_experts_roofline.staged-xenc")
TINY_LAC = {"full_attn_layers": [5], "kda_layers": [1, 2, 3, 4], "head_dim": 16, "num_heads": 4,
            "short_conv_kernel_size": 4}
TINY = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=5,
            num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, num_experts=16, num_experts_per_token=4, num_shared_experts=1,
            vocab_size=512, linear_attn_config=TINY_LAC)
SHARE = {"channels_first": 0, "channels_held": 16, "chips_per_layer": 2}
DOCS = {"doc_tokens_min": 330, "doc_tokens_max": 360}


def tiny_cell(monkeypatch):
    """The cell at the CPU tests' corpus size with a tiny model on both sides (16
    experts of width 32, channels 0-15 held here); the gate at 0.3, under the tiny
    random model's yes-probabilities near 0.5."""
    cell = shrink(resolve(load_benchmark(), "rag1m-kimilinear.staged-xenc"))
    cell.config.update(TINY, expert_share=SHARE)
    cell.config["documents"] = DOCS
    cell.config["rag_config"]["safety_threshold"] = 0.3
    ref = cell.models["reranker"].reference
    monkeypatch.setattr(ref, "PUBLISHED", dict(ref.PUBLISHED, **TINY))
    monkeypatch.setattr(ref, "DOCUMENTS", DOCS)
    monkeypatch.setattr(ref, "CHANNELS", {"first": SHARE["channels_first"], "count": SHARE["channels_held"]})
    cell.traffic = dict(cell.traffic, check_answers=4, trace_units=2, warm_units=1)
    return cell


def test_plugin_pair_resolves_and_states_the_published_model():
    from triple_hybrid_rag_tpu_torch.models.kimi_linear import KimiLinearConfig

    cell = resolve(load_benchmark(), "rag1m-kimilinear.staged-xenc")
    m = cell.models["reranker"]
    assert m.name == "kimilinear" and cell.models["embedder"].name == "bowhash"
    assert hasattr(m.program, "place") and hasattr(m.reference, "build")
    conf, published = cell.config, m.reference.PUBLISHED
    assert {k: conf[k] for k in published} == published
    assert conf["reduced"] == ["embedder_backend", "rerank_backend"]
    share = conf["expert_share"]
    assert m.reference.CHANNELS == {"first": share["channels_first"], "count": share["channels_held"]}
    assert conf["documents"] == m.reference.DOCUMENTS
    cfg = KimiLinearConfig.from_hf(conf, share["channels_first"], share["channels_held"])
    assert cfg.moe.experts == 256 and cfg.moe.channels == (0, 512) and cfg.num_hidden_layers == 27
    assert conf["rag_config"]["rerank_backend"] == "cross_encoder"
    assert conf["control"] == {"cross_encoder_weight_dtype": "float8_e4m3fn"}
    assert set(conf["limits"]) <= {"channel_gap", "score_gap", "rank_gap"}


def test_place_and_reference_scores_agree_at_a_tiny_model(monkeypatch):
    cell = tiny_cell(monkeypatch)
    out, checks = run(cell, 2147483913, 0.5, False, "cpu")
    assert out["correct"], checks
    assert out["attempted"] - out["failed"] > 0
    sound = max(c["value"] for c in checks.values())
    _, control = run(tiny_cell(monkeypatch), 2147483913, 0.5, False, "cpu",
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
    run(cell, 2147483914, 0.0, True, "cpu")
    t = seen["t"]
    from perfbench.lib.kda_work import experts_least_s, model_flops, per_query

    n = per_query(t)
    assert n is not None and n["rerank_xenc_tokens_total"] > 0 and n["rerank_xenc_prompts_total"] > 0
    assert model_flops(t.config, n) > 0 and experts_least_s(t.config, n["rerank_xenc_tokens_total"]) > 0
    readers = dict(cell.per_layer)
    assert set(NEW_METRICS) <= set(readers)
    # no device trace on the CPU: each reader finds nothing to read, and does not raise
    assert all(readers[m][1].read(t) is None for m in NEW_METRICS)


def test_kda_work_against_a_hand_count():
    from perfbench.lib import kda_work

    conf = resolve(load_benchmark(), "rag1m-kimilinear.staged-xenc").config
    tokens = 47190.0
    w = kda_work.kda_work(conf, tokens)
    assert w["flops"] == 8 * 128 * 128 * 32 * tokens * 20
    assert w["bytes"] == (5 * 2 * 4096 + 2 * 32) * tokens * 20
    a = kda_work.active_weights(conf)
    kda_layer = 3 * 2304 * 4096 + 3 * 4096 * 4 + 2 * (2304 * 128 + 128 * 4096) + 2304 * 32 + 4096 * 2304
    mla_layer = 2304 * 32 * 192 + 2304 * 576 + 512 * 32 * 256 + 32 * 128 * 2304
    assert a == {"kda": 20 * kda_layer, "mla": 7 * mla_layer, "dense": 3 * 2304 * 9216,
                 "router": 26 * 2304 * 256, "shared": 26 * 3 * 2304 * 1024}
    n = {"rerank_xenc_tokens_total": tokens, "rerank_xenc_prompts_total": 50.0,
         "rerank_xenc_attention_pairs_total": 2.4e7}
    routed = 2 * 3 * 2304 * 512 * tokens * 8 * 26  # every route, over the 512 channels held here
    want = (2 * sum(a.values()) * tokens + routed + w["flops"]
            + 2 * 7 * 32 * (192 + 128) * 2.4e7 + 4 * 2304 * 50)
    assert kda_work.model_flops(conf, n) == pytest.approx(want, rel=1e-12)
    # the held channels of the 256 experts: 47.1 GB of bf16 read once a question
    # (14.1 ms) against 6.95e13 routed FLOPs (70.2 ms), so the FLOPs bound them
    held_bytes = 2 * 256 * 3 * 2304 * 512 * 26
    assert kda_work.routed_work(conf, tokens) == {"flops": routed, "bytes": held_bytes}
    assert kda_work.experts_least_s(conf, tokens) == pytest.approx(routed / 989e12)
    # the bytes bound the recurrence at the card's rates: about 11.6 ms a question
    assert kda_work.kda_least_s(conf, tokens) == pytest.approx(w["bytes"] / 3.35e12)


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
    assert set(conf.get("replaced", {})) == set(conf["reduced"])
    assert {"query_terms", "relation_share", "null_share", "targets", "batch"} <= set(c.traffic["source"])
    if cell == "rag1m-bf16.batch128-nograph":
        base = resolve(load_benchmark(), "rag1m-bf16.batch128").traffic
        assert {k: v for k, v in c.traffic.items() if k != "source"} == dict(
            {k: v for k, v in base.items() if k != "source"}, relation_share=0.0)
        assert {m for m in c.per_layer} == {f"{m}.batch" for m in (
            "prep_ms", "lexical_ms", "graph_ms", "dense_ms", "dense_roofline", "idle_share")}
    else:
        assert set(c.per_layer) == {"xenc_ms.staged-xenc", "xenc_attention_ms.staged-xenc",
                                    "xenc_experts_ms.staged-xenc", *NEW_METRICS}


def test_new_cells_are_new_files_and_entries_only(tmp_path):
    """A copy of the benchmark without these cells' files and entries takes them back
    as new files and appended entries, and every file it had stays as it was."""
    bench = load_benchmark()
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    for f in NEW_FILES:
        (tmp_path / HERE.name / f).unlink()
    before = {p: p.read_bytes() for p in (tmp_path / HERE.name).rglob("*") if p.is_file()}
    old = copy.deepcopy(bench)
    old["configs"] = [c for c in old["configs"] if c["name"] != "rag1m-kimilinear"]
    old["workloads"] = [w for w in old["workloads"] if w["name"] not in CELLS]
    old["per_layer"] = [m for m in old["per_layer"] if m["name"] not in NEW_METRICS]
    for m in old["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len(bench[kind]) - len(old[kind]) == {"configs": 1, "workloads": 2, "per_layer": 4}.get(kind, 0)
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

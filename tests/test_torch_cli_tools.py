"""The port's CLI (``thr-torch``) and agent tools against the JAX reference's, on
the CPU.

Both CLIs run in this process over the same documents, the port's with
``--device cpu``: the ingest lines, the stats and the migrate summaries must be
equal, and the query answers equal in ids, texts, headings, channels and
refusals, scores within 1e-5 (the staged path's tolerance,
``tests/test_torch_staged.py``). The three subcommands whose modules are not
ported exit 2 in a process that never imports JAX. The tool registry over two
facades holding the same documents answers as the reference's does: the same
definitions, entities, ingest results and sources, the sources' scores (rounded
to 4 decimals by the tool) within 1.1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import triple_hybrid_rag_tpu.config as ref_config_mod
from triple_hybrid_rag_tpu.cli import main as ref_main
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.tools import make_knowledge_tools as ref_tools

import triple_hybrid_rag_tpu_torch.config as config_mod
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.cli import main
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.index.checkpoint import load_ingestor
from triple_hybrid_rag_tpu_torch.tools import make_knowledge_tools

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
QUERIES = ["invoice settlement", "foxes in the forest", "Who works for Acme Corp?", "zzz qqq"]


@pytest.fixture
def cfg(small_config, monkeypatch):
    c = small_config.replace(graph_enabled=True, embedding_dtype="float32", safety_threshold=0.2,
                             use_native=False)
    # both CLIs build their RAG from get_settings()
    monkeypatch.setattr(ref_config_mod, "_SETTINGS", c)
    monkeypatch.setattr(config_mod, "_SETTINGS", torch_config(c))
    return c


@pytest.fixture
def docs_dir(tmp_path):
    d = tmp_path / "docs"
    d.mkdir()
    (d / "pay.md").write_text(
        "# Payments\n\nAcme Corp settles invoices within thirty days of billing. "
        "Maria Silva works for Acme Corp.")
    (d / "wild.md").write_text("# Wildlife\n\nRed foxes inhabit the northern forest.")
    return d


def _run(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv_ref, argv_port, capsys):
    return _run(ref_main, argv_ref, capsys), _run(main, argv_port + ["--device", "cpu"], capsys)


def _same_query(want, got):
    assert [r["chunk_id"] for r in got["results"]] == [r["chunk_id"] for r in want["results"]]
    for key in ("query", "refused", "refusal_reason"):
        assert got[key] == want[key]
    assert got["timings_ms"].keys() == want["timings_ms"].keys()
    np.testing.assert_allclose(got["max_score"], want["max_score"], atol=ATOL)
    for g, w in zip(got["results"], want["results"]):
        assert (g["channels"], g["heading"], g["text"]) == (w["channels"], w["heading"], w["text"])
        np.testing.assert_allclose(g["score"], w["score"], atol=ATOL)


def test_cli_ingest_query_stats_metrics_match_reference(cfg, docs_dir, tmp_path, capsys):
    ref_idx, idx = str(tmp_path / "ref_index"), str(tmp_path / "index")
    (rc_r, out_r, _), (rc, out, err) = _both(["ingest", str(docs_dir), "--index", ref_idx, "--json"],
                                             ["ingest", str(docs_dir), "--index", idx, "--json"], capsys)
    assert rc == rc_r == 0 and "ingested 2 file(s), 0 failed" in err
    assert [json.loads(line) for line in out.splitlines()] == [json.loads(line) for line in out_r.splitlines()]
    for q in QUERIES:
        (rc_r, out_r, _), (rc, out, _) = _both(["query", *q.split(), "--index", ref_idx, "--json"],
                                               ["query", *q.split(), "--index", idx, "--json"], capsys)
        assert rc == rc_r == 0
        _same_query(json.loads(out_r), json.loads(out))
    (_, out_r, _), (rc, out, _) = _both(["stats", "--index", ref_idx, "--json"],
                                        ["stats", "--index", idx, "--json"], capsys)
    assert rc == 0 and json.loads(out) == json.loads(out_r) and json.loads(out)["documents"] == 2
    (_, out_r, _), (rc, out, _) = _both(["stats", "--index", ref_idx], ["stats", "--index", idx], capsys)
    assert rc == 0 and out == out_r
    rc, out, _ = _run(main, ["metrics"], capsys)
    assert rc == 0 and "# TYPE" in out and "ingest_documents_total" in out


def test_cli_human_output(cfg, docs_dir, tmp_path, capsys):
    idx = str(tmp_path / "index")
    rc, out, _ = _run(main, ["ingest", str(docs_dir), "--index", idx, "--device", "cpu"], capsys)
    assert rc == 0 and "[COMPLETED]" in out and "ingested 2 file(s)" in out
    rc, out, _ = _run(main, ["query", "invoice", "settlement", "--index", idx, "--device", "cpu",
                             "-v", "--top-k", "1"], capsys)
    assert rc == 0 and "1. (" in out and "-- 1 results in" in out
    assert "total" in out and "retrieval_ms" in out  # the waterfall
    answers = iter(["foxes forest", ""])
    import builtins

    real_input = builtins.input
    builtins.input = lambda prompt="": next(answers)
    try:
        rc, out, _ = _run(main, ["query", "--interactive", "--index", idx, "--device", "cpu"], capsys)
    finally:
        builtins.input = real_input
    assert rc == 0 and out.startswith("thr interactive query") and "foxes" in out.lower()


def test_cli_reingest_skips(cfg, docs_dir, tmp_path, capsys):
    idx = str(tmp_path / "index")
    _run(main, ["ingest", str(docs_dir), "--index", idx, "--device", "cpu"], capsys)
    rc, out, _ = _run(main, ["ingest", str(docs_dir), "--index", idx, "--device", "cpu"], capsys)
    assert rc == 0 and out.count("[SKIP]") == 2
    # the index's own checkpoint files are never ingested, and a broken path fails alone
    rc, out, _ = _run(main, ["ingest", str(tmp_path), str(tmp_path / "missing.md"), "--index", idx,
                             "--device", "cpu"], capsys)
    assert rc == 1 and "manifest" not in out and "[FAILED]" in out and out.count("[SKIP]") == 2


def test_cli_errors_exit_2(cfg, tmp_path, capsys):
    for fn in (ref_main, main):
        rc, _, err = _run(fn, ["query", "x", "--index", str(tmp_path / "none")]
                          + (["--device", "cpu"] if fn is main else []), capsys)
        assert rc == 2 and "no checkpoint manifest" in err


def test_cli_migrate_retruncate_and_reembed(cfg, docs_dir, tmp_path, capsys):
    src, ref_src = str(tmp_path / "src"), str(tmp_path / "ref_src")
    _both(["ingest", str(docs_dir), "--index", ref_src], ["ingest", str(docs_dir), "--index", src], capsys)
    new_dim = cfg.embedding_dim // 2
    for extra in (["--dim", str(new_dim)], ["--dtype", "int8", "--reembed"]):
        dst, ref_dst = str(tmp_path / "dst"), str(tmp_path / "ref_dst")
        (rc_r, out_r, _), (rc, out, _) = _both(["migrate", ref_src, ref_dst, *extra, "--json"],
                                               ["migrate", src, dst, *extra, "--json"], capsys)
        got, want = json.loads(out), json.loads(out_r)
        assert rc == rc_r == 0 and got["children"] > 0
        for key in ("src", "dst"):
            got.pop(key), want.pop(key)
        assert got == want
        mig = load_ingestor(dst, device="cpu")
        assert mig.config.embedding_dim == want["embedding_dim"]
        assert mig.config.embedding_dtype == want["embedding_dtype"]
        (_, out_r, _), (_, out, _) = _both(["query", "invoice", "settlement", "--index", ref_dst, "--json"],
                                           ["query", "invoice", "settlement", "--index", dst, "--json"],
                                           capsys)
        _same_query(json.loads(out_r), json.loads(out))
        assert json.loads(out)["results"] and not json.loads(out)["refused"]


def test_unported_subcommands_exit_2_without_jax(tmp_path):
    code = """
import contextlib, io, json, sys
from triple_hybrid_rag_tpu_torch.cli import main
out = {}
for argv in (["bench", "--n", "10"], ["eval", "--k", "5"], ["train-encoder", "--steps", "1"]):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out[argv[0]] = [main(argv), err.getvalue()]
out["bad"] = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "triple_hybrid_rag_tpu")]
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got.pop("bad") == []
    for name, (rc, err) in got.items():
        assert rc == 2 and "not ported yet (ROADMAP.md, Queue 1)" in err, name


# ------------------------------------------------------------------ tools


@pytest.fixture
def rags(cfg):
    out = (RefRAG(config=cfg), RAG(config=torch_config(cfg), device="cpu"))
    for r in out:
        r.ingest_text("# Payments\n\nAcme Corp settles invoices within thirty days. "
                      "Maria Silva works for Acme Corp.", name="pay.md")
        r.ingest_text("# Wildlife\n\nRed foxes inhabit the northern forest.", name="wild.md")
    return out


def _same_search(want, got):
    for key in ("success", "no_suitable_context", "reason", "context"):
        assert got.get(key) == want.get(key), key
    assert got["timings_ms"].keys() == want["timings_ms"].keys()
    assert len(got.get("sources", [])) == len(want.get("sources", []))
    for g, w in zip(got.get("sources", []), want.get("sources", [])):
        for key in ("chunk_id", "heading", "pages", "channels", "text"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["score"], w["score"], atol=1.1e-4)


def test_tool_registry_matches_reference(rags, tmp_path):
    ref, port = (f(r) for f, r in zip((ref_tools, make_knowledge_tools), rags))
    assert port.names() == ref.names() and port.definitions() == ref.definitions()
    for q, kw in (("invoice settlement days", {}), ("foxes", {"top_k": 1}),
                  ("invoice settlement", {"collection": "nope"})):
        _same_search(ref.call("search_knowledge_base", query=q, **kw),
                     port.call("search_knowledge_base", query=q, **kw))
    for name in ("Acme Corp", "maria", "Nobody At All"):
        assert port.call("lookup_entity", name=name) == ref.call("lookup_entity", name=name)
    assert port.call("lookup_entity", name="Acme Corp")["entities"][0]["related"] == ["Maria Silva"]
    doc = tmp_path / "ship.md"
    doc.write_text("# Shipping\n\nGlobex Inc delivers parcels for Acme Corp within five days.")
    for _ in range(2):  # the second call is skipped
        assert port.call("ingest_document", path=str(doc)) == ref.call("ingest_document", path=str(doc))
    _same_search(ref.call("search_knowledge_base", query="parcels delivered"),
                 port.call("search_knowledge_base", query="parcels delivered"))
    for call in (("nope",), ("search_knowledge_base",), ("ingest_document",)):
        assert port.call(*call) == ref.call(*call)
    assert port.call("ingest_document", path=str(tmp_path / "missing.md"))["success"] is False


def test_tool_refusal_shape_matches_reference(rags, cfg):
    ref, port = rags
    for r, c in ((ref, cfg), (port, torch_config(cfg))):
        r.ingestor.config = c.replace(safety_threshold=0.999)
        r._retriever = None
        r.ingestor.corpus._dirty = True
    want = ref_tools(ref).call("search_knowledge_base", query="zzz qqq nothing")
    got = make_knowledge_tools(port).call("search_knowledge_base", query="zzz qqq nothing")
    assert got["success"] is False and got["no_suitable_context"] is True
    _same_search(want, got)


def test_lookup_entity_without_graph(cfg):
    rag = RAG(config=torch_config(cfg.replace(graph_enabled=False)), device="cpu")
    rag.ingest_text("Acme Corp settles invoices.", name="p.md")
    out = make_knowledge_tools(rag).call("lookup_entity", name="Acme Corp")
    assert out == {"success": False, "error": "graph channel not enabled"}

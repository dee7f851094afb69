"""The port stands alone: it imports neither JAX nor the JAX package, its entry
points refuse to fall back to the CPU silently, and the synthetic serving corpus
builds and self-retrieves through the plain path."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "triple_hybrid_rag_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "triple_hybrid_rag_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_import_leaves_jax_out():
    mods = [m for m, _ in _port_modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_staged_path_modules_are_checked():
    """The staged path's modules are among those the import checks cover."""
    mods = {m for m, _ in _port_modules()}
    base = "triple_hybrid_rag_tpu_torch."
    for name in ("observability", "observability.metrics", "observability.trace",
                 "models.reranker", "models.maxsim_reranker"):
        assert base + name in mods, name


def test_serving_modules_are_checked():
    """The serving surface's modules are among those the import checks cover."""
    mods = {m for m, _ in _port_modules()}
    base = "triple_hybrid_rag_tpu_torch."
    for name in ("__main__", "cli", "server", "tools", "index.checkpoint", "index.cypher",
                 "observability.timing", "observability.latency_viz",
                 "observability.logging_config", "observability.profiling"):
        assert base + name in mods, name


def test_format_and_http_modules_are_checked():
    """The document formats', OCR's and the HTTP clients' modules are among those
    the import checks cover."""
    mods = {m for m, _ in _port_modules()}
    base = "triple_hybrid_rag_tpu_torch."
    for name in ("pdf_text", "office_text", "ocr", "ocr_glyph", "models.http_clients",
                 "models.planner", "models.entity_extractor", "models.embedder"):
        assert base + name in mods, name


def test_eval_modules_are_checked():
    """The quality evaluation's, the harness's, the RAG 1.0 searcher's and the native
    build's modules are among those the import checks cover."""
    mods = {m for m, _ in _port_modules()}
    base = "triple_hybrid_rag_tpu_torch."
    for name in ("eval", "harvest", "harness", "legacy", "native", "models.pretrain"):
        assert base + name in mods, name


def test_training_modules_are_checked():
    """Encoder training's, the visual aligner's and constrained decoding's modules
    are among those the import checks cover."""
    mods = {m for m, _ in _port_modules()}
    base = "triple_hybrid_rag_tpu_torch."
    for name in ("models.training", "models.visual_align", "models.constrained"):
        assert base + name in mods, name


def test_exports_cover_the_reference():
    """Each ``__all__`` of the reference (root, ``index``, ``ops``, ``models``) is
    a subset of the port's, and every exported name resolves; ``from
    triple_hybrid_rag_tpu_torch import Retriever, Ingestor`` works in a process
    with no JAX, as do the names the port added last (the batched MaxSim, BM25 and
    graph ops, the encoder's parameter files, ``pretrain.DATA_DIR``)."""
    import importlib

    for sub in ("", ".index", ".ops", ".models"):
        ref = importlib.import_module("triple_hybrid_rag_tpu" + sub)
        port = importlib.import_module("triple_hybrid_rag_tpu_torch" + sub)
        assert set(ref.__all__) <= set(port.__all__), sub
        for name in port.__all__:
            assert getattr(port, name) is not None, (sub, name)
    code = (
        "import json, sys\n"
        "from triple_hybrid_rag_tpu_torch import RAG, Retriever, Ingestor, Engine, IndexState\n"
        "from triple_hybrid_rag_tpu_torch import *\n"
        "from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores_batch\n"
        "from triple_hybrid_rag_tpu_torch.ops.bm25 import score_postings, score_postings_topk\n"
        "from triple_hybrid_rag_tpu_torch.ops.graph import chunk_scores_from_entities_batch\n"
        "from triple_hybrid_rag_tpu_torch.models.encoder import save_encoder_params, load_encoder_params\n"
        "from triple_hybrid_rag_tpu_torch.models.pretrain import DATA_DIR\n"
        "assert DATA_DIR.is_dir()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(json.dumps([Retriever.__module__, Ingestor.__module__, bad]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "triple_hybrid_rag_tpu_torch.retrieval", "triple_hybrid_rag_tpu_torch.ingest", []]


def test_parallel_exports_cover_the_reference_and_import_no_jax():
    """``parallel/``: the reference's ``parallel.__all__`` is covered, every module
    of it is among those the import checks cover, and importing it (the sharded
    engine included) in a process with no JAX loads none."""
    import triple_hybrid_rag_tpu.parallel as ref

    mods = {m for m, _ in _port_modules()}
    for name in ("parallel", "parallel.mesh", "parallel.placement", "parallel.engine"):
        assert "triple_hybrid_rag_tpu_torch." + name in mods, name
    code = (
        "import json, sys\n"
        "import triple_hybrid_rag_tpu_torch.parallel as p\n"
        "names = {n: getattr(p, n).__module__ for n in p.__all__}\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(json.dumps([sorted(names), bad]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    names, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(ref.__all__) <= set(names) and bad == []


def test_http_and_ocr_settings_no_longer_raise():
    """``RAG`` takes every ``*_api_base`` and ``ocr_fn``: the matching clients are
    wired (nothing is contacted before a call), explicit arguments win."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.models.http_clients import HTTPRerankerFn, HTTPVisionOCR

    dead = "http://127.0.0.1:9/v1"
    cfg = RAGConfig(embedder_backend="bowhash", embed_api_base=dead, rerank_api_base=dead,
                    llm_api_base=dead, ocr_api_base=dead)
    rag = RAG(cfg, device="cpu")
    assert type(rag.ingestor.embedder.inner).__name__ == "HTTPEmbedder"
    assert isinstance(rag._rerank_fn, HTTPRerankerFn)
    assert type(rag._planner).__name__ == "CallablePlanner"
    assert type(rag.ingestor.extractor).__name__ == "CallableExtractor"
    assert isinstance(rag.ingestor.loader.ocr.ocr_fn, HTTPVisionOCR)
    assert type(RAG(cfg.replace(ner_enabled=False), device="cpu").ingestor.extractor).__name__ == \
        "RuleBasedExtractor"

    def mine(image, mode):
        return "text"

    own = RAG(cfg, device="cpu", ocr_fn=mine, rerank_fn=len)
    assert own.ingestor.loader.ocr.ocr_fn is mine and own._rerank_fn is len


def test_cli_ingests_pdf_and_docx_without_jax(tmp_path):
    """``python -m triple_hybrid_rag_tpu_torch ingest`` of a PDF and a DOCX (the
    stdlib extractors, the default OCR ladder built) and a query over them, in
    processes where importing JAX or the JAX package fails."""
    import io
    import zipfile
    import zlib

    poison = tmp_path / "poison"
    for name in FORBIDDEN:
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    docs = tmp_path / "docs"
    docs.mkdir()
    stream = zlib.compress(b"BT 72 720 Td (Acme Corp settles invoices) Tj 0 -14 Td "
                           b"(within thirty days.) Tj ET")
    (docs / "pay.pdf").write_bytes(
        b"%%PDF-1.4\n4 0 obj\n<< /Filter /FlateDecode /Length %d >>\nstream\n%s\nendstream\n"
        b"endobj\ntrailer\n<< /Root 1 0 R >>\n%%%%EOF\n" % (len(stream), stream))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("word/document.xml", '<w:document xmlns:w="x"><w:body><w:p><w:r><w:t>Red foxes '
                    'inhabit the northern forest.</w:t></w:r></w:p></w:body></w:document>')
    (docs / "wild.docx").write_bytes(buf.getvalue())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{poison}{os.pathsep}{ROOT}", RAG_EMBEDDER_BACKEND="bowhash",
               RAG_CAPACITY_ROUND="64", RAG_SAFETY_THRESHOLD="0.0")
    idx = str(tmp_path / "index")
    cli = [sys.executable, "-m", "triple_hybrid_rag_tpu_torch"]
    out = subprocess.run(cli + ["ingest", str(docs), "--index", idx, "--device", "cpu", "--json"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert [json.loads(line)["status"] for line in out.stdout.splitlines()] == ["completed"] * 2
    for query, want in (("When does Acme Corp settle invoices?", "thirty days"),
                        ("Where do red foxes live?", "northern forest")):
        out = subprocess.run(cli + ["query", query, "--index", idx, "--device", "cpu", "--json"],
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout)
        assert not got["refused"] and want in got["results"][0]["text"]


@pytest.mark.parametrize("path", [p for _, p in _port_modules()] + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_refuse_silent_cpu(monkeypatch):
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.device import resolve_device
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_synthetic(RAGConfig(embedding_dim=16), 64, 16, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(None)
    assert resolve_device("cpu").type == "cpu"


def test_serving_entry_points_refuse_silent_cpu(monkeypatch, tmp_path):
    """The server and the CLI build no RAG on the CPU unless asked to."""
    from triple_hybrid_rag_tpu_torch.cli import main
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.server import RAGServer, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(port=0)
    doc = tmp_path / "a.md"
    doc.write_text("Acme Corp settles invoices.")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["ingest", str(doc), "--index", str(tmp_path / "idx")])
    assert not (tmp_path / "idx").exists()
    cfg = RAGConfig(embedder_backend="bowhash")
    assert RAGServer(config=cfg, device="cpu").rag.device.type == "cpu"


def test_cli_runs_without_jax(tmp_path):
    """``python -m triple_hybrid_rag_tpu_torch ingest ... --device cpu`` and then
    ``query --json`` in processes where importing JAX or the JAX package fails."""
    poison = tmp_path / "poison"
    for name in FORBIDDEN:
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "pay.md").write_text("# Payments\n\nAcme Corp settles invoices within thirty days.")
    (docs / "wild.md").write_text("# Wildlife\n\nRed foxes inhabit the northern forest.")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{poison}{os.pathsep}{ROOT}", RAG_EMBEDDER_BACKEND="bowhash",
               RAG_CAPACITY_ROUND="64", RAG_SAFETY_THRESHOLD="0.0")
    idx = str(tmp_path / "index")
    cli = [sys.executable, "-m", "triple_hybrid_rag_tpu_torch"]
    out = subprocess.run(cli + ["ingest", str(docs), "--index", idx, "--device", "cpu", "--json"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert [json.loads(line)["status"] for line in out.stdout.splitlines()] == ["completed"] * 2
    out = subprocess.run(cli + ["query", "When", "are", "invoices", "settled?", "--index", idx,
                                "--device", "cpu", "--json"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert not got["refused"] and "invoices" in got["results"][0]["text"]


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_synthetic_corpus_self_retrieval():
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.synthetic import L_DOC, build_synthetic, make_query_texts

    n, dim, n_ent = 4096, 64, 300
    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=dim, embedding_dim_full=dim,
        embedding_dtype="bfloat16", maxsim_doc_tokens=32, maxsim_dim=64, maxsim_query_tokens=16,
        safety_threshold=0.0, graph_max_entities_per_chunk=4, lexical_backend="sorted",
        bm25_df_cap=256, embedder_backend="bowhash",
    )
    syn = build_synthetic(cfg, n, dim, n_ent, seed=0, device="cpu")
    st = syn.state
    assert st.n_pad == 4096 and syn.term_ids.shape == (4096, L_DOC)
    assert st.embeddings.shape == (4096, dim) and st.embeddings.dtype == torch.bfloat16
    assert st.maxsim_tokens.shape == (1024, 32, 64) and st.maxsim_mask.shape == (1024, 32)
    assert st.nbr.shape == (1024, cfg.graph_max_degree) and st.lex_l_max == 256
    assert int(st.lex_lengths.max()) <= 256
    eng = Engine(st, embedder=syn.embedder, device="cpu")
    rng = np.random.default_rng(42)
    rows = rng.integers(0, n // 5, size=128) * 5
    texts, is_graph = make_query_texts(rows, syn.term_ids, rng, 0.3, n_ent)
    plans, out = eng.search_arrays(texts)
    ids = out[0].numpy()
    plain = [i for i in range(len(rows)) if not is_graph[i]]
    frac = np.mean([rows[i] in ids[i] for i in plain])
    assert frac >= 0.95
    assert any(p.requires_graph for p in plans)
    res = eng.retrieve_batch(texts[:2])
    assert res[0].results[0].chunk_id == f"c{rows[0]}"


def test_default_config_serves_with_the_encoder():
    """A default RAGConfig (embedder_backend="auto") builds the port's encoder from
    the reference's packaged weights, read by path, with no JAX imported; chosen
    rows re-embedded with it (synthetic.encode_rows) self-retrieve through the
    device encode and through the host path."""
    code = """
import json, sys
import numpy as np
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, encode_rows, make_query_texts

cfg = RAGConfig(capacity_round=1024, graph_max_entities_per_chunk=4, bm25_df_cap=256)
syn = build_synthetic(cfg, 4096, cfg.embedding_dim, 300, seed=0, device="cpu")
eng = Engine(syn.state, device="cpu")
rows = np.arange(0, 80, 5)
encode_rows(syn.state, rows, eng.embedder, syn.state.corpus.text_of)
texts, _ = make_query_texts(rows, syn.term_ids, np.random.default_rng(0), 0.0, 300)
found = {}
for dev_encode in (True, False):
    eng.device_query_encode = dev_encode
    ids = eng.search_arrays(texts)[1][0].numpy()
    found[dev_encode] = sum(int(r in ids[i]) for i, r in enumerate(rows))
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "triple_hybrid_rag_tpu")]
print(json.dumps({"embedder": type(eng.embedder).__name__, "calibration": eng.maxsim_calibration,
                  "pool_w2": eng.embedder.enc_cfg.anchor_pool_w2, "found": [found[True], found[False]],
                  "n": len(rows), "bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["embedder"] == "EncoderEmbedder" and got["bad"] == []
    assert got["calibration"] == 0.6 and got["pool_w2"] == 0.65
    assert got["found"] == [got["n"], got["n"]]


def test_facade_ingests_and_serves_without_jax():
    """``RAG(device="cpu")`` ingests text and answers a batch with every module of
    the ingest side (chunker, loader, extractor, index builders, ingestor,
    retriever, facade) imported, and no JAX."""
    code = """
import json, sys
from triple_hybrid_rag_tpu_torch import RAG, RAGConfig

rag = RAG(RAGConfig(embedder_backend="bowhash", capacity_round=64, safety_threshold=0.0),
          device="cpu", use_sharded_engine=True)
res = rag.ingest_text("# Billing\\n\\nAcme Corp settles invoices within thirty days.", name="b.md")
found = rag.query_batch(["When does Acme Corp settle invoices?"])[0]
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "triple_hybrid_rag_tpu")]
print(json.dumps({"status": res.status.value, "top": found.results[0].doc_id == res.doc_id,
                  "mods": sorted(m for m in sys.modules if m.startswith("triple_hybrid_rag_tpu_torch.")),
                  "bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == "completed" and got["top"] and got["bad"] == []
    for mod in ("chunker", "loader", "ingest", "facade", "retrieval", "index.bm25_index",
                "index.graph_index", "index.maxsim_index", "index.ivf"):
        assert f"triple_hybrid_rag_tpu_torch.{mod}" in got["mods"]

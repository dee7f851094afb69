"""The port's checkpoints against the JAX reference's, on the CPU.

Both packages write format v2 (``index/checkpoint.py``): a checkpoint that either
one saves must load in the other with equal corpus, entity store, embeddings (bit
for bit) and config, and the JSON artifacts of the same ingest must be the same
bytes (each document's ``created_at`` is the wall clock of its ingest, so the port's
documents take the reference's before the save). ``RAG.load(..., device="cpu")``
then answers as the reference's loaded facade does: equal ids and refusals, scores
within 1e-5 (the staged path's tolerance, ``tests/test_torch_staged.py``). Last,
the reference's own checkpoint tests (``tests/test_checkpoint_facade_cli.py``) as
cases against the port.
"""

import dataclasses
import hashlib
import json
import pickle

import numpy as np
import pytest

from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.index import checkpoint as ref_ckpt
from triple_hybrid_rag_tpu.ingest import Ingestor as RefIngestor
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh

from test_torch_engine import _compare
from torch_port_helpers import reference_config, torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.index import checkpoint as ckpt
from triple_hybrid_rag_tpu_torch.ingest import Ingestor
from triple_hybrid_rag_tpu_torch.models.entity_extractor import EntityStore
from triple_hybrid_rag_tpu_torch.types import Document

ATOL = 1e-5
DOCS = {
    "pay.md": "# Payments\n\nAcme Corp settles invoices within thirty days of billing. "
              "Maria Silva works for Acme Corp in Recife.",
    "wild.md": "# Wildlife\n\nRed foxes inhabit the northern forest. Globex Inc studies "
               "the foxes for Acme Corp.",
    "ship.md": "# Shipping\n\nParcels arrive within five days. Globex Inc runs the depots.",
}
QUERIES = ["invoice settlement", "fox in the forest", "Who works for Acme Corp?",
           "parcels depots", "zzz qqq nothing"]


@pytest.fixture
def cfg(small_config):
    return small_config.replace(
        graph_enabled=True, embedding_dtype="float32", safety_threshold=0.2, use_native=False
    )


@pytest.fixture
def docs_dir(tmp_path):
    d = tmp_path / "docs"
    d.mkdir()
    for name, text in DOCS.items():
        (d / name).write_text(text)
    return d


def _ingested(cfg, docs_dir):
    """The same directory ingested by both packages, the port's documents given the
    reference's ``created_at``."""
    ref = RefIngestor(config=cfg)
    ref.ingest_directory(docs_dir)
    port = Ingestor(config=torch_config(cfg), device="cpu")
    port.ingest_directory(docs_dir)
    for doc_id, doc in port.corpus.documents.items():
        doc.created_at = ref.corpus.documents[doc_id].created_at
    return ref, port


def _records(objs):
    return [dataclasses.asdict(o) for o in objs]


def _assert_same_state(a_corpus, a_store, a_emb, b_corpus, b_store, b_emb):
    def enum_free(rows):
        return json.loads(json.dumps(rows, default=lambda o: getattr(o, "value", str(o))))

    assert enum_free({k: dataclasses.asdict(v) for k, v in a_corpus.documents.items()}) == \
        enum_free({k: dataclasses.asdict(v) for k, v in b_corpus.documents.items()})
    for attr in ("parents", "children"):
        assert enum_free(_records(getattr(a_corpus, attr))) == enum_free(_records(getattr(b_corpus, attr)))
    assert a_corpus.stats() == b_corpus.stats()
    for part in ("entities", "relations", "mentions"):
        assert enum_free(_records(a_store.to_state()[part])) == \
            enum_free(_records(b_store.to_state()[part])), part
    assert sorted(a_emb) == sorted(b_emb)
    for cid in a_emb:
        np.testing.assert_array_equal(a_emb[cid], b_emb[cid])


def test_json_artifacts_are_byte_equal(cfg, docs_dir, tmp_path):
    ref, port = _ingested(cfg, docs_dir)
    ref_ckpt.save_ingestor(ref, tmp_path / "ref")
    ckpt.save_ingestor(port, tmp_path / "port")
    for name in ("corpus.json", "entities.json"):
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name
    # embeddings.npz carries zip timestamps: its arrays are compared instead
    a, b = (np.load(tmp_path / d / "embeddings.npz") for d in ("ref", "port"))
    for key in ("chunk_ids", "vectors"):
        np.testing.assert_array_equal(a[key], b[key])
    ma, mb = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("ref", "port"))
    assert ma["config"] == mb["config"] and ma["stats"] == mb["stats"]
    assert ma["entity_stats"] == mb["entity_stats"] and ma["format_version"] == mb["format_version"] == 2


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_loads_in_the_other_package(cfg, docs_dir, tmp_path, direction):
    ref, port = _ingested(cfg, docs_dir)
    d = tmp_path / "ckpt"
    if direction == "reference_to_port":
        ref_ckpt.save_ingestor(ref, d)
        corpus, store, emb, got_cfg = ckpt.load_checkpoint(d)
        assert isinstance(next(iter(corpus.documents.values())), Document)
        assert isinstance(store, EntityStore)
        src = ref
    else:
        ckpt.save_ingestor(port, d)
        corpus, store, emb, got_cfg = ref_ckpt.load_checkpoint(d)
        src = port
    _assert_same_state(src.corpus, src.entity_store, src.embeddings, corpus, store, emb)
    # the port's config also holds its own fields, at their defaults
    want = cfg if direction == "port_to_reference" else torch_config(cfg)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_loaded_rag_answers_as_the_reference(cfg, docs_dir, tmp_path, writer):
    """Either package's checkpoint, loaded by both facades: the staged query and the
    engine's batch give the reference's answers."""
    ref, port = _ingested(cfg, docs_dir)
    d = tmp_path / "ckpt"
    (ref_ckpt.save_ingestor(ref, d) if writer == "reference" else ckpt.save_ingestor(port, d))
    ref_rag = RefRAG.load(d)
    rag = RAG.load(d, device="cpu")
    assert rag.device.type == "cpu" and rag.config == torch_config(cfg)
    assert rag.stats() == ref_rag.stats()
    _compare([ref_rag.query(q) for q in QUERIES], [rag.query(q) for q in QUERIES], atol=ATOL)
    ref_rag._engine = ShardedEngine(ref_rag.retriever, single_device_mesh())
    _compare(ref_rag.query_batch(QUERIES), rag.query_batch(QUERIES), atol=ATOL)
    # the loaded RAG's placed rows are the saved ones, truncated as at ingest
    fresh = RAG(torch_config(cfg), device="cpu")
    fresh.ingestor = port
    np.testing.assert_array_equal(rag.retriever.state.embeddings.numpy(),
                                  fresh.retriever.state.embeddings.numpy())


def test_load_builds_the_embedder_once(cfg, docs_dir, tmp_path, monkeypatch):
    """RAG.load builds one ingestor on the RAG's device, with the RAG's embedder."""
    _, port = _ingested(cfg, docs_dir)
    ckpt.save_ingestor(port, tmp_path / "c")
    from triple_hybrid_rag_tpu_torch import ingest as ingest_mod

    built = []
    real = ingest_mod.get_default_embedder
    monkeypatch.setattr(ingest_mod, "get_default_embedder",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    rag = RAG.load(tmp_path / "c", device="cpu")
    assert len(built) == 1 and rag.ingestor.device.type == "cpu"
    assert rag.ingestor.embeddings.keys() == port.embeddings.keys()


def test_trusted_network_config_is_not_ported(cfg, tmp_path):
    c = torch_config(cfg)
    rag = RAG(c, device="cpu")
    rag.ingest_text("Invoices settle in thirty days.", name="p.md")
    d = tmp_path / "ckpt"
    ckpt.save_checkpoint(d, rag.ingestor.corpus, rag.ingestor.entity_store,
                         rag.ingestor.embeddings, c.replace(embed_api_base="http://localhost:1/v1"))
    assert RAG.load(d, device="cpu").config.embed_api_base == ""  # stripped: loads
    # trusted, the network fields stay and wire the HTTP embedder (ported since)
    trusted = RAG.load(d, device="cpu", trust_config=True)
    assert trusted.config.embed_api_base == "http://localhost:1/v1"
    assert type(trusted.ingestor.embedder.inner).__name__ == "HTTPEmbedder"


# --------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_checkpoint_facade_cli.py), on the port
# --------------------------------------------------------------------------


def _case_roundtrip(cfg, docs_dir, tmp_path):
    ing = Ingestor(config=cfg, device="cpu")
    ing.ingest_directory(docs_dir)
    d = tmp_path / "ckpt"
    ckpt.save_ingestor(ing, d)
    assert (d / "manifest.json").exists()
    ing2 = ckpt.load_ingestor(d, device="cpu")
    assert ing2.corpus.stats() == ing.corpus.stats()
    assert ing2.entity_store.stats() == ing.entity_store.stats()
    cid = ing.corpus.children[0].chunk_id
    np.testing.assert_array_equal(ing2.embeddings[cid], ing.embeddings[cid])
    r1 = ing.make_retriever().retrieve("invoice settlement")
    r2 = ing2.make_retriever().retrieve("invoice settlement")
    assert [x.chunk_id for x in r1.results] == [x.chunk_id for x in r2.results]


def _case_corruption(cfg, docs_dir, tmp_path):
    ing = Ingestor(config=cfg, device="cpu")
    ing.ingest_directory(docs_dir)
    d = tmp_path / "ckpt"
    ckpt.save_ingestor(ing, d)
    (d / "corpus.json").write_bytes(b"corrupted")
    with pytest.raises(ckpt.CheckpointError, match="hash mismatch"):
        ckpt.load_checkpoint(d)


def _case_missing(cfg, docs_dir, tmp_path):
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint"):
        ckpt.load_checkpoint(tmp_path / "nothing")
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint"):
        RAG.load(tmp_path / "nothing", device="cpu")


def _case_config_migration(cfg, docs_dir, tmp_path):
    ing = Ingestor(config=cfg, device="cpu")
    ing.ingest_directory(docs_dir)
    d = tmp_path / "ckpt"
    ckpt.save_ingestor(ing, d)
    ing2 = ckpt.load_ingestor(d, config=cfg.replace(embedding_dim=16), device="cpu")
    ret = ing2.make_retriever()
    assert ret.dense_index.dim == 16 and ret.state.dim == 16
    assert not ret.retrieve("invoice settlement").refused


def _case_facade_save_load(cfg, docs_dir, tmp_path):
    rag = RAG(config=cfg, device="cpu")
    assert all(r.status.value == "completed" for r in rag.ingest_directory(docs_dir))
    out = rag.query("fox in the forest", top_k=2)
    assert not out.refused and "fox" in out.results[0].text.lower()
    rag.ingest_text("Quantum computing hardware overview.", name="q.md")
    assert any("quantum" in r.text.lower() for r in rag.query("quantum computing").results)
    d = tmp_path / "rag_ckpt"
    rag.save(d)
    rag2 = RAG.load(d, device="cpu")
    assert rag2.stats()["children"] == rag.stats()["children"]
    out3 = rag2.query("fox in the forest", top_k=2)
    assert [r.chunk_id for r in out3.results] == [r.chunk_id for r in out.results]


def _case_api_key_and_network_fields(cfg, docs_dir, tmp_path):
    rag = RAG(config=cfg, device="cpu")
    rag.ingest_text("Invoices settle in thirty days.", name="p.md")
    c = cfg.replace(api_key="sk-SECRET", embed_api_base="http://evil.example:1/v1",
                    llm_api_base="http://evil.example:2/v1")
    d = tmp_path / "ckpt"
    ckpt.save_checkpoint(d, rag.ingestor.corpus, rag.ingestor.entity_store,
                         rag.ingestor.embeddings, c)
    assert "sk-SECRET" not in (d / "manifest.json").read_text()
    loaded = ckpt.load_checkpoint(d)[3]
    assert loaded.embed_api_base == "" and loaded.llm_api_base == "" and loaded.api_key == ""
    assert ckpt.load_checkpoint(d, trust_config=True)[3].embed_api_base == "http://evil.example:1/v1"


def _case_save_failure_keeps_previous(cfg, docs_dir, tmp_path):
    rag = RAG(config=cfg, device="cpu")
    rag.ingest_text("Invoices settle in thirty days.", name="p.md")
    d = tmp_path / "ckpt"
    rag.save(d)
    rag.ingest_text("Foxes live in the forest.", name="f.md")
    rag.ingestor.corpus.children[0].metadata["bad"] = object()
    with pytest.raises(TypeError):
        rag.save(d)
    corpus, _, _, _ = ckpt.load_checkpoint(d)
    assert len(corpus.children) == 1


def _case_numpy_metadata(cfg, docs_dir, tmp_path):
    rag = RAG(config=cfg, device="cpu")
    rag.ingest_text("Invoices settle in thirty days.", name="p.md")
    rag.ingestor.corpus.children[0].metadata["score"] = np.float32(0.5)
    rag.ingestor.corpus.children[0].metadata["vec"] = np.arange(3)
    d = tmp_path / "ckpt2"
    rag.save(d)
    corpus, _, _, _ = ckpt.load_checkpoint(d)
    assert abs(corpus.children[0].metadata["score"] - 0.5) < 1e-6
    assert corpus.children[0].metadata["vec"] == [0, 1, 2]


def _case_v1_pickle_gate(cfg, docs_dir, tmp_path):
    """A v1 (pickle) checkpoint the reference wrote: refused without allow_pickle;
    with it, its classes read as the port's."""
    ref = RefIngestor(config=reference_config(cfg))
    ref.ingest_directory(docs_dir)
    d = tmp_path / "v1"
    d.mkdir()
    with open(d / "corpus.pkl", "wb") as f:
        pickle.dump(ref.corpus.to_state(), f)
    with open(d / "entities.pkl", "wb") as f:
        pickle.dump(ref.entity_store, f)
    ids = list(ref.embeddings)
    with open(d / "embeddings.npz", "wb") as f:
        np.savez_compressed(f, chunk_ids=np.array(ids), vectors=np.stack([ref.embeddings[i] for i in ids]))
    artifacts = {n: hashlib.sha256((d / n).read_bytes()).hexdigest()
                 for n in ("corpus.pkl", "entities.pkl", "embeddings.npz")}
    (d / "manifest.json").write_text(json.dumps(
        {"format_version": 1, "config": dataclasses.asdict(cfg), "artifacts": artifacts}))
    for load in (ckpt.load_checkpoint, lambda p: RAG.load(p, device="cpu")):
        with pytest.raises(ckpt.CheckpointError, match="pickle"):
            load(d)
    corpus, store, emb, got_cfg = ckpt.load_checkpoint(d, allow_pickle=True)
    assert type(store) is EntityStore and type(next(iter(corpus.documents.values()))) is Document
    _assert_same_state(ref.corpus, ref.entity_store, ref.embeddings, corpus, store, emb)
    rag = RAG.load(d, device="cpu", allow_pickle=True)
    assert rag.query("invoice settlement").results and got_cfg == cfg
    bumped = json.loads((d / "manifest.json").read_text())
    bumped["format_version"] = 3
    (d / "manifest.json").write_text(json.dumps(bumped))
    with pytest.raises(ckpt.CheckpointError, match="format 3"):
        ckpt.load_checkpoint(d, allow_pickle=True)


CASES = {
    "roundtrip": _case_roundtrip,
    "corruption_detected": _case_corruption,
    "missing": _case_missing,
    "config_migration": _case_config_migration,
    "facade_ingest_query_save_load": _case_facade_save_load,
    "api_key_never_written_network_fields_stripped": _case_api_key_and_network_fields,
    "save_failure_keeps_previous": _case_save_failure_keeps_previous,
    "numpy_metadata": _case_numpy_metadata,
    "v1_pickle_gate": _case_v1_pickle_gate,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_checkpoint_case(cfg, docs_dir, tmp_path, case):
    CASES[case](torch_config(cfg), docs_dir, tmp_path)

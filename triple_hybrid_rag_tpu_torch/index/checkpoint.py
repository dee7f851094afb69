"""Index checkpoints: save and restore the corpus and what the indexes derive from.

The port of the JAX package's ``index/checkpoint.py``, in the same format (version
2), so a checkpoint that either package writes loads in the other:

- ``corpus.json`` / ``entities.json``: the host stores (documents, chunks, triples)
  as plain JSON, the same bytes from the same ingest (non-executable on load; format
  v1's ``corpus.pkl`` / ``entities.pkl`` load only behind an explicit
  ``allow_pickle=True``, the JAX package's classes read as the port's),
- ``embeddings.npz``: chunk_id -> full-dimension embedding (before the Matryoshka
  truncation, so a restore can re-truncate under another ``embedding_dim``),
- ``manifest.json``: the config snapshot (``api_key`` never written), counts and
  the SHA-256 of each artifact, written last through temp-then-rename.

Loading verifies the artifact hashes (corruption detection; tamper detection only
as far as the manifest itself is trusted) and strips the config's network fields
unless ``trust_config`` is set. The device indexes are rebuilt from the restored
stores when the restored :class:`~triple_hybrid_rag_tpu_torch.ingest.Ingestor`
first builds a retriever; the MaxSim token store is not saved (it is rebuilt with
``token_embeddings`` over every parent).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import pickle
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import PORT_ONLY_FIELDS, RAGConfig
from ..corpus import CorpusStore
from ..models.entity_extractor import EntityStore
from ..types import (
    ChildChunk,
    Document,
    Entity,
    EntityMention,
    EntityType,
    FileType,
    IngestionStatus,
    Modality,
    ParentChunk,
    Relation,
    RelationType,
)

MANIFEST = "manifest.json"
FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# JSON codecs for the host-store dataclasses (str-enums -> values, tuples -> lists)
# ---------------------------------------------------------------------------


def _json_default(obj: Any) -> Any:
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, np.generic):  # numpy scalars in user metadata dicts
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(
        f"not JSON-serializable: {type(obj)!r} (checkpoint format v2 stores host "
        "state as JSON; keep chunk/document metadata to JSON types)"
    )


def _dump_json(path: Path, payload: Any) -> None:
    # temp-then-rename per artifact: a crash mid-save must never destroy the
    # previously valid checkpoint in this directory (the manifest — written
    # LAST — still references the old, intact artifacts)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, default=_json_default, separators=(",", ":"))
    tmp.replace(path)


def _doc_from(d: dict) -> Document:
    d = dict(d)
    d["file_type"] = FileType(d["file_type"])
    d["status"] = IngestionStatus(d["status"])
    return Document(**d)


def _parent_from(d: dict) -> ParentChunk:
    return ParentChunk(**d)


def _child_from(d: dict) -> ChildChunk:
    d = dict(d)
    d["modality"] = Modality(d["modality"])
    return ChildChunk(**d)


def _entity_from(d: dict) -> Entity:
    d = dict(d)
    d["entity_type"] = EntityType(d["entity_type"])
    d["aliases"] = tuple(d.get("aliases", ()))
    return Entity(**d)


def _relation_from(d: dict) -> Relation:
    d = dict(d)
    d["relation_type"] = RelationType(d["relation_type"])
    return Relation(**d)


def _mention_from(d: dict) -> EntityMention:
    return EntityMention(**d)


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointError(RuntimeError):
    pass


_REFERENCE_PACKAGE = "triple_hybrid_rag_tpu"


class _PortUnpickler(pickle.Unpickler):
    """Reads a v1 pickle written by either package: the JAX package's classes
    (``triple_hybrid_rag_tpu.types.Document``, ...) resolve to the port's class of
    the same module and name, so loading one imports nothing of that package."""

    def find_class(self, module: str, name: str):
        if module == _REFERENCE_PACKAGE or module.startswith(_REFERENCE_PACKAGE + "."):
            module = __package__.split(".")[0] + module[len(_REFERENCE_PACKAGE):]
        return super().find_class(module, name)


def save_checkpoint(
    directory: str | Path,
    corpus: CorpusStore,
    entity_store: Optional[EntityStore] = None,
    embeddings: Optional[Dict[str, np.ndarray]] = None,
    config: Optional[RAGConfig] = None,
) -> Path:
    """Write all index-source artifacts; atomic via temp-then-rename of the manifest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    cstate = corpus.to_state()
    _dump_json(
        directory / "corpus.json",
        {
            "documents": {k: dataclasses.asdict(v) for k, v in cstate["documents"].items()},
            "parents": [dataclasses.asdict(p) for p in cstate["parents"]],
            "children": [dataclasses.asdict(c) for c in cstate["children"]],
        },
    )
    estate = entity_store.to_state() if entity_store else {"entities": [], "relations": [], "mentions": []}
    _dump_json(
        directory / "entities.json",
        {
            "present": entity_store is not None,
            "entities": [dataclasses.asdict(e) for e in estate["entities"]],
            "relations": [dataclasses.asdict(r) for r in estate["relations"]],
            "mentions": [dataclasses.asdict(m) for m in estate["mentions"]],
        },
    )

    emb_path = directory / "embeddings.npz"
    emb_tmp = directory / "embeddings.npz.tmp"
    # write through a file handle: np.savez_compressed(path) appends ".npz" to
    # names that lack it, which would break the temp-then-rename
    with open(emb_tmp, "wb") as f:
        if embeddings:
            ids = list(embeddings.keys())
            mat = np.stack([embeddings[i] for i in ids]).astype(np.float32)
            np.savez_compressed(f, chunk_ids=np.array(ids), vectors=mat)
        else:
            np.savez_compressed(
                f, chunk_ids=np.array([], dtype=str), vectors=np.zeros((0, 1), np.float32)
            )
    emb_tmp.replace(emb_path)

    artifacts = {}
    for name in ("corpus.json", "entities.json", "embeddings.npz"):
        artifacts[name] = _sha256_file(directory / name)

    cfg_dict = dataclasses.asdict(config) if config else None
    if cfg_dict is not None:
        cfg_dict["api_key"] = ""  # NEVER persist bearer tokens into a portable artifact
        for key in PORT_ONLY_FIELDS:  # at their defaults, the reference loads the file
            if cfg_dict[key] == getattr(RAGConfig, key):
                del cfg_dict[key]
    manifest = {
        "format_version": FORMAT_VERSION,
        "created_at": time.time(),
        "stats": corpus.stats(),
        "entity_stats": entity_store.stats() if entity_store else {},
        "config": cfg_dict,
        "artifacts": artifacts,
    }
    tmp = directory / (MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    tmp.replace(directory / MANIFEST)
    return directory


def load_checkpoint(
    directory: str | Path,
    verify: bool = True,
    allow_pickle: bool = False,
    trust_config: bool = False,
) -> Tuple[CorpusStore, Optional[EntityStore], Dict[str, np.ndarray], Optional[RAGConfig]]:
    """Restore artifacts; raises CheckpointError on missing/corrupt data.

    Format v2 checkpoints are plain JSON + npz — safe to load from untrusted storage:
    no code executes, and the embedded config's NETWORK fields (``*_api_base``,
    ``api_key``) are stripped unless ``trust_config=True`` — otherwise a crafted
    checkpoint could silently redirect every query/ingest to an attacker's model
    server (exfiltration/SSRF) the moment it is loaded. Legacy v1 checkpoints used
    pickle; loading them executes arbitrary code embedded in the file, so they
    require ``allow_pickle=True`` (only for checkpoints you wrote).
    """
    directory = Path(directory)
    mpath = directory / MANIFEST
    if not mpath.exists():
        raise CheckpointError(f"no checkpoint manifest at {directory}")
    manifest = json.loads(mpath.read_text())
    version = manifest.get("format_version")
    if version == 1:
        if not allow_pickle:
            raise CheckpointError(
                "format v1 checkpoints are pickle-based; loading executes code from the "
                "checkpoint. Pass allow_pickle=True only for checkpoints from a trusted "
                "source, or re-save with save_checkpoint() to migrate to v2 (JSON)."
            )
    elif version != FORMAT_VERSION:
        raise CheckpointError(f"checkpoint format {version} != {FORMAT_VERSION}")
    if verify:
        for name, want in manifest["artifacts"].items():
            p = directory / name
            if not p.exists():
                raise CheckpointError(f"missing artifact {name}")
            got = _sha256_file(p)
            if got != want:
                raise CheckpointError(f"artifact {name} hash mismatch (corrupt checkpoint)")

    if version == 1:
        # trusted path only; gated above
        with open(directory / "corpus.pkl", "rb") as f:
            corpus = CorpusStore.from_state(_PortUnpickler(f).load())
        with open(directory / "entities.pkl", "rb") as f:
            entity_store = _PortUnpickler(f).load()
    else:
        craw = json.loads((directory / "corpus.json").read_text())
        corpus = CorpusStore.from_state(
            {
                "documents": {k: _doc_from(v) for k, v in craw["documents"].items()},
                "parents": [_parent_from(p) for p in craw["parents"]],
                "children": [_child_from(c) for c in craw["children"]],
            }
        )
        eraw = json.loads((directory / "entities.json").read_text())
        entity_store = None
        if eraw.get("present", True):
            entity_store = EntityStore.from_state(
                {
                    "entities": [_entity_from(e) for e in eraw["entities"]],
                    "relations": [_relation_from(r) for r in eraw["relations"]],
                    "mentions": [_mention_from(m) for m in eraw["mentions"]],
                }
            )
    npz = np.load(directory / "embeddings.npz", allow_pickle=False)
    embeddings = {
        str(cid): vec for cid, vec in zip(npz["chunk_ids"], npz["vectors"])
    }
    cfg = None
    if manifest.get("config"):
        raw = dict(manifest["config"])
        for key in ("mesh_shape", "mesh_axis_names", "analyzer_languages"):
            if key in raw and isinstance(raw[key], list):
                raw[key] = tuple(raw[key])
        if not trust_config:
            for key in list(raw):
                if key.endswith("_api_base") or key == "api_key":
                    raw[key] = ""
        cfg = RAGConfig(**raw)
    return corpus, entity_store, embeddings, cfg


def save_ingestor(ingestor, directory: str | Path) -> Path:
    """Checkpoint an Ingestor's full state."""
    return save_checkpoint(
        directory, ingestor.corpus, ingestor.entity_store,
        ingestor.embeddings, ingestor.config,
    )


def load_ingestor(
    directory: str | Path,
    config: Optional[RAGConfig] = None,
    allow_pickle: bool = False,
    trust_config: bool = False,
    device=None,
    embedder=None,
):
    """Restore an Ingestor on ``device`` (and thereby a retriever via
    make_retriever()).

    Passing a different ``config`` (e.g. another ``embedding_dim``) re-derives device
    indexes under the new settings from the stored full-dim embeddings — the
    backfill/migration path. ``allow_pickle``/``trust_config`` thread through to
    :func:`load_checkpoint` (v1 migration / trusted-source network config);
    ``device`` and ``embedder`` to the :class:`Ingestor`."""
    from ..ingest import Ingestor

    corpus, entity_store, embeddings, saved_cfg = load_checkpoint(
        directory, allow_pickle=allow_pickle, trust_config=trust_config
    )
    ing = Ingestor(
        corpus=corpus, config=config or saved_cfg, entity_store=entity_store,
        embedder=embedder, device=device,
    )
    ing.embeddings = embeddings
    return ing

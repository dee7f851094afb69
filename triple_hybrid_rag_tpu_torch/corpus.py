"""The host corpus: the store ingestion writes into, and read-only views for decoding.

:class:`CorpusStore` is a copy of the JAX package's ``corpus.py`` store: documents
keyed by file hash (idempotent re-ingestion), parent and child chunks with stable
rows (the indices the device tensors are built over), child dedup by content hash
per collection, the child -> parent row table, collections, and the dirty flag that
tells the facade to rebuild its indexes.

The decode step needs two of its lookups, a child chunk by its row and a parent
chunk by its id. :class:`CorpusView` holds only those records (carried over from
the reference's store); :class:`SyntheticCorpusView` makes each record on demand
from its row, for the synthetic benchmark corpus (``synthetic.py``), whose million
rows carry no stored text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

from .types import ChildChunk, Document, IngestionStatus, Modality, ParentChunk


class CorpusView:
    """Children by row and parents by id."""

    def __init__(self, children: Sequence[ChildChunk], parents: Iterable[ParentChunk]) -> None:
        self.children = list(children)
        self._parents: Dict[str, ParentChunk] = {p.parent_id: p for p in parents}

    @classmethod
    def from_records(
        cls, children: Iterable[Mapping], parents: Iterable[Mapping]
    ) -> "CorpusView":
        """Build from plain records (e.g. ``dataclasses.asdict`` of the reference's
        chunks); keys beyond the decoded fields are ignored."""
        kids = [
            ChildChunk(
                chunk_id=c["chunk_id"], parent_id=c["parent_id"], doc_id=c["doc_id"],
                parent_idx=c.get("parent_idx", 0), child_idx=c.get("child_idx", 0),
                text=c["text"], modality=Modality(c.get("modality", "text")),
                section_heading=c.get("section_heading"),
                page_start=c.get("page_start", 0), page_end=c.get("page_end", 0),
                row=c.get("row", -1),
            )
            for c in children
        ]
        pars = [
            ParentChunk(parent_id=p["parent_id"], doc_id=p["doc_id"],
                        parent_idx=p.get("parent_idx", 0), text=p["text"], row=p.get("row", -1))
            for p in parents
        ]
        return cls(kids, pars)

    def __len__(self) -> int:
        return len(self.children)

    def child_by_row(self, row: int) -> ChildChunk:
        return self.children[row]

    def parent(self, parent_id: str) -> Optional[ParentChunk]:
        return self._parents.get(parent_id)


class SyntheticCorpusView:
    """Lazy view over a synthetic corpus: row r is child ``c{r}`` of parent
    ``p{r // children_per_parent}``, with the text ``text_of(r)``."""

    def __init__(self, n: int, text_of: Callable[[int], str], children_per_parent: int = 5) -> None:
        self.n = n
        self.text_of = text_of
        self.per_parent = children_per_parent

    def __len__(self) -> int:
        return self.n

    def child_by_row(self, row: int) -> ChildChunk:
        p = row // self.per_parent
        return ChildChunk(
            chunk_id=f"c{row}", parent_id=f"p{p}", doc_id=f"d{p}", parent_idx=p,
            child_idx=row % self.per_parent, text=self.text_of(row), row=row,
        )

    def parent(self, parent_id: str) -> Optional[ParentChunk]:
        p = int(parent_id[1:])
        if not 0 <= p * self.per_parent < self.n:
            return None
        return ParentChunk(
            parent_id=parent_id, doc_id=f"d{p}", parent_idx=p,
            text=self.text_of(p * self.per_parent), row=p,
        )


@dataclass
class AddChunksResult:
    added_parents: int = 0
    added_children: int = 0
    deduped_children: int = 0


class CorpusStore:
    """Append-only store of documents and two-level chunks with stable rows."""

    def __init__(self) -> None:
        self.documents: Dict[str, Document] = {}
        self.parents: List[ParentChunk] = []
        self.children: List[ChildChunk] = []
        self._parent_row: Dict[str, int] = {}
        self._child_row: Dict[str, int] = {}
        # (collection, content hash) -> chunk_id: dedup is PER COLLECTION, like
        # the reference's unique (org_id, content_hash) index (20260114_rag2_schema
        # :155-156) — global dedup silently dropped tenant B's copy of content
        # tenant A already had, making it unretrievable under B's row mask
        self._child_hashes: Dict[tuple, str] = {}
        self._dirty: bool = False  # device indexes stale?

    # ------------------------------------------------------------------
    # documents (idempotency)
    # ------------------------------------------------------------------

    def has_document(self, doc_id: str) -> bool:
        return doc_id in self.documents

    def register_document(self, doc: Document, force: bool = False) -> bool:
        """Register a document; returns False when already ingested and not forced
        (reference idempotency check, rag2/ingest.py:210-222)."""
        existing = self.documents.get(doc.doc_id)
        if existing is not None and existing.status == IngestionStatus.COMPLETED and not force:
            return False
        self.documents[doc.doc_id] = doc
        return True

    def set_status(self, doc_id: str, status: IngestionStatus) -> None:
        self.documents[doc_id].status = status

    # ------------------------------------------------------------------
    # chunks
    # ------------------------------------------------------------------

    def add_chunks(
        self,
        parents: Sequence[ParentChunk],
        children: Sequence[ChildChunk],
        dedup: bool = True,
    ) -> AddChunksResult:
        """Append chunks, assigning device rows; dedups children by content hash
        (tolerant insert semantics, reference rag2/ingest.py:457-462)."""
        res = AddChunksResult()
        # validate EVERY child's parent reference before touching any state: a
        # mid-iteration KeyError previously left appended rows behind with
        # _dirty unset, so derived indexes never saw them
        known = {p.parent_id for p in parents} | set(self._parent_row)
        for c in children:
            if c.parent_id not in known:
                raise KeyError(
                    f"child {c.chunk_id} references unknown parent {c.parent_id}"
                )
        for p in parents:
            if p.parent_id in self._parent_row:
                continue
            p.row = len(self.parents)
            self._parent_row[p.parent_id] = p.row
            self.parents.append(p)
            res.added_parents += 1
        for c in children:
            if c.chunk_id in self._child_row:
                res.deduped_children += 1
                continue
            doc = self.documents.get(c.doc_id)
            hkey = (doc.collection if doc else None, c.hash)
            if dedup and hkey in self._child_hashes:
                res.deduped_children += 1
                continue
            if c.parent_id not in self._parent_row:
                raise KeyError(f"child {c.chunk_id} references unknown parent {c.parent_id}")
            c.row = len(self.children)
            self._child_row[c.chunk_id] = c.row
            self._child_hashes[hkey] = c.chunk_id
            self.children.append(c)
            res.added_children += 1
        if res.added_parents or res.added_children:
            self._dirty = True
        return res

    # ------------------------------------------------------------------
    # lookups
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.children)

    @property
    def n_parents(self) -> int:
        return len(self.parents)

    def child_by_row(self, row: int) -> ChildChunk:
        return self.children[row]

    def parent_by_row(self, row: int) -> ParentChunk:
        return self.parents[row]

    def child(self, chunk_id: str) -> Optional[ChildChunk]:
        row = self._child_row.get(chunk_id)
        return self.children[row] if row is not None else None

    def parent(self, parent_id: str) -> Optional[ParentChunk]:
        row = self._parent_row.get(parent_id)
        return self.parents[row] if row is not None else None

    def parent_row_of_child(self, child_row: int) -> int:
        return self._parent_row[self.children[child_row].parent_id]

    def parent_rows(self) -> List[int]:
        """child row -> parent row mapping (device gather table for parent expansion,
        replacing rag2_expand_to_parents SQL RPC, 20260114_rag2_schema.sql:499)."""
        return [self._parent_row[c.parent_id] for c in self.children]

    # ------------------------------------------------------------------
    # collections (multi-tenancy: the org/collection scoping the reference enforces
    # with RLS policies + org_id filters, 20260114_rag2_schema.sql:288-317)
    # ------------------------------------------------------------------

    def collection_names(self) -> List[str]:
        """Stable collection registry (order of first appearance)."""
        seen: Dict[str, None] = {}
        for doc in self.documents.values():
            seen.setdefault(doc.collection)
        return list(seen)

    def collection_ids(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.collection_names())}

    def child_collection_rows(self) -> List[int]:
        """child row -> collection id (device filter table; -1 when doc unknown)."""
        ids = self.collection_ids()
        out = []
        for c in self.children:
            doc = self.documents.get(c.doc_id)
            out.append(ids.get(doc.collection, -1) if doc else -1)
        return out

    def child_texts(self) -> List[str]:
        return [c.text for c in self.children]

    def parent_texts(self) -> List[str]:
        return [p.text for p in self.parents]

    def children_of_parent(self, parent_id: str) -> List[ChildChunk]:
        return [c for c in self.children if c.parent_id == parent_id]

    # ------------------------------------------------------------------
    # index staleness
    # ------------------------------------------------------------------

    @property
    def dirty(self) -> bool:
        return self._dirty

    def mark_clean(self) -> None:
        self._dirty = False

    # ------------------------------------------------------------------
    # stats / checkpoint support
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "documents": len(self.documents),
            "parents": len(self.parents),
            "children": len(self.children),
        }

    def to_state(self) -> dict:
        return {
            "documents": self.documents,
            "parents": self.parents,
            "children": self.children,
        }

    @classmethod
    def from_state(cls, state: dict) -> "CorpusStore":
        store = cls()
        store.documents = dict(state["documents"])
        for p in state["parents"]:
            p.row = len(store.parents)
            store._parent_row[p.parent_id] = p.row
            store.parents.append(p)
        for c in state["children"]:
            c.row = len(store.children)
            store._child_row[c.chunk_id] = c.row
            doc = store.documents.get(c.doc_id)
            store._child_hashes[(doc.collection if doc else None, c.hash)] = c.chunk_id
            store.children.append(c)
        store._dirty = True
        return store

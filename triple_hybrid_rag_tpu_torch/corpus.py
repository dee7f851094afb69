"""Read-only corpus views for decoding result rows into chunk records.

The decode step needs two lookups of the JAX package's ``CorpusStore``: a child
chunk by its row and a parent chunk by its id. :class:`CorpusView` holds those
records; :class:`SyntheticCorpusView` makes each record on demand from its row, for
the synthetic benchmark corpus (``synthetic.py``), whose million rows carry no
stored text.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

from .types import ChildChunk, Modality, ParentChunk


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
                text=c["text"], modality=Modality(c.get("modality", "text")),
                section_heading=c.get("section_heading"),
                page_start=c.get("page_start", 0), page_end=c.get("page_end", 0),
                row=c.get("row", -1),
            )
            for c in children
        ]
        pars = [
            ParentChunk(parent_id=p["parent_id"], doc_id=p["doc_id"], text=p["text"],
                        row=p.get("row", -1))
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
            chunk_id=f"c{row}", parent_id=f"p{p}", doc_id=f"d{p}",
            text=self.text_of(row), row=row,
        )

    def parent(self, parent_id: str) -> Optional[ParentChunk]:
        p = int(parent_id[1:])
        if not 0 <= p * self.per_parent < self.n:
            return None
        return ParentChunk(
            parent_id=parent_id, doc_id=f"d{p}",
            text=self.text_of(p * self.per_parent), row=p,
        )

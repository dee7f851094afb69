"""Entity-name lookup for graph seeding: the lookup half of the JAX package's
``EntityStore`` (exact canonical key, then substring / trigram-fuzzy candidates from a
trigram inverted index). Extraction and linking are not ported yet;
:meth:`EntityStore.from_items` fills the store from (key, entity) rows."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from ..analyzer import strip_accents, trigrams
from ..types import Entity


def canonical_key(name: str) -> str:
    """Upsert key: accent-stripped, lowercased, whitespace-collapsed."""
    return " ".join(strip_accents(name.lower()).split())


class EntityStore:
    """canonical key -> Entity, with the reference's lookup semantics. Keys must be
    inserted in the reference store's order so equal-similarity candidates come back
    in the same order."""

    def __init__(self) -> None:
        self.entities: Dict[str, Entity] = {}
        self._by_id: Dict[str, Entity] = {}

    @classmethod
    def from_items(cls, items: Iterable[Tuple[str, Entity]]) -> "EntityStore":
        """A store holding ``(canonical key, entity)`` rows in the given order."""
        store = cls()
        for key, ent in items:
            store.entities[key] = ent
            store._by_id[ent.entity_id] = ent
        return store

    def _trgm_index(self):
        """Trigram inverted index over canonical keys, rebuilt when the count changes."""
        if getattr(self, "_trgm_n", -1) != len(self.entities):
            table: Dict[str, List[str]] = {}
            tsets: Dict[str, frozenset] = {}
            for k in self.entities:
                ts = trigrams(k)
                tsets[k] = ts
                for g in ts:
                    table.setdefault(g, []).append(k)
            self._trgm_table = table
            self._trgm_sets = tsets
            self._trgm_n = len(self.entities)
        return self._trgm_table, self._trgm_sets

    def lookup(self, name: str, fuzzy_threshold: float = 0.35) -> List[Entity]:
        """Exact canonical / substring / trigram-fuzzy entity lookup."""
        key = canonical_key(name)
        exact = self.entities.get(key)
        if exact is not None:
            return [exact]
        if not key:
            return []
        table, tsets = self._trgm_index()
        qt = trigrams(key)
        counts: Dict[str, int] = {}
        for g in qt:
            for k in table.get(g, ()):
                counts[k] = counts.get(k, 0) + 1
        out = []
        for k, c in counts.items():
            if key in k or k in key:
                out.append((0.99, self.entities[k]))
                continue
            kt = tsets[k]
            sim = c / (len(qt) + len(kt) - c)  # jaccard from shared count
            if sim >= fuzzy_threshold:
                out.append((sim, self.entities[k]))
        out.sort(key=lambda x: -x[0])
        return [e for _, e in out]

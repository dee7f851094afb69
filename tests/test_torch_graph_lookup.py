"""The port's ``GraphIndex`` lookup API and Cypher executor against the JAX
reference's, on the CPU.

Both packages build their graph index from the same documents (the entity fixture
of ``tests/test_graph.py``, chunked and extracted by each package's own chunker and
extractor, which are bit-equal). Every lookup must answer as the reference's does:
entities and paths equal, k-hop chunk rows equal and their scores ``1 / (1 + d)``
equal bit for bit, hop distances equal. The Cypher translation is a copy: the op,
or the error and its message, must be equal for every query of
``tests/test_cypher.py``, and each translatable query must execute to the
reference's result. Under a ``Retriever`` the device lookups read the placed
tables (no second copy).
"""

import hashlib

import numpy as np
import pytest

from triple_hybrid_rag_tpu.chunker import HierarchicalChunker as RefChunker
from triple_hybrid_rag_tpu.corpus import CorpusStore as RefCorpus
from triple_hybrid_rag_tpu.index.cypher import translate_cypher as ref_translate
from triple_hybrid_rag_tpu.index.graph_index import build_graph_index as ref_build
from triple_hybrid_rag_tpu.models.entity_extractor import EntityStore as RefStore
from triple_hybrid_rag_tpu.models.entity_extractor import RuleBasedExtractor as RefExtractor

from test_graph import GRAPH_DOCS
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.chunker import HierarchicalChunker
from triple_hybrid_rag_tpu_torch.corpus import CorpusStore
from triple_hybrid_rag_tpu_torch.index.cypher import CypherTranslationError, translate_cypher
from triple_hybrid_rag_tpu_torch.index.graph_index import build_graph_index
from triple_hybrid_rag_tpu_torch.models.entity_extractor import EntityStore, RuleBasedExtractor
from triple_hybrid_rag_tpu_torch.retrieval import Retriever

NAMES = ["John Smith", "Acme Corp", "acme", "CloudStack Systems", "Beta Logistics",
         "Maria Silva", "Lisbon", "Porto", "nobody here at all"]
PAIRS = [("John Smith", "CloudStack Systems"), ("Maria Silva", "Porto"), ("Acme Corp", "acme corp"),
         ("John Smith", "nobody here at all"), ("Gardening", "Acme Corp")]
# (cypher, parameters) of tests/test_cypher.py, the untranslatable ones included
CYPHER = [
    ("MATCH (e {name: 'O\\'Brien'})-[*1..3]->(x) LIMIT $n", {"n": 4}),
    ("MATCH (e:Entity {name: 'Acme Corp'})-[*1..3]-(related) "
     "MATCH (related)-[:MENTIONED_IN]->(c:Chunk) RETURN c LIMIT 25", None),
    ("MATCH (e:Entity {name: 'Acme Corp'})-[r]-(b) RETURN b", None),
    ("MATCH (e:Entity {name: 'Acme Corp'}) RETURN e", None),
    ("MATCH (e:Entity) WHERE e.name CONTAINS 'acme' RETURN e LIMIT 5", None),
    ("MATCH (e:Entity) WHERE e.name IN ['acme', 'beta'] RETURN e LIMIT 7", None),
    ("MATCH p = shortestPath((a {name: 'John Smith'})-[*..4]-"
     "(b {name: 'CloudStack Systems'})) RETURN p", None),
    ("MATCH (e:Entity {name: $entity, tenant_id: $tenant_id})-[*1..2]-(r) RETURN r LIMIT $limit",
     {"entity": "Beta Logistics", "tenant_id": "t1", "limit": 10}),
    ("MATCH (e {name: 'X'})-[:WORKS_FOR|PARTNERS_WITH*2]->(o) RETURN o", None),
    ("CREATE (n:Entity {name: 'x'})", None),
    ("MATCH (e) WHERE e.age > 3 RETURN e", None),
    ("MATCH (e) RETURN e", None),
    ("MATCH (e {name: $who}) RETURN e", None),
    ("MATCH (e {name: 'Acme', type: 'PERSON'}) RETURN e", None),
    ("MATCH (e {name: 'Acme', tenant_id: 't1'}) RETURN e", None),
    ("MATCH (e {name: 'Acme'}) WHERE e.type = 'PERSON' RETURN e", None),
    ("MATCH (a {name: 'Acme'})-[r]-(b) WHERE b.name CONTAINS 'bank' RETURN b", None),
    ("MATCH (e {name: 'Acme'})-[r]-(b) WHERE e.tenant_id = $t RETURN b", {"t": "org-1"}),
    ("MATCH (e:Entity {name: 'John Smith'})-[*1..2]-(related) "
     "MATCH (related)-[:MENTIONED_IN]->(c:Chunk) RETURN c LIMIT 10", None),
    ("MATCH (e:Entity) WHERE e.name CONTAINS $q RETURN e", {"q": "Acme"}),
]


def _fixture(chunker, corpus, store, extractor):
    for name, text in GRAPH_DOCS.items():
        doc_id = hashlib.sha256(name.encode()).hexdigest()
        parents, children = chunker.chunk_document(text, doc_id)
        corpus.add_chunks(parents, children)
        for p in parents:
            store.store_extraction(extractor.extract(p, [c for c in children if c.parent_id == p.parent_id]))
    return corpus, store


@pytest.fixture
def graphs(small_config):
    cfg = small_config.replace(embedding_dtype="float32", safety_threshold=0.3)
    tcfg = torch_config(cfg)
    rc, rs = _fixture(RefChunker(cfg), RefCorpus(), RefStore(), RefExtractor(cfg))
    pc, ps = _fixture(HierarchicalChunker(tcfg), CorpusStore(), EntityStore(), RuleBasedExtractor(tcfg))
    return ref_build(rs, rc, cfg), build_graph_index(ps, pc, tcfg), pc


def _names(ents):
    return None if ents is None else [(e.canonical_name, e.entity_type.value, e.entity_id) for e in ents]


def _same_khop(ref_out, port_out):
    ids, scores = (np.asarray(x) for x in ref_out)
    np.testing.assert_array_equal(port_out[0].numpy(), ids)
    np.testing.assert_array_equal(port_out[1].numpy(), scores)


def test_tables_match(graphs):
    ref, port, _ = graphs
    np.testing.assert_array_equal(port.nbr, np.asarray(ref.nbr))
    np.testing.assert_array_equal(port.chunk_entities, ref.host_chunk_entities)
    assert port.host_adj == ref.host_adj and _names(port.entity_rows) == _names(ref.entity_rows)


@pytest.mark.parametrize("name", NAMES)
def test_lookups_match_reference(graphs, name):
    ref, port, _ = graphs
    assert _names(port.entity_lookup(name)) == _names(ref.entity_lookup(name))
    for limit in (1, 3):
        assert _names(port.seed_lookup(name, limit)) == _names(ref.seed_lookup(name, limit))
    for limit in (1, 20):
        assert _names(port.related_entities(name, limit)) == _names(ref.related_entities(name, limit))
    for hops, limit in ((1, 8), (2, 8), (2, 3), (3, 20)):
        _same_khop(ref.entity_neighborhood(name, hops=hops, limit=limit),
                   port.entity_neighborhood(name, hops=hops, limit=limit))
    _same_khop(ref.entity_neighborhood(name), port.entity_neighborhood(name))
    for hops in (1, 2):
        assert port.entity_distances(name, hops) == ref.entity_distances(name, hops)
    words = name.lower().split()
    _same_khop(ref.search_by_keywords_graph(words), port.search_by_keywords_graph(words))
    _same_khop(ref.search_by_keywords_graph(words, top_k=2),
               port.search_by_keywords_graph(words, top_k=2))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(p))
def test_relation_path_matches_reference(graphs, pair):
    ref, port, _ = graphs
    for max_hops in (1, 4):
        assert _names(port.relation_path(*pair, max_hops)) == _names(ref.relation_path(*pair, max_hops))


@pytest.mark.parametrize("cypher,params", CYPHER, ids=range(len(CYPHER)))
def test_cypher_matches_reference(graphs, cypher, params):
    ref, port, _ = graphs
    try:
        want = ref_translate(cypher, params)
    except ValueError as e:
        with pytest.raises(CypherTranslationError) as got:
            translate_cypher(cypher, params)
        assert str(got.value) == str(e)
        with pytest.raises(CypherTranslationError):
            port.execute_cypher(cypher, params)
        return
    assert translate_cypher(cypher, params) == want
    assert port.execute_cypher(cypher, params) == ref.execute_cypher(cypher, params)


def test_execute_query_ops_match_reference(graphs):
    ref, port, _ = graphs
    for q in ({"op": "neighborhood", "entity": "Acme Corp", "hops": 1, "limit": 4},
              {"op": "keywords", "keywords": ["acme", "cloudstack"], "limit": 5},
              {"op": "related", "entity": "Acme Corp", "limit": 2},
              {"op": "path", "from": "Maria Silva", "to": "John Smith", "max_hops": 2},
              {"op": "lookup", "entity": "beta"},
              {"op": "keywords", "keywords": []}):
        assert port.execute_query(q) == ref.execute_query(q), q
    for bad in ({"op": "drop"}, {}):
        with pytest.raises(ValueError, match="unknown graph op"):
            port.execute_query(bad)


def test_device_lookups_read_the_placed_tables(graphs):
    """Under a Retriever the k-hop lookups run over the state's placed nbr and
    chunk_entities; an index never placed reads its host tables without a copy."""
    ref, port, corpus = graphs
    assert port.placed is None
    nbr, ce = port._tables()
    assert nbr.data_ptr() == port.nbr.ctypes.data and ce.data_ptr() == port.chunk_entities.ctypes.data
    want = {n: port.entity_neighborhood(n) for n in NAMES}
    ret = Retriever(corpus, port.config, graph_index=port, device="cpu")
    assert port.placed is ret.state
    assert port._tables()[0] is ret.state.nbr and port._tables()[1] is ret.state.chunk_entities
    for n in NAMES:
        got = port.entity_neighborhood(n)
        assert got[0].device == ret.state.device
        _same_khop(want[n], got)
        assert port.entity_distances(n) == ref.entity_distances(n)

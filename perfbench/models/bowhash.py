"""Embedder ``bowhash`` (program side): the program's ``BowHashEmbedder`` at the
configuration's full width, the default query embedder of the benchmark. Its rows
and MaxSim tokens are the generator's (``lib/generator.py`` sums the same hash
directions), so it places nothing and loads no weights."""


def build(inputs, state):
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder

    return BowHashEmbedder(dim=inputs.cfg.embedding_dim_full, config=inputs.cfg)

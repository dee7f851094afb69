"""Basic usage of the PyTorch port, step for step as ``examples/basic_usage.py``.

Run:  python examples/torch_basic_usage.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given; without a card and without
that flag it stops with an error, as every entry point of the port does. Offline:
the packaged encoder (or the hash embedders without it), rule-based planner and NER.
It imports the port and the standard library only, and ends by printing whether a
JAX module was loaded and how often the kernels of the staged query launched.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
from triple_hybrid_rag_tpu_torch.kernels.build import launch_counts


def main(device=None) -> None:
    # every capability is a config switch (RAG_* environment: RAGConfig.from_env());
    # safety_threshold 0.35 as in the JAX example
    config = RAGConfig(
        graph_enabled=True,       # knowledge-graph channel (entity k-hop expansion)
        rerank_backend="maxsim",  # late-interaction rerank (the MaxSim kernel)
        safety_threshold=0.35,    # refuse when nothing clears this
    )
    rag = RAG(config=config, device=device)

    # --- ingest: load -> chunk -> embed -> index -> NER -> graph -------------
    rag.ingest_text(
        """# Service Agreement

        Acme Corp and Beta Logistics sign this agreement. Invoices must be settled
        within thirty days; late settlement incurs a two percent penalty.
        Maria Silva works for Acme Corp and approves all invoices.

        ## Termination
        The termination clause requires ninety days written notice.""",
        name="agreement.md",
    )
    rag.ingest_text(
        "# Wildlife Notes\n\nRed foxes share the northern forest with brown bears.",
        name="wildlife.md",
    )
    print("corpus:", rag.stats())

    # --- query: plan -> 3 channels -> RRF -> expand -> rerank -> safety ------
    before = launch_counts()
    for query in (
        "How long do we have to pay an invoice?",
        "Who works for Acme Corp?",          # lights up the graph channel
        "what animals live in the forest",
        "completely unrelated gibberish zzz",  # refused by the safety gate
    ):
        result = rag.query(query, top_k=2)
        print(f"\nQ: {query}")
        if result.refused:
            print(f"  REFUSED: {result.refusal_reason}")
            continue
        for r in result.results:
            print(f"  [{r.final_score:.3f}] {'+'.join(r.source_channels)}: {r.text[:70]!r}")
        print(f"  ({result.timings['total_ms']:.1f} ms)")
    after = launch_counts()
    grew = {k: v - before.get(k, 0) for k, v in after.items()}
    launches = {"dense_scores": grew.get("dense_scores_bf16", 0) + grew.get("dense_scores_f32", 0),
                "maxsim": grew.get("maxsim_scores_bf16", 0) + grew.get("maxsim_scores_int8", 0)}

    # --- graph API ------------------------------------------------------------
    gx = rag.retriever.graph_index
    if gx is not None:
        print("\nentities related to Acme Corp:",
              [e.canonical_name for e in gx.related_entities("Acme Corp")])
        print("graph query:", gx.execute_query({"op": "lookup", "entity": "Maria Silva"}))

    # --- persistence ----------------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        rag.save(Path(d) / "thr_example_index")
        restored = RAG.load(Path(d) / "thr_example_index", device=device)
        print("\nrestored corpus:", restored.stats())

    print("\njax loaded:", any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules))
    print("kernel launches:", json.dumps(launches))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    main(ap.parse_args().device)

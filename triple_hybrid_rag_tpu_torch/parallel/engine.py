"""``ShardedEngine``: the reference's constructor over the port's :class:`Engine`.

``ShardedEngine(retriever, mesh)`` serves a retriever's placed index over a
``data`` x ``shard`` mesh (``parallel/mesh.py``); the program is
:class:`~triple_hybrid_rag_tpu_torch.engine.Engine`'s, which takes a mesh itself.
"""

from __future__ import annotations

from typing import Optional

from ..engine import Engine
from .mesh import DeviceMesh, default_mesh


class ShardedEngine(Engine):
    """The batched query program of ``retriever``'s index over ``mesh``. Without a
    mesh: every visible card when the retriever is on the default CUDA device, else
    the retriever's device alone (:func:`~.mesh.default_mesh`)."""

    def __init__(self, retriever, mesh: Optional[DeviceMesh] = None) -> None:
        Engine.__init__(
            self, retriever.state, embedder=retriever.embedder, planner=retriever.planner,
            device=retriever.device,
            dot_rerank=getattr(retriever.reranker, "parent_embeddings", None) is not None,
            mesh=mesh if mesh is not None else default_mesh(retriever.device),
        )
        self.retriever = retriever

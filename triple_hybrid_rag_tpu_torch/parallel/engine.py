"""``ShardedEngine``: the reference's constructor over the port's :class:`Engine`.

``ShardedEngine(retriever, mesh)`` serves a retriever's placed index over a
``data`` x ``shard`` mesh (``parallel/mesh.py``); the program is
:class:`~triple_hybrid_rag_tpu_torch.engine.Engine`'s, which takes a mesh itself.
Its :meth:`ShardedEngine.refresh` takes a retriever, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

from ..engine import Engine
from ..observability.metrics import rag_metrics
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
        self.last_refresh_error: Optional[BaseException] = None

    def refresh(self, retriever=None) -> bool:  # type: ignore[override]
        """Re-place an updated retriever's index over this engine's mesh (default:
        the engine's own retriever) and keep the retriever. True when the fast path
        applied; False when the shapes or the config changed (build a new engine),
        or when placement raised: the error is then kept in ``last_refresh_error``
        and counted in ``engine_refresh_errors_total``, as the reference does."""
        retriever = self.retriever if retriever is None else retriever
        try:
            ok = Engine.refresh(self, retriever.state)
        except Exception as e:  # a real failure (device memory, a bug), not "shapes changed"
            self.last_refresh_error = e
            rag_metrics.counter("engine_refresh_errors_total").inc()
            return False
        self.last_refresh_error = None
        if ok:
            self.retriever = retriever
        return ok

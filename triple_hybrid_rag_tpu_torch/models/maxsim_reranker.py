"""The MaxSim late-interaction reranker (the primary rerank backend).

The port of the JAX package's ``models/maxsim_reranker.py``. It scores a query's
candidate parents with :meth:`MaxSimIndex.score_candidates
<triple_hybrid_rag_tpu_torch.index.maxsim_index.MaxSimIndex.score_candidates>` (the
MaxSim kernel on a CUDA store, whatever the reference's ``use_pallas`` says) and
rescales the scores by the embedder's calibration. It expects ``q_tokens`` f32[Tq, D]
and ``q_mask`` f32[Tq] (the query-token weights) in the query context, made by the
retriever's query stage with the embedder that built the store. While a profiler
records, a score is the range ``engine.staged.maxsim``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RAGConfig, get_settings
from ..index.maxsim_index import MaxSimIndex
from ..observability.profiling import annotate
from ..ops.fusion import minmax_normalize
from ..ops.maxsim import calibrate_maxsim


class MaxSimReranker:
    def __init__(
        self,
        index: MaxSimIndex,
        config: Optional[RAGConfig] = None,
        calibration: float = 1.0,
    ) -> None:
        self.index = index
        self.config = config or get_settings()
        # the anchored encoder's score renormalization (ops.maxsim.calibrate_maxsim),
        # which keeps the 0.6 gate's meaning; 1.0 is the identity
        self.calibration = calibration

    def score(self, query_ctx: dict, ids: torch.Tensor, fused_scores: torch.Tensor) -> torch.Tensor:
        with annotate("engine.staged.maxsim"):
            q_tokens = query_ctx.get("q_tokens")
            q_mask = query_ctx.get("q_mask")
            if q_tokens is None or q_mask is None:
                # no token-level query context: the normalised fused order
                return minmax_normalize(ids, fused_scores)
            return calibrate_maxsim(
                self.index.score_candidates(ids, q_tokens, q_mask), self.calibration
            )

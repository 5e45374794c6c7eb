"""Staged FaTRQ search over the static layout with the IVF front.

``stages`` (IVF front with the PQ-ADC kernel, ``reference`` and ``cuda``
refine backends, exact rerank) → ``executor`` (micro-batches, one ledger
fold per search) → ``api`` (``Database`` / ``QueryPlan`` /
``SearchResult``); ``pipeline`` holds the build.
"""

from repro_torch.anns.api import Database, PlanError, QueryPlan, \
    SearchResult
from repro_torch.anns.pipeline import (FaTRQIndex, PipelineConfig, build,
                                       recall_at_k)

__all__ = ["Database", "PlanError", "QueryPlan", "SearchResult",
           "FaTRQIndex", "PipelineConfig", "build", "recall_at_k"]

"""Staged FaTRQ search with the IVF and graph fronts, on the static,
sharded, streaming and tiered layouts.

``stages`` (IVF and graph fronts with the PQ-ADC kernel, ``reference`` and
``cuda`` refine backends, exact rerank) → ``executor`` (micro-batches,
bucket padding, one ledger fold per search) → ``api`` (``Database`` /
``QueryPlan`` / ``SearchResult`` / ``CompiledPlan``); ``sharding``
partitions the database into shards and searches them with pooled
thresholds; ``streaming`` makes an index mutable (inserts, tombstones,
compaction, rebalancing); ``tiered`` places IVF lists hot/warm/cold by
observed heat; ``pipeline`` holds the build and the legacy ``search`` /
``baseline_search`` tuple shims over ``Database.query``.
"""

from repro_torch.anns.api import CompiledPlan, Database, PlanError, \
    QueryPlan, SearchResult
from repro_torch.anns.pipeline import (FaTRQIndex, PipelineConfig,
                                       baseline_search, build, recall_at_k,
                                       search)
from repro_torch.anns.sharding import (ShardedExecutor, ShardedIndex,
                                       lpt_assign, make_sharded_executor,
                                       partition_database)
from repro_torch.anns.streaming import StreamingConfig, StreamingIndex
from repro_torch.anns.tiered import TieredFrontStage, TieredIndex
from repro_torch.memory.placement import TieredConfig

__all__ = ["CompiledPlan", "Database", "PlanError", "QueryPlan",
           "SearchResult", "FaTRQIndex", "PipelineConfig", "baseline_search",
           "build", "recall_at_k", "search",
           "ShardedExecutor", "ShardedIndex", "lpt_assign",
           "make_sharded_executor", "partition_database",
           "StreamingConfig", "StreamingIndex", "TieredConfig",
           "TieredFrontStage", "TieredIndex"]

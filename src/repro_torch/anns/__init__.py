"""Staged FaTRQ search with the IVF and graph fronts, on the static,
sharded, streaming and tiered layouts.

``stages`` (IVF and graph fronts with the PQ-ADC kernel, ``reference`` and
``cuda`` refine backends, exact rerank) → ``executor`` (micro-batches, one
ledger fold per search) → ``api`` (``Database`` / ``QueryPlan`` /
``SearchResult``); ``sharding`` partitions the database into shards and
searches them with pooled thresholds; ``streaming`` makes an index
mutable (inserts, tombstones, compaction, rebalancing); ``tiered`` places
IVF lists hot/warm/cold by observed heat; ``pipeline`` holds the build.
"""

from repro_torch.anns.api import Database, PlanError, QueryPlan, \
    SearchResult
from repro_torch.anns.pipeline import (FaTRQIndex, PipelineConfig, build,
                                       recall_at_k)
from repro_torch.anns.sharding import (ShardedExecutor, ShardedIndex,
                                       lpt_assign, make_sharded_executor,
                                       partition_database)
from repro_torch.anns.streaming import StreamingConfig, StreamingIndex
from repro_torch.anns.tiered import TieredFrontStage, TieredIndex
from repro_torch.memory.placement import TieredConfig

__all__ = ["Database", "PlanError", "QueryPlan", "SearchResult",
           "FaTRQIndex", "PipelineConfig", "build", "recall_at_k",
           "ShardedExecutor", "ShardedIndex", "lpt_assign",
           "make_sharded_executor", "partition_database",
           "StreamingConfig", "StreamingIndex", "TieredConfig",
           "TieredFrontStage", "TieredIndex"]

from repro_torch.memory.layout import RecordLayout
from repro_torch.memory.tiers import (TABLE_I, QueryCost, Tier, TierSpec,
                                      Traffic)

__all__ = ["RecordLayout", "TABLE_I", "QueryCost", "Tier", "TierSpec",
           "Traffic"]

from repro_torch.memory.layout import RecordLayout
from repro_torch.memory.placement import (TIER_COLD, TIER_HOT, TIER_NAMES,
                                          TIER_WARM, HeatTracker,
                                          TieredConfig, occupancy,
                                          plan_migration, plan_placement)
from repro_torch.memory.tiers import (TABLE_I, QueryCost, Tier, TierSpec,
                                      Traffic)

__all__ = ["RecordLayout", "TABLE_I", "QueryCost", "Tier", "TierSpec",
           "Traffic", "TIER_HOT", "TIER_WARM", "TIER_COLD", "TIER_NAMES",
           "HeatTracker", "TieredConfig", "occupancy", "plan_migration",
           "plan_placement"]

"""The serving layer: the continuous-batching ``ServingEngine`` with its
result cache, and the ``Retriever`` (``serving.scheduler``,
``serving.cache``)."""

from repro_torch.serving.cache import (CacheStats, ResultCache, query_key,
                                      query_keys)
from repro_torch.serving.scheduler import (Request, Response, Retriever,
                                           ServingEngine, ServingStats,
                                           TenantQoS, TokenBucket,
                                           VirtualClock)

__all__ = ["Retriever", "Request", "Response", "ServingEngine",
           "ServingStats", "TenantQoS", "TokenBucket", "VirtualClock",
           "CacheStats", "ResultCache", "query_key", "query_keys"]

# re-exported for serving callers building plans (their home: anns)
from repro_torch.anns.api import (Database, QueryPlan,  # noqa: E402,F401
                                  SearchResult)

__all__ += ["Database", "QueryPlan", "SearchResult"]

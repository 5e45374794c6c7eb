"""The serving layer: the continuous-batching ``ServingEngine`` with its
result cache, the ``Retriever``, and the LM side: the decode ``Engine``
and the ``rag_answer`` round trip (``serving.scheduler``,
``serving.cache``)."""

from repro_torch.serving.cache import (CacheStats, ResultCache, query_key,
                                      query_keys)
from repro_torch.serving.scheduler import (Engine, RagResult, Request,
                                           Response, Retriever, ServeStats,
                                           ServingEngine, ServingStats,
                                           TenantQoS, TokenBucket,
                                           VirtualClock, rag_answer)

__all__ = ["Engine", "RagResult", "Retriever", "ServeStats", "rag_answer",
           "Request", "Response", "ServingEngine",
           "ServingStats", "TenantQoS", "TokenBucket", "VirtualClock",
           "CacheStats", "ResultCache", "query_key", "query_keys"]

# re-exported for serving callers building plans (their home: anns)
from repro_torch.anns.api import (Database, QueryPlan,  # noqa: E402,F401
                                  SearchResult)

__all__ += ["Database", "QueryPlan", "SearchResult"]

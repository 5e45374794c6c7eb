"""The LM-facing serving names, re-exported from ``serving.scheduler``
(their home, beside the ``ServingEngine`` they can retrieve through), for
imports of ``serving.engine`` as the JAX package has it."""

from repro_torch.serving.scheduler import (Engine, RagResult, Retriever,
                                           ServeStats, rag_answer)

__all__ = ["Engine", "RagResult", "Retriever", "ServeStats", "rag_answer"]

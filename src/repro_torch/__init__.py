"""FaTRQ in PyTorch with hand-written CUDA kernels for Hopper.

A second package beside the JAX one (``repro``), laid out with the same
subpackage names so each module's counterpart is easy to find:

* ``memory`` — Table-I tier model, record layout and the tiered
  layout's hot/warm/cold placement policy (pure Python and numpy).
* ``core`` — base-3 packing, optimal ternary codes, the decomposition
  scalars, calibration, the progressive estimator and the TRQ encoder.
* ``quant`` / ``index`` — k-means, product quantization, the IVF index and
  the kNN graph with its online maintenance.
* ``kernels`` — the CUDA kernels (PQ-ADC scoring, the fused multi-level
  refinement, its bounds-emitting form for the sharded layout and the
  level-0 scoring of gathered rows), each beside its plain PyTorch
  version, plus the nvcc/ctypes loader.
* ``anns`` — stages, executor, pipeline build, the sharded, streaming and
  tiered layouts and the ``Database`` API (static, sharded, streaming and
  tiered layouts, IVF and graph fronts).
* ``obs`` — query-lifecycle tracing, metrics and exporters (pure
  Python).
* ``serving`` — the ``Retriever``, the continuous-batching
  ``ServingEngine`` (fronts on a side CUDA stream, double-buffered
  against the refine) and its result cache; the LM's decode ``Engine``
  and the ``rag_answer`` round trip.
* ``configs`` / ``models`` — the ten architecture configs and the
  transformer LM (dense, MoE and VLM families) behind ``build_model``.
* ``launch`` — ``python -m repro_torch.launch.serve``.
* ``data`` — synthetic clustered embeddings with exact ground truth.
* ``interop`` — loads an index or a transformer's weights made by the
  JAX package from numpy arrays.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no GPU present they raise instead of falling back.
"""

import torch

# The k-means, brute-force and PQ products must stay full float32 (as the
# JAX package computes them on the CPU): TF32 keeps ~3 decimal digits,
# enough to flip nearest-centroid assignments and ground-truth ties.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch import obs, serving  # noqa: E402
from repro_torch.anns import TieredFrontStage, TieredIndex  # noqa: E402
from repro_torch.memory import TieredConfig  # noqa: E402

__all__ = ["obs", "serving", "TieredConfig", "TieredFrontStage",
           "TieredIndex"]

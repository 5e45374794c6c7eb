"""Quantization: k-means, PQ (the coarse quantizer), and the SQ and RQ
baselines.

``kmeans`` here is the module (``kmeans.kmeans`` the trainer): bound to
the function, as the reference's package binds it, the name would hide
the module from ``from repro_torch.quant import kmeans``."""

from repro_torch.quant import kmeans, pq, rq, sq
from repro_torch.quant.kmeans import assign, quantization_error

__all__ = ["pq", "rq", "sq", "kmeans", "assign", "quantization_error"]

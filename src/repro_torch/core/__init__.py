"""FaTRQ core math: packing, ternary codes, decomposition, calibration,
the progressive estimator and the TRQ encoder."""

from repro_torch.core.calibration import CalibrationModel, fit, \
    identity_model, predict
from repro_torch.core.decomposition import (RecordScalars, compute_scalars,
                                            decomposed_distance_sq,
                                            exact_distance_sq, first_order)
from repro_torch.core.estimator import (ProgressiveState, cauchy_margin,
                                        refine_batch, refine_level,
                                        residual_ip_estimate, topk_threshold)
from repro_torch.core.packing import (pack_ternary, packed_size,
                                      storage_bytes, unpack_ternary)
from repro_torch.core.ternary import (TernaryCode, optimal_k, reconstruct,
                                      ternary_decode_direction,
                                      ternary_encode, ternary_inner)
from repro_torch.core.trq import (TRQCodes, TRQLevel, calibrate,
                                  encode_database, estimate_q_dot_delta,
                                  progressive_search, unpack_level)

__all__ = [
    "CalibrationModel", "fit", "identity_model", "predict",
    "RecordScalars", "compute_scalars", "decomposed_distance_sq",
    "exact_distance_sq", "first_order",
    "ProgressiveState", "cauchy_margin", "refine_batch", "refine_level",
    "residual_ip_estimate", "topk_threshold",
    "pack_ternary", "packed_size", "storage_bytes", "unpack_ternary",
    "TernaryCode", "optimal_k", "reconstruct", "ternary_decode_direction",
    "ternary_encode", "ternary_inner",
    "TRQCodes", "TRQLevel", "calibrate", "encode_database",
    "estimate_q_dot_delta", "progressive_search", "unpack_level",
]

"""Offline linear calibration of the refinement estimator (FaTRQ §III-E).

OLS fit of the true squared distance on the features
``A = [d̂₀, d̂_ip, ||δ||², ⟨x_c, δ⟩]`` over (query, record) pairs drawn from
the index itself.  With an exact ⟨q,δ⟩ the identity weights
``[1, 1, 1, 2]`` are exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CalibrationModel:
    w: torch.Tensor          # (4,)
    bias: torch.Tensor       # scalar
    resid_std: torch.Tensor  # scalar: std of the OLS residuals


def build_features(d0: torch.Tensor, d_ip: torch.Tensor,
                   delta_sq: torch.Tensor, cross: torch.Tensor
                   ) -> torch.Tensor:
    """Stack the paper's 4 features on a new trailing axis."""
    return torch.stack([d0, d_ip, delta_sq, cross], dim=-1)


def fit(features: torch.Tensor, target: torch.Tensor, *,
        ridge: float = 1e-6) -> CalibrationModel:
    """OLS with intercept through float32 normal equations (as the JAX
    package solves them), a tiny ridge for conditioning.  features (N, F)."""
    n = features.shape[0]
    a = torch.cat([features, features.new_ones((n, 1))], dim=1)
    gram = a.T @ a + ridge * torch.eye(a.shape[1], dtype=a.dtype,
                                       device=a.device)
    coef = torch.linalg.solve(gram, a.T @ target)
    resid = target - a @ coef
    return CalibrationModel(w=coef[:-1], bias=coef[-1],
                            resid_std=resid.std(correction=0))


def predict(model: CalibrationModel, features: torch.Tensor) -> torch.Tensor:
    """A·Ŵ + b."""
    return features @ model.w + model.bias


def identity_model(device=None) -> CalibrationModel:
    """W* = [1,1,1,2], b=0: exact when d̂_ip is exact."""
    f = dict(dtype=torch.float32, device=device)
    return CalibrationModel(w=torch.tensor([1.0, 1.0, 1.0, 2.0], **f),
                            bias=torch.tensor(0.0, **f),
                            resid_std=torch.tensor(0.0, **f))

"""Elementwise invertible transforms shared by the coupling and masked flows."""
from __future__ import annotations

from typing import Tuple

import torch

from .spline import linear_rational_spline, n_params_per_dim, rational_quadratic_spline


class AffineTransform:
    """z = (x - shift) * exp(-log_scale), with the soft clamp
    ``log_scale = c * tanh(raw / c)`` bounding |log_scale| <= c smoothly.
    ``raw[..., 0]`` is the shift and ``raw[..., 1]`` the raw log-scale."""

    n_params_per_dim = 2

    def __init__(self, clamp: float = 3.0):
        self.clamp = float(clamp)

    def _split(self, raw):
        shift = raw[..., 0]
        log_scale = self.clamp * torch.tanh(raw[..., 1] / self.clamp)
        return shift, log_scale

    def forward(self, x, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        shift, log_scale = self._split(raw)
        return (x - shift) * torch.exp(-log_scale), -log_scale

    def inverse(self, z, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        shift, log_scale = self._split(raw)
        return z * torch.exp(log_scale) + shift, log_scale


class ShiftTransform:
    """Additive-only map (NICE): z = x - shift, log-det 0."""

    n_params_per_dim = 1

    def forward(self, x, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        return x - raw[..., 0], torch.zeros_like(x)

    def inverse(self, z, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        return z + raw[..., 0], torch.zeros_like(z)


class _SplineTransform:
    """Elementwise monotone spline with identity tails outside
    ``[-tail_bound, tail_bound]`` (:mod:`nfmc_torch.flows.spline`)."""

    kind = ""

    def __init__(self, n_bins: int = 8, tail_bound: float = 5.0):
        self.n_bins = int(n_bins)
        self.tail_bound = float(tail_bound)

    @property
    def n_params_per_dim(self) -> int:
        return n_params_per_dim(self.kind, self.n_bins)

    def _apply(self, v, raw, inverse: bool):
        fn = rational_quadratic_spline if self.kind == "rqs" else linear_rational_spline
        return fn(v, raw, inverse, n_bins=self.n_bins, tail_bound=self.tail_bound)

    def forward(self, x, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._apply(x, raw, False)

    def inverse(self, z, raw) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._apply(z, raw, True)


class RQSplineTransform(_SplineTransform):
    """Monotone rational-quadratic spline (Durkan et al. 2019), 3K - 1 raw
    parameters per dim: K widths, K heights, K - 1 interior derivatives."""

    kind = "rqs"


class LRSplineTransform(_SplineTransform):
    """Monotone linear-rational spline (Dolatabadi et al. 2020), 4K - 1 raw
    parameters per dim: the RQS ones and K interior points lambda."""

    kind = "lrs"

"""Synthetic targets: Gaussians, Neal's funnel, Rosenbrock, a Gaussian
mixture and a double well (counterpart of ``nfmc_tpu/potentials/synthetic.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import LOG_2PI, sum_except_batch
from .base import Potential, default_generator


def _randn(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=generator.device)


class StandardGaussian(Potential):
    """U(x) = 0.5 * ||x||^2."""

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * sum_except_batch(x * x, self.event_shape)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        return _randn((*batch_shape, *self.event_shape), default_generator(generator))

    @property
    def mean(self):
        return np.zeros(self.event_shape)

    @property
    def second_moment(self):
        return np.ones(self.event_shape)


class DiagonalGaussian(Potential):
    """U(x) = 0.5 * sum((x - mu)^2 / sigma^2)."""

    _constants = ("mu", "sigma")

    def __init__(self, mu, sigma):
        mu = np.asarray(mu, dtype=np.float32)
        super().__init__(mu.shape)
        self.mu = mu
        self.sigma = np.broadcast_to(np.asarray(sigma, dtype=np.float32), mu.shape).copy()

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        mu, sigma = self._on(x.device)
        z = (x - mu) / sigma
        return 0.5 * sum_except_batch(z * z, self.event_shape)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        generator = default_generator(generator)
        mu, sigma = self._on(generator.device)
        return mu + sigma * _randn((*batch_shape, *self.event_shape), generator)

    @property
    def mean(self):
        return self.mu

    @property
    def second_moment(self):
        return self.mu ** 2 + self.sigma ** 2


class DiagonalGaussian1(DiagonalGaussian):
    """Diagonal Gaussian with sigma = (1, 2, ..., 10) tiled, 100-d by default
    (the reference's moment-estimation target)."""

    def __init__(self, n_dim: int = 100):
        sigma = np.tile(np.arange(1, 11), n_dim // 10 + 1)[:n_dim].astype(np.float32)
        super().__init__(np.zeros(n_dim, dtype=np.float32), sigma)


class FullRankGaussian(Potential):
    """Gaussian with dense covariance, given its Cholesky factor. The
    density is evaluated in whitened coordinates ``y = L^{-1} (x - mu)``
    (a sum of squares, free of cancellation), with ``L^{-1}`` computed once
    on the host in float64 and applied as one matrix product."""

    _constants = ("mu", "chol", "chol_inv_t")

    def __init__(self, mu, chol):
        mu = np.asarray(mu, dtype=np.float32)
        super().__init__(mu.shape)
        self.mu = mu
        # only the lower triangle defines the factor
        chol64 = np.tril(np.asarray(chol, dtype=np.float64))
        self.chol = chol64.astype(np.float32)
        self.chol_inv_t = np.linalg.inv(chol64).T.astype(np.float32)

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        mu, _, chol_inv_t = self._on(x.device)
        y = (x - mu) @ chol_inv_t
        return 0.5 * (y * y).sum(-1)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        generator = default_generator(generator)
        mu, chol, _ = self._on(generator.device)
        return mu + _randn((*batch_shape, self.event_size), generator) @ chol.T

    @property
    def mean(self):
        return self.mu

    @property
    def second_moment(self):
        cov = self.chol @ self.chol.T
        return self.mu ** 2 + np.diag(cov)


class Funnel(Potential):
    """Neal's funnel: x0 ~ N(0, scale^2), x_i | x0 ~ N(0, exp(x0)) for i >= 1."""

    def __init__(self, n_dim: int = 100, scale: float = 3.0):
        super().__init__((n_dim,))
        self.scale = float(scale)

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        v = x[..., 0]
        rest = x[..., 1:]
        d = self.event_shape[0] - 1
        log_p_v = -0.5 * (v / self.scale) ** 2 - 0.5 * LOG_2PI - float(np.log(self.scale))
        log_p_rest = -0.5 * (rest * rest).sum(-1) * torch.exp(-v) - 0.5 * d * (LOG_2PI + v)
        return -(log_p_v + log_p_rest)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        generator = default_generator(generator)
        v = self.scale * _randn((*batch_shape, 1), generator)
        rest = _randn((*batch_shape, self.event_shape[0] - 1), generator) * torch.exp(0.5 * v)
        return torch.cat([v, rest], dim=-1)

    @property
    def mean(self):
        return np.zeros(self.event_shape)

    @property
    def second_moment(self):
        # E[exp(v)] for v ~ N(0, scale^2), and scale^2 for v itself
        sm = np.full(self.event_shape, float(np.exp(self.scale ** 2 / 2.0)))
        sm[0] = self.scale ** 2
        return sm


class Rosenbrock(Potential):
    """Banana-shaped Rosenbrock density in n dims (pairwise coupling)."""

    def __init__(self, n_dim: int = 100, scale: float = 10.0):
        super().__init__((n_dim,))
        self.scale = float(scale)

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x[..., :-1]
        x1 = x[..., 1:]
        return (self.scale * (x1 - x0 ** 2) ** 2 + (1.0 - x0) ** 2).sum(-1)


class GaussianMixture(Potential):
    """Equally weighted Gaussian mixture with a shared isotropic scale."""

    _constants = ("means",)

    def __init__(self, means, sigma: float = 1.0):
        means = np.asarray(means, dtype=np.float32)  # (n_components, d)
        super().__init__(means.shape[1:])
        self.means = means
        self.sigma = float(sigma)

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        (means,) = self._on(x.device)
        diff = x[..., None, :] - means  # (..., K, d)
        log_comp = -0.5 * ((diff / self.sigma) ** 2).sum(-1)
        return -torch.logsumexp(log_comp, dim=-1)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        generator = default_generator(generator)
        (means,) = self._on(generator.device)
        idx = torch.randint(0, means.shape[0], tuple(batch_shape), generator=generator,
                            device=generator.device)
        return means[idx] + self.sigma * _randn((*batch_shape, *self.event_shape), generator)


class DoubleWell(Potential):
    """Product of 1-d double wells: U(x) = sum((x^2 - 1)^2 / 4)."""

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        return sum_except_batch((x * x - 1.0) ** 2 / 4.0, self.event_shape)

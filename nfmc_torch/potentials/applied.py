"""Applied targets: Bayesian logistic regression, a phi^4 lattice, heavy
tails and the Eight Schools posterior (counterpart of
``nfmc_tpu/potentials/applied.py``). Data arrays stay on the host as numpy
and are copied to a device once, on first use there."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import LOG_2PI
from .base import Potential, default_generator


class BayesianLogisticRegression(Potential):
    """Posterior potential of logistic regression with a N(0, prior_scale^2)
    prior on the weights (the intercept is the last coordinate):

    ``U(beta) = sum_i log(1 + exp(-y_i (x_i . w + b))) + ||beta||^2 / (2 s^2)``

    with labels ``y in {-1, +1}`` (labels in {0, 1} are mapped)."""

    _constants = ("X", "y")

    def __init__(self, X, y, prior_scale: float = 1.0):
        X = np.asarray(X, dtype=np.float32)  # (n, d)
        y = np.asarray(y, dtype=np.float32).reshape(-1)  # (n,)
        if set(np.unique(y)) <= {0.0, 1.0}:
            y = 2.0 * y - 1.0
        self.X = X
        self.y = y
        self.prior_scale = float(prior_scale)
        super().__init__((X.shape[1] + 1,))

    def compute(self, beta: torch.Tensor) -> torch.Tensor:
        X, y = self._on(beta.device)
        w = beta[..., :-1]  # (B, d)
        b = beta[..., -1]  # (B,)
        logits = w @ X.T + b[..., None]  # (B, n)
        nll = F.softplus(-y * logits).sum(-1)
        prior = 0.5 * (beta * beta).sum(-1) / (self.prior_scale ** 2)
        return nll + prior

    @classmethod
    def synthetic(cls, n: int = 200, d: int = 24, prior_scale: float = 1.0,
                  seed: int = 0) -> "BayesianLogisticRegression":
        """A sonar-sized synthetic dataset (standardised features, known
        weights); the same numpy data as the JAX package's for a seed."""
        rng = np.random.default_rng(seed)
        X = rng.standard_normal((n, d)).astype(np.float32)
        X = (X - X.mean(0)) / X.std(0)
        w_true = rng.standard_normal(d).astype(np.float32)
        logits = X @ w_true + 0.25
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
        return cls(X, y, prior_scale=prior_scale)


class Phi4Lattice(Potential):
    """2-D scalar phi^4 lattice field theory with periodic boundaries:

    ``U(phi) = sum_x [ -2 kappa phi_x (phi_{x+e1} + phi_{x+e2})
    + (1 - 2 lambda) phi_x^2 + lambda phi_x^4 ]``, an ``(L, L)`` event."""

    def __init__(self, L: int = 8, kappa: float = 0.3, lam: float = 0.022):
        super().__init__((int(L), int(L)))
        self.kappa = float(kappa)
        self.lam = float(lam)

    def compute(self, phi: torch.Tensor) -> torch.Tensor:
        batch = phi.shape[: phi.dim() - 2]
        p = phi.reshape(*batch, *self.event_shape)
        neighbors = torch.roll(p, -1, dims=-1) + torch.roll(p, -1, dims=-2)
        act = (-2.0 * self.kappa * p * neighbors + (1.0 - 2.0 * self.lam) * p * p
               + self.lam * p ** 4)
        return act.reshape(*batch, -1).sum(-1)


def _standard_gamma(shape, alpha: float, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's rejection method
    (alpha < 1 through Gamma(alpha + 1) U^(1 / alpha)), from ``generator``."""
    dev = generator.device
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    n = int(np.prod(shape))
    out = torch.empty(n, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        z = torch.randn(todo.numel(), generator=generator, device=dev)
        u = torch.rand(todo.numel(), generator=generator, device=dev)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp_min(1e-30)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(n, generator=generator, device=dev)
        out = out * u ** (1.0 / alpha)
    return out.reshape(tuple(shape))


class StudentT(Potential):
    """Product of independent Student-t marginals (heavy tails):
    ``U(x) = (nu + 1) / 2 * sum log(1 + x^2 / nu)``."""

    def __init__(self, n_dim: int = 10, df: float = 3.0):
        super().__init__((int(n_dim),))
        self.df = float(df)

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (self.df + 1.0) * torch.log1p(x * x / self.df).sum(-1)

    def sample(self, batch_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        generator = default_generator(generator)
        shape = (*batch_shape, *self.event_shape)
        z = torch.randn(shape, generator=generator, device=generator.device)
        chi2 = 2.0 * _standard_gamma(shape, 0.5 * self.df, generator)
        return z * torch.sqrt(self.df / chi2)

    @property
    def mean(self):
        return np.zeros(self.event_shape)

    @property
    def second_moment(self):
        # the variance of t_nu is nu / (nu - 2) for nu > 2
        if self.df <= 2.0:
            return None
        return np.full(self.event_shape, self.df / (self.df - 2.0))


class EightSchools(Potential):
    """Non-centred Eight Schools posterior, ``x = (mu, log_tau, z_1..z_8)``:
    ``theta_j = mu + exp(log_tau) z_j``;
    ``U = -[sum_j log N(y_j; theta_j, sigma_j) + sum_j log N(z_j; 0, 1)
    + log N(mu; 0, s^2) + log N(log_tau; 0, s^2)]`` with s = prior_scale,
    constants kept. Default data: the classic treatment effects and
    standard errors."""

    Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], dtype=np.float32)
    SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], dtype=np.float32)
    _constants = ("y", "sigma")

    def __init__(self, y=None, sigma=None, prior_scale: float = 10.0):
        self.y = np.asarray(self.Y if y is None else y, dtype=np.float32)
        self.sigma = np.asarray(self.SIGMA if sigma is None else sigma, dtype=np.float32)
        if self.y.shape != self.sigma.shape:
            raise ValueError(f"y {self.y.shape} and sigma {self.sigma.shape} differ in shape")
        self.prior_scale = float(prior_scale)
        super().__init__((2 + self.y.shape[0],))

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        y, sigma = self._on(x.device)
        mu, log_tau, z = x[..., 0], x[..., 1], x[..., 2:]
        theta = mu[..., None] + torch.exp(log_tau)[..., None] * z
        log_lik = -0.5 * (((y - theta) / sigma) ** 2 + 2.0 * torch.log(sigma) + LOG_2PI).sum(-1)
        log_prior_z = -0.5 * (z * z + LOG_2PI).sum(-1)
        s2 = self.prior_scale ** 2
        log_prior_loc = -0.5 * (mu * mu / s2 + log_tau * log_tau / s2
                                + 2.0 * (LOG_2PI + 2.0 * float(np.log(self.prior_scale))))
        return -(log_lik + log_prior_z + log_prior_loc)

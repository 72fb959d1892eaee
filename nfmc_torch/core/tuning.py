"""Step-size dual averaging, the inverse-mass EMA and the train/val split
(counterpart of ``nfmc_tpu/core/tuning.py``).

Dual averaging uses the reference constants: target acceptance 0.651,
kappa 0.75, gamma 0.05, t0 10. Its state is a set of float32 scalars on the
device, updated with tensor operations, so a tuning step needs no host
synchronisation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import as_numpy
from .chains import chain_var


@dataclasses.dataclass(frozen=True)
class DualAveragingParams:
    target_acceptance_rate: float = 0.651
    kappa: float = 0.75
    gamma: float = 0.05
    t0: int = 10


@dataclasses.dataclass
class DualAveragingState:
    """Dual-averaging state: float32 scalars on the device."""

    t: torch.Tensor
    error_sum: torch.Tensor
    log_step_averaged: torch.Tensor
    mu: torch.Tensor

    def to(self, device) -> "DualAveragingState":
        return DualAveragingState(*(v.to(device) for v in dataclasses.astuple(self)))


def da_init(initial_step_size: float, params: DualAveragingParams, device="cpu") -> DualAveragingState:
    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return DualAveragingState(
        t=scalar(float(params.t0)),
        error_sum=scalar(0.0),
        log_step_averaged=scalar(math.log(initial_step_size)),
        mu=scalar(math.log(10.0 * initial_step_size)),
    )


def da_step(state: DualAveragingState, acceptance_rate_error: torch.Tensor,
            params: DualAveragingParams) -> DualAveragingState:
    error_sum = state.error_sum + acceptance_rate_error
    log_step = state.mu - error_sum / (torch.sqrt(state.t) * params.gamma)
    eta = state.t ** (-params.kappa)
    log_step_averaged = eta * log_step + (1.0 - eta) * state.log_step_averaged
    return DualAveragingState(t=state.t + 1.0, error_sum=error_sum,
                              log_step_averaged=log_step_averaged, mu=state.mu)


def da_update_step_size(da: DualAveragingState, acceptance_rate: torch.Tensor,
                        params: DualAveragingParams):
    """One dual-averaging update from an observed acceptance rate; returns
    ``(new_da, new_step_size)``."""
    da = da_step(da, params.target_acceptance_rate - acceptance_rate, params)
    return da, torch.exp(da.log_step_averaged)


def ema_inv_mass_diag(inv_mass_diag: torch.Tensor, x_flat: torch.Tensor,
                      adjustment: float, shard=None) -> torch.Tensor:
    """EMA of the per-dimension chain variance into the inverse mass
    diagonal. ``x_flat``: (chains, event_size). The variance is the
    population variance (``jnp.var``), over the global chains when they are
    sharded (``shard``, :mod:`nfmc_torch.core.chains`)."""
    var = chain_var(x_flat, shard)
    return adjustment * var + (1.0 - adjustment) * inv_mass_diag


def da_value(state: DualAveragingState) -> torch.Tensor:
    return torch.exp(state.log_step_averaged)


def train_val_split(
    x,
    train_pct: float,
    max_train_size: int,
    max_val_size: int,
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten ``(K, C, *event) -> (K*C, *event)``, shuffle, split, cap.
    On the host (numpy), seeded; flow training moves the result back to
    the device."""
    x = as_numpy(x)
    flat = x.reshape(-1, *x.shape[2:]) if x.ndim > 2 else x
    if shuffle:
        rng = np.random.default_rng(seed)
        flat = flat[rng.permutation(len(flat))]
    n_train = int(train_pct * len(flat))
    x_train, x_val = flat[:n_train], flat[n_train:]
    return x_train[:max_train_size], x_val[:max_val_size]

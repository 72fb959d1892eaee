"""Carry flow parameters and kernel state across from the JAX package.

Takes the JAX objects' arrays as numpy (anything ``np.asarray`` reads) and
needs no JAX itself.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(params, device="cpu"):
    """A JAX flow's parameter tree -> the same structure of float32 tensors
    on ``device``: dicts stay dicts (the conditioners' ``{"w", "b"}`` lists
    and the residual flows' dicts of arrays), lists and tuples become lists
    (a ``Chain``'s list of lists), arrays become tensors. The layouts are
    canonical on both sides, so both packages compute the same function."""
    if isinstance(params, dict):
        return {k: from_jax_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v, device) for v in params]
    return torch.as_tensor(np.array(params, dtype=np.float32), device=device)


def from_jax_metropolis_state(state, device="cpu"):
    """A JAX ``MetropolisState`` (``step_size``, ``inv_mass_diag`` and its
    ``DualAveragingState`` ``da``) -> the port's ``MetropolisState``."""
    from ..core.tuning import DualAveragingState
    from ..samplers.mcmc.base import MetropolisState

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    da = state.da
    return MetropolisState(
        step_size=t(state.step_size), inv_mass_diag=t(state.inv_mass_diag),
        da=DualAveragingState(t=t(da.t), error_sum=t(da.error_sum),
                              log_step_averaged=t(da.log_step_averaged), mu=t(da.mu)))

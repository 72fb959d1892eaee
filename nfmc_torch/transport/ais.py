"""Annealed Importance Sampling (Neal 2001), counterpart of
``nfmc_tpu/transport/ais.py``.

The reference imports ``nfmc.mcmc.ais``, which does not exist
(``flow_annealed_bootstrap.py:4``); this is the real component: a linear
schedule with MALA transitions and importance weights
``log_w = sum_k [u_{k-1}(x_k) - u_k(x_k)]`` accumulated on the device.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..core.chains import refuse_sharded
from ..core.rng import resolve_generator
from ..utils import resolve_device
from .common import make_mala_sweep, tempered


class AnnealChain:
    """The AIS annealing loop: ``run(x0, draws) -> (x, log_w)`` over the
    linear schedule ``lam_k = k / n_steps`` (float32, as ``jnp.linspace``)
    with weight increments ``log_w += u(x, lam_prev) - u(x, lam_next)``
    followed by a sweep at the new level. ``draws`` is any iterable of the
    levels' sweep draws, e.g. ``run.draws(generator, x0.shape)``. Shared by
    :func:`make_ais` and FAB's bootstrap round (which anneals toward the
    params-dependent alpha=2 target)."""

    def __init__(self, u: Callable, sweep, n_steps: int):
        self.u, self.sweep, self.n_steps = u, sweep, int(n_steps)
        self.lambdas = [float(v) for v in np.linspace(0.0, 1.0, self.n_steps + 1,
                                                       dtype=np.float32)]

    def draws(self, generator: torch.Generator, shape) -> list:
        """Every level's sweep draws (``MALASweep.draws``' layout), made at
        once: noise ``(n_steps, sweep steps, *shape)`` and uniforms."""
        n, dev = self.sweep.n_steps, generator.device
        noise = torch.randn((self.n_steps, n, *shape), generator=generator, device=dev)
        uniforms = torch.rand((self.n_steps, n, shape[0]), generator=generator, device=dev)
        return list(zip(noise, uniforms))

    def __call__(self, x0: torch.Tensor, draws: Iterable):
        refuse_sharded("AIS", x0)
        x = x0
        log_w = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
        for lam_prev, lam_next, d in zip(self.lambdas[:-1], self.lambdas[1:], draws):
            with torch.no_grad():
                log_w = log_w + self.u(x, lam_prev) - self.u(x, lam_next)
                # out-of-support at BOTH levels gives inf - inf = NaN; the
                # particle's weight is genuinely zero: pin it to -inf so one
                # such particle cannot NaN every logsumexp-based estimate
                log_w = torch.where(torch.isnan(log_w), -math.inf, log_w)
            x = self.sweep(x, lam_next, d)
        return x, log_w


def anneal_chain(u: Callable, sweep, n_steps: int) -> AnnealChain:
    """The AIS annealing loop as one callable (:class:`AnnealChain`)."""
    return AnnealChain(u, sweep, n_steps)


def make_ais(prior_potential: Callable, target_potential: Callable,
             n_steps: int = 10, n_mcmc_steps: int = 3, step_size: float = 0.05) -> AnnealChain:
    """``ais(x0, draws) -> (x, log_w)`` where ``x0 ~ prior`` and ``draws =
    ais.draws(generator, x0.shape)``."""
    u = tempered(prior_potential, target_potential)
    sweep = make_mala_sweep(u, n_steps=n_mcmc_steps, step_size=step_size)
    return anneal_chain(u, sweep, n_steps)


def ais_base(x0, prior_potential, target_potential, n_steps: int = 10,
             n_mcmc_steps: int = 3, step_size: float = 0.05,
             generator: Optional[torch.Generator] = None, seed: Optional[int] = None,
             device=None):
    """Convenience one-shot form (reference-style signature): ``(x, log_w)``
    on ``device`` (CUDA unless the caller names another)."""
    refuse_sharded("AIS", x0)
    device = resolve_device(device)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    g = resolve_generator(device, generator, seed)
    run = make_ais(prior_potential, target_potential, n_steps, n_mcmc_steps, step_size)
    return run(x0, run.draws(g, x0.shape))

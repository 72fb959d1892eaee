"""Langevin Monte Carlo (MALA / ULA).

* step size ``event_size ** (-1/3)`` by default;
* drift ``-tau / m^2 * grad U`` and noise ``sqrt(2 tau) / m * xi`` with
  ``m = inv_mass_diag``;
* MALA adjusts with the proposal potential
  ``||x' - x + tau a grad U||^2_{a^{-1}} / (4 tau)``, ``a = 1/m^2``;
* the potential and gradient at the current state ride in the carried
  state and update through the accept mask, so a step evaluates the target
  once, at the proposal. The counters keep the reference's contract: 2B
  calls and 2B gradients per iteration when adjusted, B each otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...core.driver import StepInfo
from ...utils import (
    event_size_of,
    flatten_event,
    metropolis_acceptance_log_ratio,
    value_and_batched_grad,
)
from .base import MetropolisKernel, MetropolisParameters, MetropolisSampler


@dataclass
class LangevinKernel(MetropolisKernel):
    step_size: Optional[float] = None

    def __post_init__(self):
        if self.step_size is None:
            self.step_size = self.event_size ** (-1.0 / 3.0)
        super().__post_init__()


@dataclass
class LangevinParameters(MetropolisParameters):
    pass


def proposal_potential(x_prime_flat, x_flat, grad_u_x_flat, a_diag, tau):
    """Langevin proposal potential q(x'|x)."""
    term = x_prime_flat - x_flat + tau * a_diag[None] * grad_u_x_flat
    return (term * (1.0 / a_diag[None]) * term).sum(-1) / (4.0 * tau)


class Langevin(MetropolisSampler):
    def __init__(self, event_shape, target, kernel: Optional[LangevinKernel] = None,
                 params: Optional[LangevinParameters] = None, device=None):
        if kernel is None:
            kernel = LangevinKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = LangevinParameters()
        super().__init__(event_shape, target, kernel, params, device=device)

    @property
    def name(self):
        return "LMC"

    def _augment_state(self, mstate, x0):
        u0, g0 = value_and_batched_grad(self.target)(x0)
        return (mstate, u0, g0)

    def _drift_noise(self, mstate, g_flat, noise_flat):
        tau = mstate.step_size
        inv_mass = mstate.inv_mass_diag
        return -tau / (inv_mass[None] ** 2) * g_flat + torch.sqrt(2.0 * tau) / inv_mass[None] * noise_flat

    def _proposal_potential(self, mstate, x_prime_flat, x_flat, grad_u_x_flat):
        a_diag = 1.0 / mstate.inv_mass_diag**2
        return proposal_potential(x_prime_flat, x_flat, grad_u_x_flat, a_diag, mstate.step_size)

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (noise, log_u)`` shaped
        ``(*prefix, n_chains, *event)`` and ``(*prefix, n_chains)``."""
        event_shape = self.event_shape
        adjustment = self.params.adjustment

        def draws(generator, prefix, n_chains):
            dev = generator.device
            noise = torch.randn((*prefix, n_chains, *event_shape), generator=generator, device=dev)
            if adjustment:
                log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator, device=dev))
            else:
                log_u = torch.zeros((*prefix, n_chains), device=dev)
            return noise, log_u

        return draws

    def _make_step_aux(self, tuning: bool):
        target = self.target
        event_shape = self.event_shape
        event_ndim = len(event_shape)
        adjustment = self.params.adjustment
        u_and_grad = value_and_batched_grad(target)
        drift_noise = self._drift_noise
        prop_potential = self._proposal_potential
        update_kernel = self.make_update_kernel()

        def step(x, state, draws):
            mstate, u_x, g_x = state
            noise, log_u = draws
            g_flat = flatten_event(g_x, event_shape)
            x_flat = flatten_event(x, event_shape)
            xp_flat = x_flat + drift_noise(mstate, g_flat, flatten_event(noise, event_shape))
            x_prime = xp_flat.reshape(x.shape)
            finite_prop = torch.isfinite(xp_flat).all(-1)

            u_xp, g_xp = u_and_grad(x_prime)
            if adjustment:
                gp_flat = flatten_event(g_xp, event_shape)
                log_ratio = metropolis_acceptance_log_ratio(
                    log_prob_target_curr=-u_x,
                    log_prob_target_prime=-u_xp,
                    log_prob_proposal_curr=-prop_potential(mstate, x_flat, xp_flat, gp_flat),
                    log_prob_proposal_prime=-prop_potential(mstate, xp_flat, x_flat, g_flat),
                )
                mask = (log_u < log_ratio) & finite_prop & torch.isfinite(u_xp)
            else:
                mask = finite_prop & torch.isfinite(u_xp)
            # divergence: a non-finite proposal or potential at the proposal
            diverged = (~(finite_prop & torch.isfinite(u_xp)).all()).to(torch.int32)

            bmask = mask.reshape(mask.shape + (1,) * event_ndim)
            x_new = torch.where(bmask, x_prime, x)
            u_new = torch.where(mask, u_xp, u_x)
            g_new = torch.where(bmask, g_xp, g_x)
            if tuning:
                mstate = update_kernel(mstate, x_new, mask)
            info = StepInfo(n_accepted=mask.sum().to(torch.int32), diverged=diverged)
            return x_new, (mstate, u_new, g_new), info

        return step

    def calls_per_iter(self, n_chains: int) -> int:
        return 2 * n_chains if self.params.adjustment else n_chains

    def grads_per_iter(self, n_chains: int) -> int:
        return 2 * n_chains if self.params.adjustment else n_chains


class MALA(Langevin):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.params.adjustment = True

    @property
    def name(self):
        return "MALA"


class ULA(Langevin):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.params.adjustment = False

    @property
    def name(self):
        return "ULA"

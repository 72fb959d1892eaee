"""Random-walk Metropolis-Hastings (counterpart of
``nfmc_tpu/samplers/mcmc/mh.py``).

* proposal ``x' = x + randn * inv_mass_diag``: the scale is
  ``inv_mass_diag`` itself, the step size is unused;
* ``MH`` accepts by the Metropolis ratio, ``RandomWalk`` accepts every
  finite proposal;
* ``MHParameters`` pins ``tune_step_size=False``, ``tune_inv_mass_diag=True``
  and ``imd_adjustment=1e-5``;
* when adjusted, U(x) rides in the carried state and updates through the
  accept mask, so a step evaluates the target once, at the proposal, while
  the counters keep the reference's 2B target calls an iteration (0 when
  unadjusted) and 0 gradient calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...core.driver import StepInfo
from ...utils import event_size_of, metropolis_acceptance_log_ratio
from .base import MetropolisKernel, MetropolisParameters, MetropolisSampler


@dataclass
class MHKernel(MetropolisKernel):
    pass


@dataclass
class MHParameters(MetropolisParameters):
    imd_adjustment: float = 1e-5

    def __post_init__(self):
        super().__post_init__()
        self.tune_step_size = False
        self.tune_inv_mass_diag = True


class MH(MetropolisSampler):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[MHKernel] = None,
                 params: Optional[MHParameters] = None, device=None):
        if kernel is None:
            kernel = MHKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = MHParameters()
        super().__init__(event_shape, target, kernel, params, device=device)

    @property
    def name(self):
        return "MH"

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (noise, log_u)`` shaped
        ``(*prefix, n_chains, event_size)`` and ``(*prefix, n_chains)``; the
        ``inv_mass_diag`` scale depends on the state and is applied in the
        step."""
        event_size = self.kernel.event_size
        adjustment = self.params.adjustment

        def draws(generator, prefix, n_chains):
            dev = generator.device
            noise = torch.randn((*prefix, n_chains, event_size), generator=generator, device=dev)
            if adjustment:
                log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator, device=dev))
            else:
                log_u = torch.zeros((*prefix, n_chains), device=dev)
            return noise, log_u

        return draws

    def make_propose_aux(self):
        """The unadjusted proposal: every finite proposal is taken."""
        def propose(x, mstate, draws):
            noise, _log_u = draws
            x_prime = x + (noise * mstate.inv_mass_diag).reshape(x.shape)
            finite = torch.isfinite(x_prime.reshape(x.shape[0], -1)).all(-1)
            return x_prime, finite, (~finite.all()).to(torch.int32)

        return propose

    def _augment_state(self, mstate, x0):
        if not self.params.adjustment:
            return mstate
        with torch.no_grad():
            return (mstate, self.target(x0))

    def _make_step_aux(self, tuning: bool):
        if not self.params.adjustment:
            return super()._make_step_aux(tuning)
        target = self.target
        event_ndim = len(self.event_shape)
        update_kernel = self.make_update_kernel()

        def step(x, state, draws):
            mstate, u_x = state
            noise, log_u = draws
            x_prime = x + (noise * mstate.inv_mass_diag).reshape(x.shape)
            u_prime = target(x_prime)
            log_ratio = metropolis_acceptance_log_ratio(-u_x, -u_prime, 0.0, 0.0)
            # a non-finite U(x') is a rejected divergence, never an accept
            # through log_ratio = +inf
            finite = torch.isfinite(x_prime.reshape(x.shape[0], -1)).all(-1) & torch.isfinite(u_prime)
            mask = (log_u < log_ratio) & finite
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), x_prime, x)
            u_new = torch.where(mask, u_prime, u_x)
            if tuning:
                mstate = update_kernel(mstate, x_new, mask)
            info = StepInfo(n_accepted=mask.sum().to(torch.int32),
                            diverged=(~finite.all()).to(torch.int32))
            return x_new, (mstate, u_new), info

        return step

    def calls_per_iter(self, n_chains: int) -> int:
        return 2 * n_chains if self.params.adjustment else 0

    def grads_per_iter(self, n_chains: int) -> int:
        return 0


class RandomWalk(MH):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.params.adjustment = False

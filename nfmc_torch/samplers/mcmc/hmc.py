"""Hamiltonian Monte Carlo, adjusted (``HMC``) and unadjusted (``UHMC``)
(counterpart of ``nfmc_tpu/samplers/mcmc/hmc.py``).

* ``n_leapfrog_steps = 20``; leapfrog with the diagonal inverse mass as
  preconditioner; momenta ``randn / sqrt(inv_mass_diag)``;
* Metropolis accept on the Hamiltonian ``U + 0.5 p^T M^{-1} p``; a
  trajectory whose end or whose Hamiltonian there is not finite is
  rejected and counted as a divergence;
* ``HMCParameters.step_jitter`` scales each chain's step by ``1 + U(-j,
  j)`` per iteration (0, the default, is the reference's fixed step).

The reference computes the gradient twice a leapfrog step; the trailing
half-kick of one step and the leading half-kick of the next use the same
position, so here each position's gradient is computed once: L + 1 gradient
passes a trajectory, each one autograd pass that also yields U there, so the
Hamiltonian at the start and the end costs no extra target call. The
counters keep the reference's contract: 2 L B gradient calls an iteration
and 2 L B target calls, plus 2 B when adjusted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...utils import event_size_of, flatten_event, sum_except_batch, value_and_batched_grad
from .base import MetropolisKernel, MetropolisParameters, MetropolisSampler


# HMC's jitter fraction: the drawn step scales apply as they are
HMC_JITTER = 1.0


@dataclass
class HMCKernel(MetropolisKernel):
    n_leapfrog_steps: int = 20

    def __repr__(self):
        return (f"log step: {math.log(self.step_size):.2f}, "
                f"leapfrogs: {self.n_leapfrog_steps}, "
                f"mass norm: {float(np.max(np.abs(self.inv_mass_diag))):.2f}")


@dataclass
class HMCParameters(MetropolisParameters):
    # per-chain step jitter fraction: each iteration scales the step by
    # (1 + U(-j, j)); 0 keeps the reference's fixed step
    step_jitter: float = 0.0


class HMC(MetropolisSampler):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[HMCKernel] = None,
                 params: Optional[HMCParameters] = None, device=None):
        if kernel is None:
            kernel = HMCKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = HMCParameters()
        super().__init__(event_shape, target, kernel, params, device=device)

    @property
    def name(self):
        return "HMC"

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (p_raw, log_u, eps_scale)``:
        momentum normals ``(*prefix, C, event_size)`` (the mass scale is
        applied in the step), accept log-uniforms and step scales ``(*prefix,
        C)``."""
        event_size = self.kernel.event_size
        adjustment = self.params.adjustment
        jitter = float(self.params.step_jitter)

        def draws(generator, prefix, n_chains):
            dev = generator.device
            p_raw = torch.randn((*prefix, n_chains, event_size), generator=generator, device=dev)
            if adjustment:
                log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator, device=dev))
            else:
                log_u = torch.zeros((*prefix, n_chains), device=dev)
            if jitter > 0.0:
                u = torch.rand((*prefix, n_chains), generator=generator, device=dev)
                eps_scale = 1.0 + jitter * (2.0 * u - 1.0)
            else:
                eps_scale = torch.ones((*prefix, n_chains), device=dev)
            return p_raw, log_u, eps_scale

        return draws

    # ---- metric hooks (the dense-metric samplers override them) -------------
    def _jitter_frac(self, mstate):
        """Multiplier on the step jitter: 1 here; DenseHMC gates it by its
        adapted metric's state."""
        return HMC_JITTER

    def _momentum(self, mstate, p_raw):
        """Raw normals ``(B, event_size)`` -> momenta ``p ~ N(0, M)``, flat."""
        return p_raw / torch.sqrt(mstate.inv_mass_diag)[None]

    def _precondition(self, mstate, v):
        """``M^{-1} v`` for an event-shaped batch (the leapfrog drift map)."""
        return (flatten_event(v, self.event_shape) * mstate.inv_mass_diag[None]).reshape(v.shape)

    def _kinetic(self, mstate, p):
        """``0.5 p^T M^{-1} p`` per chain."""
        return 0.5 * sum_except_batch(self._precondition(mstate, p) * p, self.event_shape)

    def make_propose_aux(self):
        return self._build_propose_aux(self._momentum, self._precondition, self._kinetic,
                                       self._jitter_frac)

    def _build_propose_aux(self, momentum, precondition, kinetic, jitter_frac):
        """The proposal with the metric hooks given (DenseHMC builds its
        dense or its scalar form)."""
        event_shape = self.event_shape
        adjustment = self.params.adjustment
        n_leapfrog = self.kernel.n_leapfrog_steps
        u_and_grad = value_and_batched_grad(self.target)

        def propose(x, mstate, draws):
            n_chains = x.shape[0]
            p_raw, log_u, eps_scale = draws
            jf = jitter_frac(mstate)
            # 1 + (s - 1) * 1 is s itself: HMC keeps its scales as drawn
            scale = eps_scale if jf is HMC_JITTER else 1.0 + (eps_scale - 1.0) * jf
            eps = mstate.step_size * scale.reshape((n_chains,) + (1,) * len(event_shape))
            p0 = momentum(mstate, p_raw).reshape(x.shape)
            # one gradient a position: L + 1 passes; the first and the last
            # also give U at the trajectory's ends
            u_x, g = u_and_grad(x)
            xq, pq, u_end = x, p0, u_x
            for _ in range(n_leapfrog):
                pq = pq - 0.5 * eps * g
                xq = xq + eps * precondition(mstate, pq)
                u_end, g = u_and_grad(xq)
                pq = pq - 0.5 * eps * g
            finite = torch.isfinite(flatten_event(xq, event_shape)).all(-1)
            if adjustment:
                h_start = u_x + kinetic(mstate, p0)
                h_end = u_end + kinetic(mstate, pq)
                # a divergence: a non-finite end or Hamiltonian there
                finite = finite & torch.isfinite(h_end)
                mask = (log_u < h_start - h_end) & finite
            else:
                mask = finite
            return xq, mask, (~finite.all()).to(torch.int32)

        return propose

    def calls_per_iter(self, n_chains: int) -> int:
        n = 2 * self.kernel.n_leapfrog_steps * n_chains
        if self.params.adjustment:
            n += 2 * n_chains
        return n

    def grads_per_iter(self, n_chains: int) -> int:
        return 2 * self.kernel.n_leapfrog_steps * n_chains


class UHMC(HMC):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.params.adjustment = False

    @property
    def name(self):
        return "UHMC"

"""Affine-invariant ensemble sampler (AIES, the Goodman & Weare stretch
move) with the parallel two-half scheme (counterpart of
``nfmc_tpu/samplers/mcmc/ensemble.py``).

Each walker proposes along the line through a partner from the other half,
``y = x_j + z (x - x_j)`` with ``z ~ g(z) ∝ 1/sqrt(z)`` on ``[1/a, a]``
(inverse CDF ``z = ((a - 1) u + 1)^2 / a``), and accepts with probability
``min(1, z^(d-1) pi(y) / pi(x))``. Half 0 moves against half 1, then half 1
against the updated half 0: two batched target evaluations an iteration.
The draws (z-uniforms, partner indices, accept log-uniforms) do not depend
on the state and come from the run's generator like every other kernel's.
``U(x)`` rides in the carried state; the counters keep the eager contract,
2 C target calls and no gradients an iteration.

The warmup dual-averages ``log(a - 1)`` toward an acceptance of 0.3.

The JAX package runs a chunk as one ``lax.scan`` of this step. On CUDA with
one rank a chunk here is replays of one captured CUDA graph of it
(:mod:`nfmc_torch.core.graphs`): the half moves, the partner gathers and
the dual-averaging update of ``a`` have static shapes, and ``(state, U)``
is carried as tensors; ``a`` reaches the host once, after the run. Over
several ranks every step gathers the halves (``collective_step``), and the
run is the eager loop.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core.chains import chain_mean
from ...core.driver import StepInfo
from ...core.sampler import MCMCKernel, MCMCParameters
from ...core.tuning import DualAveragingParams, DualAveragingState, da_step
from .base import MCMCSampler


@dataclasses.dataclass
class AIESState:
    """The stretch scale and its tuner, on the device."""

    a: torch.Tensor  # f32 scalar, > 1
    da: DualAveragingState  # dual averaging over log(a - 1)


@dataclass
class AIESKernel(MCMCKernel):
    """Tunable state: the stretch scale ``a`` (Goodman & Weare's 2)."""

    event_size: int = 0
    a: float = 2.0
    da_params: Optional[DualAveragingParams] = None

    def __post_init__(self):
        super().__post_init__()
        if not self.a > 1.0:
            raise ValueError(f"stretch scale a must be > 1, got {self.a}")
        if self.da_params is None:
            # the stretch move's healthy acceptance is 0.2-0.5
            self.da_params = DualAveragingParams(target_acceptance_rate=0.3)

    def make_state(self, device) -> AIESState:
        log_am1 = float(np.log(self.a - 1.0))

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return AIESState(
            a=scalar(self.a),
            da=DualAveragingState(t=scalar(float(self.da_params.t0)), error_sum=scalar(0.0),
                                  log_step_averaged=scalar(log_am1),
                                  mu=scalar(log_am1 + math.log(10.0))),
        )

    def sync_from_state(self, state: AIESState) -> None:
        self.a = float(state.a)

    def __repr__(self):
        return f"a: {self.a:.2f}"


@dataclass
class AIESParameters(MCMCParameters):
    tune_stretch: bool = True


class AIES(MCMCSampler):
    """Needs ``n_chains >= 4`` (two halves of at least two walkers) and mixes
    best with ``n_chains >= 2 * event_size``: with fewer walkers the
    proposals stay in the ensemble's affine hull.

    Sharded over several ranks, each rank moves its walkers and the halves
    meet through two all_gathers an iteration (the partner pool, then the
    updated half 0); the draws stay whole, indexed by global walker. A
    rank's block may lie across both halves (an odd number of ranks): its
    rows of half 0 move first, against all of half 1, then its rows of
    half 1 against the updated half 0."""

    multi_rank_chains = True
    draw_chain_axes = (None, None, None, None)
    # on one rank, chunks replay a CUDA graph of the step
    graph_capturable = True
    collective_step = True  # the halves, gathered over the ranks every step

    def __init__(self, event_shape, target, kernel: Optional[AIESKernel] = None,
                 params: Optional[AIESParameters] = None, device=None):
        if kernel is None:
            kernel = AIESKernel(event_size=int(np.prod(event_shape)))
        if params is None:
            params = AIESParameters()
        super().__init__(event_shape, target, kernel, params, device=device)

    @property
    def name(self):
        return "AIES"

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (z_u, idx0, idx1, log_u)``:
        z-uniforms and accept log-uniforms ``(*prefix, C)``, the partners in
        half 1 of half 0's walkers ``(*prefix, C // 2)`` and in half 0 of
        half 1's ``(*prefix, C - C // 2)``."""

        def draws(generator, prefix, n_chains):
            dev = generator.device
            c0 = n_chains // 2
            c1 = n_chains - c0
            z_u = torch.rand((*prefix, n_chains), generator=generator, device=dev)
            idx0 = torch.randint(0, c1, (*prefix, c0), generator=generator, device=dev)
            idx1 = torch.randint(0, c0, (*prefix, c1), generator=generator, device=dev)
            log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator, device=dev))
            return z_u, idx0, idx1, log_u

        return draws

    def _augment_state(self, astate, x0):
        n_chains = self._n_global(x0.shape[0])
        if n_chains < 4:
            raise ValueError(
                f"AIES needs n_chains >= 4 (two non-degenerate ensemble "
                f"halves); got {n_chains}"
            )
        return (astate, self.target(x0))

    def _make_step_aux(self, tuning: bool):
        target = self.target
        event_ndim = len(self.event_shape)
        d = self.event_size
        tune = tuning and self.params.tune_stretch
        da_params = self.kernel.da_params
        shard = self.chain_shard

        def half_move(xs_move, u_move, partners, z_u, log_u, a):
            """Stretch-move one half against a frozen partner pool."""
            z = ((a - 1.0) * z_u + 1.0) ** 2 / a
            y = partners + z.reshape(z.shape + (1,) * event_ndim) * (xs_move - partners)
            finite = torch.isfinite(y.reshape(y.shape[0], -1)).all(-1)
            u_y = target(y)
            # log alpha = (d - 1) log z + log pi(y) - log pi(x), log pi = -U
            log_ratio = (d - 1.0) * torch.log(z) + (u_move - u_y)
            ok = finite & torch.isfinite(u_y)
            mask = (log_u < log_ratio) & ok
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), y, xs_move)
            return x_new, torch.where(mask, u_y, u_move), mask, ~ok.all()

        def local_move(xs, us, partners, z_u, log_u, a):
            """``half_move`` on this rank's walkers of a half, none if it
            holds none (the target is not called on an empty batch)."""
            if xs.shape[0] == 0:
                return xs, us, torch.zeros(0, dtype=torch.bool, device=xs.device), \
                    torch.zeros((), dtype=torch.bool, device=xs.device)
            return half_move(xs, us, partners, z_u, log_u, a)

        def step_split(x, u, draws, a):
            """This rank's walkers, rows ``[lo, hi)`` of the ensemble: those
            of half 0 move against all of half 1, then those of half 1
            against all of the updated half 0."""
            z_u, idx0, idx1, log_u = draws
            c0, n_local = idx0.shape[0], x.shape[0]
            lo = shard.rank * n_local
            k = min(max(c0 - lo, 0), n_local)  # this rank's walkers in half 0
            g0, g1 = slice(lo, lo + k), slice(lo + k, lo + n_local)
            pool = shard.gather(x, 0)[c0:]
            x0h, u0h, m0, d0 = local_move(x[:k], u[:k], pool[idx0[g0]], z_u[g0], log_u[g0], a)
            x = torch.cat([x0h, x[k:]])
            pool = shard.gather(x, 0)[:c0]
            x1h, u1h, m1, d1 = local_move(x[k:], u[k:], pool[idx1[lo + k - c0:lo + n_local - c0]],
                                          z_u[g1], log_u[g1], a)
            return x0h, x1h, u0h, u1h, m0, m1, d0, d1

        def step(x, state, draws):
            astate, u = state
            z_u, idx0, idx1, log_u = draws
            c0 = idx0.shape[0]
            a = astate.a
            if shard is not None and shard.size > 1:
                x0h, x1h, u0h, u1h, m0, m1, d0, d1 = step_split(x, u, draws, a)
            else:
                x0h, x1h = x[:c0], x[c0:]
                u0h, u1h = u[:c0], u[c0:]
                # half 0 against half 1, then half 1 against the UPDATED half
                # 0: the sequential dependency keeps detailed balance
                x0h, u0h, m0, d0 = half_move(x0h, u0h, x1h[idx0], z_u[:c0], log_u[:c0], a)
                x1h, u1h, m1, d1 = half_move(x1h, u1h, x0h[idx1], z_u[c0:], log_u[c0:], a)
            mask = torch.cat([m0, m1])
            if tune:
                da = da_step(astate.da,
                             da_params.target_acceptance_rate
                             - chain_mean(mask.to(torch.float32), shard),
                             da_params)
                astate = AIESState(a=1.0 + torch.exp(da.log_step_averaged), da=da)
            info = StepInfo(n_accepted=mask.sum().to(torch.int32),
                            diverged=(d0 | d1).to(torch.int32))
            return torch.cat([x0h, x1h]), (astate, torch.cat([u0h, u1h])), info

        return step

    def calls_per_iter(self, n_chains: int) -> int:
        return 2 * n_chains

    def grads_per_iter(self, n_chains: int) -> int:
        return 0

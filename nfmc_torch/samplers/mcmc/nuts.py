"""The No-U-Turn Sampler, multi-chain (counterpart of
``nfmc_tpu/samplers/mcmc/nuts.py``; the tree builder is in
``nuts_impl.py``).

* the proposal is always the new state; dual averaging adapts the step
  size on the trajectory-average acceptance statistic
  ``mean_leaves min(1, exp(-delta E))``;
* ``n_accepted`` counts the chains that moved;
* the counters go through the dynamic channel: ``sum n_leapfrog + C``
  target calls and gradient calls an iteration (the leapfrogs and each
  chain's evaluation at its start); ``calls_per_iter`` and
  ``grads_per_iter`` are 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ...core.driver import StepInfo
from ...utils import event_size_of
from .base import MetropolisKernel, MetropolisParameters, MetropolisSampler
from .nuts_impl import make_nuts_step, nuts_step_draws


@dataclass
class NUTSKernel(MetropolisKernel):
    max_tree_depth: int = 10
    step_size: float = 0.1

    def __repr__(self):
        return f"log step: {math.log(self.step_size):.2f}, max depth: {self.max_tree_depth}"


@dataclass
class NUTSParameters(MetropolisParameters):
    max_delta_energy: float = 1000.0


class NUTS(MetropolisSampler):
    """Multi-chain NUTS. ``tree_depths()`` gives the mean and the maximum
    tree depth over the chains and the steps this sampler took (summed on
    the device by the steps themselves, read once; with chains sharded
    over several ranks, summed and maximised over them at the end of each
    run, so every rank reports the global figures).

    Sharded, each rank builds its own chains' trees: its scopes' predicates
    (a chain still running) are the rank's, and a rank that stops early
    leaves its finished chains as the masked updates of the unsharded run
    would."""

    multi_rank_chains = True
    # the trajectory's loops are scopes on device predicates
    # (``graphs.when``, ``graphs.loop``): chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[NUTSKernel] = None,
                 params: Optional[NUTSParameters] = None, device=None):
        if kernel is None:
            kernel = NUTSKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = NUTSParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        # (sum and max of the tree depths, trajectories counted) over every
        # run so far, on the device; the running one's on this rank, an
        # int64 (3,) tensor the steps add to in place (a replay writes it
        # where the capture found it)
        self._depths = None
        self._run_depths = torch.zeros(3, dtype=torch.int64, device=self.device)

    @property
    def name(self):
        return "NUTS"

    def make_draws(self):
        event_size = self.kernel.event_size
        max_depth = self.kernel.max_tree_depth

        def draws(generator, prefix, n_chains):
            return nuts_step_draws(generator, prefix, n_chains, event_size, max_depth)

        return draws

    def hoisted_elements_per_iter(self, x) -> int:
        # momenta, two uniforms a doubling and one a leaf, per (global) chain
        n_chains = self._n_global(int(x.shape[0]))
        max_depth = self.kernel.max_tree_depth
        return n_chains * (self.kernel.event_size + 2 * max_depth + (1 << max_depth) - 1)

    def _make_step_aux(self, tuning: bool):
        nuts_step = make_nuts_step(self.target, self.event_shape,
                                   max_tree_depth=self.kernel.max_tree_depth,
                                   max_delta_energy=self.params.max_delta_energy)
        update_kernel = self.make_update_kernel()
        run = self._run_depths

        def step(x, mstate, draws):
            x_new, moved, diverged, accept_stat, n_leapfrog, depth = nuts_step(
                x, mstate.step_size, mstate.inv_mass_diag, draws)
            if tuning:
                mstate = update_kernel(mstate, x_new, accept_stat)
            run[0].add_(depth.sum())
            torch.maximum(run[1], depth.max().to(torch.int64), out=run[1])
            run[2].add_(x.shape[0])
            total = n_leapfrog.sum() + x.shape[0]
            info = StepInfo(n_accepted=moved.sum().to(torch.int32),
                            diverged=diverged.any().to(torch.int32),
                            n_calls=total, n_grads=total)
            return x_new, mstate, info

        return step

    def _finish_run(self) -> None:
        """Fold the run's depths into the total, summed (the depths and the
        trajectories) and maximised over the ranks of the chain shard, and
        set the run's to 0 in place."""
        run = self._run_depths.clone()
        self._run_depths.zero_()
        shard = self.chain_shard
        if shard is not None and shard.size > 1:
            run = torch.stack([shard.sum(run[0]), shard.max(run[1]), shard.sum(run[2])])
        self._depths = _fold_depths(self._depths, run)

    def tree_depths(self):
        """``(mean, max)`` tree depth over the chains and steps taken, or
        None before any step."""
        if self.chain_shard is None:
            self._finish_run()  # steps taken outside a run (unsharded)
        if self._depths is None:
            return None
        d_sum, d_max, n = self._depths.tolist()
        if n == 0:
            return None
        return d_sum / n, int(d_max)

    def calls_per_iter(self, n_chains: int) -> int:
        return 0  # dynamic: reported per trajectory through StepInfo.n_calls

    def grads_per_iter(self, n_chains: int) -> int:
        return 0


def _fold_depths(total, part):
    """``(depth sum, depth max, trajectories)`` of ``total`` and ``part``
    together, an int64 (3,) tensor (``total`` None: ``part``)."""
    if total is None:
        return part
    return torch.stack([total[0] + part[0], torch.maximum(total[1], part[1]), total[2] + part[2]])

"""Metropolis-family kernel state, Metropolis adaptation, the standalone
MCMC runner and the base of the Metropolis samplers (Langevin, HMC, MH,
NUTS); counterpart of ``nfmc_tpu/samplers/mcmc/base.py``.

* ``warmup`` runs ``n_warmup_iterations`` in tuning mode and keeps the tuned
  kernel; ``sample`` runs ``n_iterations`` (tuning if ``params.tuning``);
* Metropolis adaptation: an EMA of the per-dimension chain variance into
  ``inv_mass_diag`` and dual averaging of the step size, as tensor updates
  on the device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ...core.chains import chain_mean
from ...core import graphs
from ...core.driver import ChunkedScanDriver, StepInfo
from ...core.output import MCMCOutput
from ...utils import tree_leaves
from ...core.sampler import MCMCKernel, MCMCParameters, Sampler
from ...core.tuning import (
    DualAveragingParams,
    DualAveragingState,
    da_init,
    da_update_step_size,
    ema_inv_mass_diag,
)


@dataclasses.dataclass
class MetropolisState:
    """Numeric kernel state a run carries on the device."""

    step_size: torch.Tensor  # f32 scalar
    inv_mass_diag: torch.Tensor  # (event_size,)
    da: DualAveragingState


@dataclass
class MetropolisKernel(MCMCKernel):
    """User-facing tunable state."""

    event_size: int = 0
    inv_mass_diag: Optional[np.ndarray] = None
    step_size: float = 0.01
    da_params: Optional[DualAveragingParams] = None

    def __post_init__(self):
        super().__post_init__()
        if self.inv_mass_diag is None:
            self.inv_mass_diag = np.ones(self.event_size, dtype=np.float32)
        else:
            self.inv_mass_diag = np.asarray(self.inv_mass_diag, dtype=np.float32)
            if self.inv_mass_diag.shape != (self.event_size,):
                raise ValueError(
                    f"inv_mass_diag shape {self.inv_mass_diag.shape} != ({self.event_size},)"
                )
        if self.da_params is None:
            self.da_params = DualAveragingParams()

    def make_state(self, device) -> MetropolisState:
        da = getattr(self, "_resume_da", None)
        return MetropolisState(
            step_size=torch.tensor(self.step_size, dtype=torch.float32, device=device),
            inv_mass_diag=torch.as_tensor(self.inv_mass_diag, dtype=torch.float32, device=device),
            da=da.to(device) if da is not None else da_init(self.step_size, self.da_params, device),
        )

    def sync_from_state(self, state: MetropolisState) -> None:
        host = torch.cat([state.step_size.reshape(1), state.inv_mass_diag.reshape(-1)]).cpu().numpy()
        self.step_size = float(host[0])
        self.inv_mass_diag = host[1:]
        # carry the dual-averaging state across runs, so a later warmup
        # continues the adaptation instead of restarting it
        self._resume_da = state.da

    def __repr__(self):
        return (f"log step: {math.log(self.step_size):.2f}, "
                f"mass norm: {float(np.max(np.abs(self.inv_mass_diag))):.2f}")


@dataclass
class MetropolisParameters(MCMCParameters):
    tune_inv_mass_diag: bool = True
    tune_step_size: bool = True
    adjustment: bool = True
    imd_adjustment: float = 1e-3


class MCMCSampler(Sampler):
    """Standalone runs (``warmup``/``sample``) and the hooks a composite
    runner (the jump sampler) drives. ``data_transform`` maps the chain
    state to what the moment accumulators see (NeuTra's latent -> data map);
    stored draws stay untransformed."""

    data_transform: Optional[Callable] = None
    # the chain axis of each ``make_draws`` tensor after its leading dims,
    # where it is not the first (``ChunkedScanDriver``'s ``draw_chain_axes``)
    draw_chain_axes: Optional[tuple] = None
    # the flows the step calls by closure (NeuTra's, through its target and
    # moment transform): their bijections must be capturable too
    graph_flows: tuple = ()
    collective_step: bool = False
    """Whether the step, its chains sharded over several ranks, calls a
    collective every iteration, sampling included (PT's swap counts, AIES's
    partner halves). Such a run on several ranks runs the eager loop,
    decided before the run (:func:`nfmc_torch.core.graphs.captures`); on one
    rank a declared class replays graphs."""

    @property
    def name(self) -> str:
        return "Generic MCMC"

    def make_draws(self) -> Optional[Callable]:
        """``(generator, shape_prefix, n_chains) -> draws``: a batch of
        per-iteration randomness with leading dims ``shape_prefix``."""
        return None

    def calls_per_iter(self, n_chains: int) -> int:
        raise NotImplementedError

    def grads_per_iter(self, n_chains: int) -> int:
        raise NotImplementedError

    def _augment_state(self, mstate, x0):
        """Samplers may extend the carried kernel state with chain-shaped
        caches (Langevin carries U(x) and grad U(x))."""
        return mstate

    def _extract_mstate(self, state):
        return state[0] if isinstance(state, tuple) else state

    def _make_output(self) -> MCMCOutput:
        """The run's output; samplers with further counters (PT's swaps)
        give their own statistics."""
        return MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                          on_device=self.params.store_samples_on_device)

    def _post_run(self, out: MCMCOutput) -> None:
        """Called after the run and the kernel's sync (PT folds its swap
        counters into the output's statistics)."""

    def _finish_run(self) -> None:
        """Called once at the end of every run of this sampler's steps
        (its own or a jump sampler's), inside the call that bound its
        chain shard: NUTS reduces its tree depths over the ranks here."""

    def _stash_final_carry(self, mstate) -> None:
        """Keeps what a continuation starts from of the run's final carried
        state: nothing here; PT keeps its hot rungs."""

    def _make_chunk_step(self, tuning: bool) -> Optional[Callable]:
        """The step a chunk runs, eager or captured: ``_make_step_aux``'s,
        but where a run pauses for eager work (:meth:`_run_pause`), without
        that work."""
        return self._make_step_aux(tuning)

    def _run_pause(self, tuning: bool, n_chains: int):
        """``(due, work)`` for ``ChunkedScanDriver.run``'s ``pause``, or
        None: eager work on the carried state at iterations the host knows
        before the run (the dense metric's refresh)."""
        return None

    def _graph_mode(self, tuning: bool) -> tuple:
        """What the chunk step bakes in from the kernel's host state, beside
        the tuning flag (the dense samplers' scalar math)."""
        return ()

    def _make_precompute(self, tuning: bool, graphed: bool = False) -> Optional[Callable]:
        """``(x, state, draws) -> aux`` or None: work of a chunk's steps that
        does not depend on the chain state, done in one pass up front (aux
        tensors with the draws' leading dims); the steps then run
        ``_make_step_precomputed``. None (the default) runs
        ``_make_step_aux``'s step. ``graphed``: the steps run as replays of
        a captured iteration (the aux tensors are its inputs), else
        eagerly."""
        return None

    def _make_step_precomputed(self, tuning: bool) -> Optional[Callable]:
        """``(x, state, draws, aux) -> (x', state', StepInfo)``."""
        return None

    def hoisted_elements_per_iter(self, x: torch.Tensor) -> Optional[int]:
        """f32 elements of one iteration's hoisted draws, where they exceed
        the chain state's (NUTS's leaf uniforms, ESS's shrink uniforms), so
        that the chunk cap tracks them; None otherwise."""
        return None

    def make_propose_aux(self) -> Optional[Callable]:
        """``(x, mstate, draws) -> (x', mask, diverged)``."""
        return None

    def _make_step_aux(self, tuning: bool) -> Optional[Callable]:
        """``(x, state, draws) -> (x', state', StepInfo)``: by default the
        proposal of ``make_propose_aux``, accepted through its mask, then the
        tuning update."""
        propose_aux = self.make_propose_aux()
        if propose_aux is None:
            return None
        update_kernel = self.make_update_kernel()
        event_ndim = len(self.event_shape)

        def step(x, mstate, draws):
            x_prime, mask, diverged = propose_aux(x, mstate, draws)
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), x_prime, x)
            if tuning:
                mstate = update_kernel(mstate, x_new, mask)
            info = StepInfo(n_accepted=mask.sum().to(torch.int32), diverged=diverged.to(torch.int32))
            return x_new, mstate, info

        return step

    # ---- kernel adaptation -------------------------------------------------
    def make_update_kernel(self) -> Callable:
        """The tuning update ``(mstate, x, mask) -> mstate``."""
        p = self.params
        tune_imd = getattr(p, "tune_inv_mass_diag", False)
        tune_step = getattr(p, "tune_step_size", False) and getattr(p, "adjustment", False)
        imd_adjustment = getattr(p, "imd_adjustment", 1e-3)
        da_params = getattr(self.kernel, "da_params", None) or DualAveragingParams()
        shard = self.chain_shard

        def update(mstate: MetropolisState, x: torch.Tensor, mask: torch.Tensor) -> MetropolisState:
            n_chains = x.shape[0]
            inv_mass_diag = mstate.inv_mass_diag
            if tune_imd and self._n_global(n_chains) > 1:
                inv_mass_diag = ema_inv_mass_diag(inv_mass_diag, x.reshape(n_chains, -1),
                                                  imd_adjustment, shard)
            da, step_size = mstate.da, mstate.step_size
            if tune_step:
                da, step_size = da_update_step_size(da, chain_mean(mask.to(torch.float32), shard),
                                                    da_params)
            return MetropolisState(step_size=step_size, inv_mass_diag=inv_mass_diag, da=da)

        return update

    # ---- public API ----------------------------------------------------------
    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        """Tuning run of ``n_warmup_iterations``; keeps the tuned kernel."""
        return self._run(x0, self.params.n_warmup_iterations, tuning=True,
                         show_progress=show_progress, time_limit_seconds=time_limit_seconds,
                         generator=self._generator(generator, seed), desc=f"{self.name} (tuning)")

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        return self._run(x0, self.params.n_iterations, tuning=self.params.tuning,
                         show_progress=show_progress, time_limit_seconds=time_limit_seconds,
                         generator=self._generator(generator, seed), desc=self.name)

    def graph_constants(self) -> tuple:
        """The tensors the step reads by closure that a later run may
        replace, the weights of ``graph_flows``: a captured graph reads them
        where they lie, so a new set captures anew."""
        return tuple(t for f in self.graph_flows for t in tree_leaves(f.params))

    def _static_config(self, per_iter) -> tuple:
        """What the memoised driver's step closures bake in: the target, the
        moment transform, the run configuration but for the iteration counts
        and the tuning flag, the kernel's static fields and the chain
        shard's size (the kernel's state is carried, not baked)."""
        params = tuple(sorted((k, v) for k, v in vars(self.params).items()
                              if k not in ("n_iterations", "n_warmup_iterations", "tuning")
                              and isinstance(v, (bool, int, float, str, type(None)))))
        kernel = self.kernel
        shard = self.chain_shard
        return (id(self.target), id(self.data_transform), self.draw_chain_axes, params,
                getattr(kernel, "n_leapfrog_steps", None), getattr(kernel, "da_params", None),
                tuple(id(f.bijection) for f in self.graph_flows),
                None if shard is None else shard.size, per_iter)

    def _get_driver(self, x0) -> ChunkedScanDriver:
        per_iter = self.hoisted_elements_per_iter(x0)
        return self._cached_driver(
            self._static_config(per_iter),
            lambda: ChunkedScanDriver(
                self.event_shape, self._make_chunk_step,
                lambda generator, prefix, n: self.make_draws()(generator, prefix, n),
                make_precompute=self._make_precompute, make_step_aux=self._make_step_precomputed,
                hoist_per_iter=(lambda _x: per_iter) if per_iter else None,
                data_transform=self.data_transform, draw_chain_axes=self.draw_chain_axes,
                capturable=graphs.declared(self, self.graph_flows),
                collective=self.collective_step),
            keepalive=(self.target, self.data_transform, self.graph_flows))

    def _run(self, x0, n_iterations: int, tuning: bool, show_progress: bool,
             time_limit_seconds, generator: torch.Generator, desc: str) -> MCMCOutput:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        n_chains = self._n_global(x0.shape[0])
        out = self._make_output()
        mstate = self._augment_state(self.kernel.make_state(self.device), x0)
        driver = self._get_driver(x0)
        _, mstate = driver.run(
            x0, mstate, generator, n_iterations, stats=out.statistics,
            samples=out.running_samples, calls_per_iter=self.calls_per_iter(n_chains),
            grads_per_iter=self.grads_per_iter(n_chains), tuning=tuning,
            collect=self.params.store_samples, time_limit_seconds=time_limit_seconds,
            show_progress=show_progress, desc=desc, shard=self.chain_shard,
            constants=self.graph_constants(), pause=self._run_pause(tuning, n_chains),
            mode=self._graph_mode(tuning),
        )
        self._finish_run()
        self.kernel.sync_from_state(self._extract_mstate(mstate))
        self._stash_final_carry(mstate)
        out.kernel = self.kernel
        self._post_run(out)
        return out


class MetropolisSampler(MCMCSampler):
    """The base of the samplers whose kernel is a :class:`MetropolisKernel`
    tuned by Metropolis adaptation (Langevin, HMC, MH, NUTS), as in the JAX
    package. It declares no ``multi_rank_chains``: each concrete class
    declares its own (:func:`nfmc_torch.core.chains.support_multi_rank`)."""

    def __init__(self, event_shape, target, kernel: MetropolisKernel,
                 params: MetropolisParameters, **kw):
        super().__init__(event_shape, target, kernel, params, **kw)

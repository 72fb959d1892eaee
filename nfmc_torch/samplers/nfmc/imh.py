"""Independence Metropolis-Hastings with a flow proposal, fixed and adaptive
(counterpart of ``nfmc_tpu/samplers/nfmc/imh.py``).

* ``warmup`` is the reverse-KL ``variational_fit`` of the flow to the
  target; its output holds one batch of flow draws.
* ``FixedIMH``: flow proposals and a Metropolis-Hastings accept with the
  flow log-prob and the potential of the current state carried through the
  accept mask, so one target call an iteration is made while the counters
  keep the reference's 2 C target calls and 0 gradient calls. The flow is
  frozen, so a chunk makes all its proposals in one batched coupling inverse
  (``ChunkedScanDriver``'s precompute) and then loops over the accept step.
* ``AdaptiveIMH``: the same accept step, then with probability
  ``adaptation_dropoff ** i`` a 1-epoch refit on one stored batch of draws
  chosen by ``train_distribution``. With a draw history under
  ``history_element_limit`` elements the history stays on the device and the
  refit is ``make_scan_fit`` (the fused path); above it the loop runs on the
  host with ``Flow.fit`` and a weight rollback. On CUDA, on one rank, with
  a flow that declares its kernels capturable, the fused path's iterations
  are replays of one captured graph: the host schedule enters it as two
  rows, the refit gate (an IF node, the JAX package's ``lax.cond``) and the
  stored batch's index. Counter quirk kept for parity: the accept step's
  2 C evaluations are counted as gradient calls.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core import graphs
from ...core.chains import all_rows
from ...core.driver import (
    RNG_HOIST_ELEMENT_LIMIT,
    ChunkedScanDriver,
    StatsAccum,
    StepInfo,
    flow_proposal_footprint_per_draw,
    hoisted_flow_proposals,
    plan_chunks,
    run_chunk_loop,
    synchronize,
)
from ...core.output import MCMCOutput
from ...core.sampler import NFMCKernel, NFMCParameters, Sampler
from ...flows.train import make_scan_fit
from ...utils import Progress, metropolis_acceptance_log_ratio, unevaluable_current_mask


@dataclass
class IMHKernel(NFMCKernel):
    pass


@dataclass
class IMHParameters(NFMCParameters):
    train_distribution: str = "uniform"
    adaptation_dropoff: float = 0.9999
    warmup_fit_kwargs: Optional[dict] = None

    def __post_init__(self):
        super().__post_init__()
        if self.train_distribution not in ("bounded_geom_approx", "bounded_geom", "uniform"):
            raise ValueError(f"bad train_distribution: {self.train_distribution}")
        if self.warmup_fit_kwargs is None:
            # a 128-draw batch per reverse-KL step (the reference draws one)
            self.warmup_fit_kwargs = {
                "early_stopping": True,
                "early_stopping_threshold": 50,
                "keep_best_weights": True,
                "n_samples": 128,
                "n_epochs": 500,
                "lr": 0.005,  # the reference's 0.05 diverges
                "check_for_divergences": True,
            }


def sample_bounded_geom(rng: np.random.Generator, p: float, max_val: int) -> int:
    """Exact bounded-geometric index sampler (reference ``imh.py:39-45``)."""
    v = np.arange(0, max_val + 1)
    pdf = p * (1 - p) ** (max_val - v) / (1 - (1 - p) ** (max_val + 1))
    cdf = np.cumsum(pdf)
    return int(np.searchsorted(cdf, rng.uniform(), side="right"))


class AbstractIMH(Sampler):
    # footprint cap (f32 elements) of a chunk's hoisted proposals; 0 forces
    # the in-loop step
    rng_hoist_element_limit: int = RNG_HOIST_ELEMENT_LIMIT

    def __init__(self, event_shape, target, kernel: Optional[IMHKernel] = None,
                 params: Optional[IMHParameters] = None, device=None):
        if kernel is None:
            kernel = IMHKernel(event_shape)
        if params is None:
            params = IMHParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        self.kernel.flow.to(self.device)

    @property
    def name(self):
        return "Abstract IMH"

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        """Reverse-KL fit of the flow to the target with
        ``params.warmup_fit_kwargs`` (which win over ``show_progress`` and
        ``time_limit_seconds``); returns one batch of flow draws."""
        seed_fit, seed_draw = self._sub_seeds(self._generator(generator, seed), 2)
        flow = self.kernel.flow.to(self.device)
        shard = self.chain_shard
        fit_kwargs = {
            "show_progress": show_progress,
            "time_limit_seconds": time_limit_seconds,
            "seed": seed_fit,
            **self.params.warmup_fit_kwargs,
        }
        if shard is not None:
            fit_kwargs["mesh"] = shard.mesh  # each rank takes its slice of the draws
        flow.variational_fit(lambda v: -self.target(v), **fit_kwargs)
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        draws = flow.sample(self._n_global(x0.shape[0]), seed=seed_draw)
        out.running_samples.add(self._chain_rows(draws, 0))
        return out

    def _make_accept_core(self):
        """``(x, flp_x, u_x, x', flp', u', log_u) -> (x_new, flp_new, u_new,
        mask, diverged)`` for a materialised proposal; the flow log-prob and
        the potential of the current state are carried through the mask."""
        event_ndim = len(self.event_shape)

        def accept_core(x, flp_x, u_x, x_prime, flp_prime, u_prime, log_u):
            n_chains = x.shape[0]
            log_alpha = metropolis_acceptance_log_ratio(
                log_prob_target_curr=-u_x,
                log_prob_target_prime=-u_prime,
                log_prob_proposal_curr=flp_x,
                log_prob_proposal_prime=flp_prime,
            )
            # finiteness is checked on the proposal side only: U(x) = +inf
            # gives log_alpha = +inf, a certain accept (how chains leave a
            # bad init), and an unevaluable current side (NaN U, log q =
            # -inf) forces the move
            finite = (torch.isfinite(x_prime.reshape(n_chains, -1)).all(-1)
                      & torch.isfinite(u_prime) & torch.isfinite(flp_prime))
            mask = ((log_u < log_alpha) | unevaluable_current_mask(u_x, flp_x)) & finite
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), x_prime, x)
            flp_new = torch.where(mask, flp_prime, flp_x)
            u_new = torch.where(mask, u_prime, u_x)
            diverged = (~finite.all()).to(torch.int32)
            return x_new, flp_new, u_new, mask, diverged

        return accept_core

    def _make_accept_step(self):
        """``(params, x, flp_x, u_x, (z, log_u)) -> (x', flp', u', mask,
        diverged)``: the proposal from base draws ``z`` (``(C, *event)``)."""
        flow = self.kernel.flow
        target = self.target
        accept_core = self._make_accept_core()

        def accept_step(params, x, flp_x, u_x, draws):
            z, log_u = draws
            x_prime, flp_prime = flow.push_base_fn(params, z)
            return accept_core(x, flp_x, u_x, x_prime, flp_prime, target(x_prime), log_u)

        return accept_step

    def make_draws(self, generator: torch.Generator, prefix, n_chains: int):
        """A block of iterations' randomness with leading dims ``prefix``:
        the proposals' base draws ``(*prefix, C, *event)`` and the accept
        log-uniforms ``(*prefix, C)``."""
        prefix = tuple(prefix)
        n = int(np.prod(prefix)) * n_chains
        z = self.kernel.flow.sample_base_fn(generator, n)
        log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator,
                                     device=generator.device))
        return z.reshape(*prefix, n_chains, *z.shape[1:]), log_u


class FixedIMH(AbstractIMH):
    multi_rank_chains = True
    # static shapes, no host read in the step: chunks replay a CUDA graph
    graph_capturable = True

    @property
    def name(self):
        return "Fixed IMH"

    def _get_driver(self) -> ChunkedScanDriver:
        """The driver, memoised across calls: its steps bake in the flow's
        structure, the target and the hoisting limit (the weights ride in
        the carried state)."""
        flow = self.kernel.flow
        target = self.target
        accept_core = self._make_accept_core()
        accept_step = self._make_accept_step()
        hoist_limit = self.rng_hoist_element_limit
        per_draw = flow_proposal_footprint_per_draw(flow, self.event_size)
        n_global = self._n_global

        def make_precompute(tuning, graphed):
            # the proposals do not depend on the chain state: the chunk's
            # base draws go through ONE batched coupling inverse, and their
            # potential through one target call; declined above the cap
            def precompute(x, kstate, draws):
                z = draws[0]
                if z.shape[0] * n_global(x.shape[0]) * per_draw > hoist_limit:
                    return None
                return hoisted_flow_proposals(flow, kstate[0], z, target=target)

            return precompute

        def info(mask, diverged):
            return StepInfo(n_accepted=mask.sum().to(torch.int32), diverged=diverged)

        def make_step_aux(tuning):
            def step(x, kstate, draws, aux):
                params, flp_x, u_x = kstate
                x_new, flp_new, u_new, mask, diverged = accept_core(x, flp_x, u_x, *aux, draws[1])
                return x_new, (params, flp_new, u_new), info(mask, diverged)

            return step

        def make_step(tuning):
            # the in-loop step, for chunks whose precompute declines
            def step(x, kstate, draws):
                params, flp_x, u_x = kstate
                x_new, flp_new, u_new, mask, diverged = accept_step(params, x, flp_x, u_x, draws)
                return x_new, (params, flp_new, u_new), info(mask, diverged)

            return step

        return self._cached_driver(
            (id(flow), id(flow.bijection), id(target), hoist_limit, per_draw,
             None if self.chain_shard is None else self.chain_shard.size),
            lambda: ChunkedScanDriver(self.event_shape, make_step, self.make_draws,
                                      make_precompute=make_precompute,
                                      make_step_aux=make_step_aux,
                                      hoist_per_iter=lambda x: n_global(x.shape[0]) * per_draw,
                                      capturable=graphs.declared(self, (flow,))),
            keepalive=(flow, flow.bijection, target))

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        generator = self._generator(generator, seed)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device).clone()
        n_chains = self._n_global(x0.shape[0])
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        flow = self.kernel.flow.to(self.device)
        driver = self._get_driver()
        t0 = time.time()
        with torch.no_grad():
            flp0 = flow.log_prob(x0)
            u0 = self.target(x0)
        out.statistics.update_elapsed_time(time.time() - t0)
        driver.run(
            x0, (flow.params, flp0, u0), generator, self.params.n_iterations,
            stats=out.statistics, samples=out.running_samples, calls_per_iter=2 * n_chains,
            grads_per_iter=0, collect=self.params.store_samples,
            time_limit_seconds=time_limit_seconds, show_progress=show_progress, desc=self.name,
            shard=self.chain_shard,
        )
        out.kernel = self.kernel
        return out


class AdaptiveIMH(AbstractIMH):
    """Sharded over several ranks, each rank keeps its chains' history; a
    refit gathers the stored batch of all the chains and every rank trains
    on all of it with the same generator, so the weights are the unsharded
    run's bit for bit. (Not data-parallel: a refit is one fresh Adam step,
    ``lr * g / (|g| + eps)``, so a gradient component that the ranks' sum
    order puts on the other side of 0 would move its weight by ``2 lr``,
    and the runs would part.) The schedule's numpy stream is seeded from
    the run's generator, the same on every rank."""

    multi_rank_chains = True
    # the fused path's iteration (accept, history write, gated refit and
    # rescore): static shapes, its schedule and refit rows hoisted, no host
    # read; on one rank its chunks replay a CUDA graph
    graph_capturable = True
    # footprint cap (f32 elements) of the fused path's draw history on the
    # device; its own knob, so that the proposal limit cannot switch paths
    history_element_limit: int = RNG_HOIST_ELEMENT_LIMIT

    def __init__(self, event_shape, target, kernel=None, params=None, device=None):
        super().__init__(event_shape, target, kernel, params, device=device)
        if not self.params.store_samples:
            print("Warning: params.store_samples is False")
            print("Warning: setting params.store_samples to True")
            self.params.store_samples = True

    @property
    def name(self):
        return "Adaptive IMH"

    def _train_index(self, rng: np.random.Generator, n_samples: int) -> int:
        if self.params.train_distribution == "uniform":
            return int(rng.integers(0, n_samples))
        if self.params.train_distribution == "bounded_geom_approx":
            return int(rng.integers(max(0, n_samples - 100), n_samples))
        return sample_bounded_geom(rng, p=0.025, max_val=n_samples - 1)

    def _adaptation_schedule(self, rng: np.random.Generator, start: int, chunk: int,
                             offset: int = 0):
        """``(do_fit, k_idx)`` for iterations ``[start, start + chunk)``,
        drawn from ``rng`` in the host loop's order: the adaptation decision
        (probability ``dropoff ** (offset + i)``) and the stored batch to
        refit on, which depend only on the iteration index (``n_samples`` at
        iteration i is i + 1). ``offset`` shifts only the exponent, for a
        continued run."""
        do_fit = np.zeros(chunk, dtype=bool)
        k_idx = np.zeros(chunk, dtype=np.int32)
        for j in range(chunk):
            i_abs = start + j
            if rng.uniform() < self.params.adaptation_dropoff ** (offset + i_abs):
                do_fit[j] = True
                k_idx[j] = self._train_index(rng, i_abs + 1)
        return do_fit, k_idx

    def extra_resumable_state(self):
        """Checkpoint hook: the absolute adaptation-schedule position."""
        n = int(getattr(self, "_iters_done", 0))
        return {} if n == 0 else {"imh_iters_done": np.int64(n)}

    def restore_extra_resumable_state(self, state) -> None:
        if "imh_iters_done" in state:
            self._iters_done = int(state["imh_iters_done"])

    def sample_continue(self, x0, **kwargs) -> MCMCOutput:
        """Continue a run: the adaptation probability keeps decaying from the
        iterations done so far; the training history is this call's."""
        self._continue_offset = int(getattr(self, "_iters_done", 0))
        try:
            return self.sample(x0, **kwargs)
        finally:
            self._continue_offset = 0

    def _schedule_rng(self, generator: torch.Generator) -> np.random.Generator:
        """The host schedule's numpy stream, seeded from the run's generator
        before any per-iteration draw, so the two streams do not share
        material."""
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device).item())
        return np.random.default_rng(seed)

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        generator = self._generator(generator, seed)
        self.params.store_samples = True
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device).clone()
        n_chains = self._n_global(x0.shape[0])
        n_total = self.params.n_iterations
        offset = int(getattr(self, "_continue_offset", 0))
        self.kernel.flow.to(self.device)
        rng = self._schedule_rng(generator)
        (fit_seed,) = self._sub_seeds(generator, 1)
        fit_generator = torch.Generator(device=self.device).manual_seed(fit_seed)
        if n_total * n_chains * self.event_size <= self.history_element_limit:
            return self._sample_fused(x0, generator, rng, fit_generator, show_progress,
                                      time_limit_seconds, offset)
        return self._sample_host(x0, generator, rng, fit_generator, show_progress,
                                 time_limit_seconds, offset)

    def _sample_host(self, x0, generator, rng, fit_generator, show_progress,
                     time_limit_seconds, offset) -> MCMCOutput:
        """The loop on the host: per iteration one accept step, then maybe
        ``Flow.fit(n_epochs=1)`` on a stored batch, rolled back if it raises
        ``ValueError``."""
        out = MCMCOutput(self.event_shape, store_samples=True,
                         on_device=self.params.store_samples_on_device)
        flow = self.kernel.flow
        accept_step = self._make_accept_step()
        shard = self.chain_shard
        n_chains = self._n_global(x0.shape[0])

        t0 = time.time()
        x = x0
        with torch.no_grad():
            flp_x = flow.log_prob(x)
            u_x = self.target(x)
        out.statistics.update_elapsed_time(time.time() - t0)

        completed = 0
        bar = Progress(total=self.params.n_iterations, desc=self.name, disable=not show_progress)
        for i in range(self.params.n_iterations):
            if time_limit_seconds is not None:
                over = out.statistics.elapsed_time_seconds >= time_limit_seconds
                if shard.any(over) if shard is not None else over:
                    break
            completed = i + 1
            t0 = time.time()
            draws = tuple(self._chain_rows(d[0], 0)
                          for d in self.make_draws(generator, (1,), n_chains))
            with torch.no_grad():
                x, flp_x, u_x, mask, diverged = accept_step(flow.params, x, flp_x, u_x, draws)
            n_acc, x_all = mask.sum(), x
            if shard is not None:
                n_acc, diverged, x_all = shard.sum(n_acc), shard.max(diverged), shard.gather(x, 0)
            out.statistics.update_counters(
                # reference parity: the accept step's target evaluations are
                # counted as gradient calls (``imh.py:146``)
                n_target_gradient_calls=2 * n_chains,
                n_accepted_trajectories=int(n_acc),
                n_attempted_trajectories=n_chains,
                n_divergences=int(diverged),
            )
            out.statistics.expectations.update(x_all)
            out.running_samples.add(x)

            if rng.uniform() < self.params.adaptation_dropoff ** (offset + i):
                k = self._train_index(rng, out.running_samples.n_samples)
                x_train = out.running_samples[k]
                if shard is not None:
                    x_train = shard.gather(x_train, 0)
                flow_weights = flow.state_dict()
                try:
                    flow.fit(x_train, n_epochs=1, show_progress=False, generator=fit_generator)
                    flp_x = flow.log_prob(x)  # the cached proposal density is stale
                except ValueError:
                    flow.load_state_dict(flow_weights)
            out.statistics.update_elapsed_time(time.time() - t0)
            bar.update(1)
        bar.close()
        # only the iterations actually completed count
        self._iters_done = offset + completed
        out.kernel = self.kernel
        return out

    def make_fused_state(self, x0: torch.Tensor, n_total: int) -> dict:
        """The fused path's carried state: flow params, the chains, their
        flow log-prob and potential, the draw history on the device and the
        accumulators."""
        flow = self.kernel.flow
        with torch.no_grad():
            return {"params": flow.params, "x": x0, "flp": flow.log_prob_fn(flow.params, x0),
                    "u": self.target(x0),
                    "hist": torch.zeros((n_total, *x0.shape), dtype=torch.float32,
                                        device=x0.device),
                    "acc": StatsAccum.zeros(self.event_shape, x0.device, self.chain_shard)}

    def _make_fused_iteration(self, scan_fit):
        """``iteration(carried, hist, draws, do_fit, k, at, rows) ->
        carried``: one iteration of the fused path, which its eager loop and
        its graph's body both run. It accepts (``draws`` the iteration's
        ``(z, log_u)``), writes the new state into history row ``at``, and
        where ``do_fit`` holds refits the flow for one epoch on history row
        ``k`` (every rank's rows of it; ``rows`` the refit's hoisted
        permutations) and rescores the current state, whose cached flow
        log-prob is stale after a refit. ``carried`` is ``(params, x, flp,
        u, acc)``; the gate and the indices are host values in the eager
        loop, 0-d device tensors at the counter in the body."""
        flow = self.kernel.flow
        shard = self.chain_shard
        accept_step = self._make_accept_step()

        def iteration(carried, hist, draws, do_fit, k, at, rows):
            params, x, flp, u, acc = carried
            x, flp, u, mask, diverged = accept_step(params, x, flp, u, draws)
            if isinstance(at, int):
                hist[at].copy_(x)
            else:
                hist.index_copy_(0, at.view(1), x.unsqueeze(0))

            def refit(ops):
                data = hist[k] if isinstance(k, int) else hist.index_select(0, k.view(1))[0]
                fitted = scan_fit(ops[0], all_rows(data, shard), rows=rows)
                return fitted, flow.log_prob_fn(fitted, x)

            params, flp = graphs.cond(do_fit, refit, (params, flp))
            acc = acc.add(StepInfo(n_accepted=mask.sum().to(torch.int32), diverged=diverged), x)
            return params, x, flp, u, acc

        return iteration

    def run_fused_chunk(self, st: dict, i0: int, draws, do_fit, k_idx, scan_fit,
                        fit_generator=None, fit_rows=None) -> dict:
        """Iterations ``[i0, i0 + chunk)`` of the fused path's eager loop on
        state ``st`` with injected ``draws`` (``make_draws``'s, leading dim
        ``chunk``) and schedule ``do_fit`` / ``k_idx``
        (:meth:`_make_fused_iteration`). The refits' rows are ``fit_rows``
        (``scan_fit.draws``'s, leading dim ``chunk``), or drawn so from
        ``fit_generator`` up front."""
        if fit_rows is None:
            fit_rows = scan_fit.draws(fit_generator, do_fit)
        iteration = self._make_fused_iteration(scan_fit)
        carried = tuple(st[k] for k in _CARRIED)
        with torch.no_grad():
            for j in range(len(do_fit)):
                carried = iteration(carried, st["hist"], tuple(d[j] for d in draws),
                                    bool(do_fit[j]), int(k_idx[j]), i0 + j,
                                    [r[j] for r in fit_rows])
        return {**st, **dict(zip(_CARRIED, carried))}

    def fused_graph_runner(self, st: dict, scan_fit, length: int):
        """``run(st, i0, draws, do_fit, k_idx, fit_rows) -> st``:
        :meth:`run_fused_chunk`'s iterations as replays of one graph of the
        fused path's iteration (made at the first chunk), over static
        buffers: the carried weights, chains, flow log-probs, potentials and
        accumulators; each iteration's draws, refit gate (an IF node under
        a capture), stored batch index, history row and refit rows at the
        counter, ``length`` iterations of them. The history is the run's own
        buffer ``st["hist"]``, which the body writes and reads where it
        lies, so the graph lives as long as the runner, not in the cache."""
        iteration = self._make_fused_iteration(scan_fit)
        hist = st["hist"]
        leaves, spec = graphs.flatten(_carried(st))
        made = []

        def body(state, rows):
            z, log_u, do_fit, k, at, *fit_rows = rows
            carried = iteration(graphs.unflatten(spec, state), hist, (z, log_u), do_fit, k, at,
                                fit_rows)
            new_leaves, new_spec = graphs.flatten(carried)
            if new_spec != spec:
                raise RuntimeError("a captured iteration changed the structure of its state")
            return new_leaves, []

        def run(st, i0, draws, do_fit, k_idx, fit_rows):
            device = hist.device
            chunk = len(do_fit)
            inputs = [*draws, torch.as_tensor(np.asarray(do_fit, dtype=bool), device=device),
                      torch.as_tensor(np.asarray(k_idx), dtype=torch.int64, device=device),
                      torch.arange(i0, i0 + chunk, device=device), *fit_rows]
            if not made:
                made.append(graphs.IterationGraph(
                    body, leaves, [((length, *t.shape[1:]), t.dtype) for t in inputs], [],
                    device))
            graph = made[0]
            graph.load(graphs.flatten(_carried(st))[0], inputs)
            with torch.no_grad():
                graph.run(chunk)
            return {**st, **dict(zip(_CARRIED, graphs.unflatten(spec, graph.state)))}

        return run

    def _sample_fused(self, x0, generator, rng, fit_generator, show_progress,
                      time_limit_seconds, offset) -> MCMCOutput:
        """The history on the device, the schedule drawn per chunk on the
        host in the host loop's order, and the refit ``make_scan_fit``
        (1 epoch, a fresh Adam, rollback on a non-finite loss), its rows
        drawn a chunk at a time for the refitting iterations. On CUDA, on
        one rank (a refit gathers the chains), with a flow that declares its
        kernels capturable, each chunk is replays of one captured iteration
        (:meth:`fused_graph_runner`)."""
        flow = self.kernel.flow
        shard = self.chain_shard
        n_chains = self._n_global(x0.shape[0])
        n_total = self.params.n_iterations
        out = MCMCOutput(self.event_shape, store_samples=True,
                         on_device=self.params.store_samples_on_device)
        scan_fit = make_scan_fit(flow, n_chains, n_epochs=1)
        pipelined = time_limit_seconds is None and not show_progress

        t0 = time.time()
        st = self.make_fused_state(x0, n_total)
        out.statistics.update_elapsed_time(time.time() - t0)
        replayed = None
        if graphs.declared(self, (flow,)) and graphs.captures(self.device, shard,
                                                             collective=True):
            replayed = self.fused_graph_runner(st, scan_fit,
                                               max(plan_chunks(n_total, pipelined, 256), default=1))

        def dispatch(chunk, iters_done):
            do_fit, k_idx = self._adaptation_schedule(rng, iters_done, chunk, offset=offset)
            draws = tuple(self._chain_rows(d, 1)
                          for d in self.make_draws(generator, (chunk,), n_chains))
            fit_rows = scan_fit.draws(fit_generator, do_fit)
            if replayed is None:
                st.update(self.run_fused_chunk(st, iters_done, draws, do_fit, k_idx, scan_fit,
                                               fit_rows=fit_rows))
            else:
                st.update(replayed(st, iters_done, draws, do_fit, k_idx, fit_rows))

        def flush(iters):
            acc = st["acc"]
            sum_x, sum_x2 = acc.moment_sums()
            host = torch.cat([acc.host_counts(), sum_x.reshape(-1).to(torch.float64),
                              sum_x2.reshape(-1).to(torch.float64)])
            host = acc.reduced(host, shard).cpu().numpy()
            out.statistics.update_counters(
                n_accepted_trajectories=int(host[0]),
                n_attempted_trajectories=iters * n_chains,
                n_divergences=int(host[1]),
                # reference parity: the accept step's target evaluations are
                # counted as gradient calls (``imh.py:146``)
                n_target_gradient_calls=2 * n_chains * iters,
            )
            s_x, s_x2 = np.split(host[6:], 2)
            out.statistics.update_moments_from_sums(
                s_x.reshape(self.event_shape), s_x2.reshape(self.event_shape), iters * n_chains)
            st["acc"] = StatsAccum.zeros(self.event_shape, self.device, shard)

        iters_done = run_chunk_loop(
            n_total, dispatch=dispatch, sync=lambda: synchronize(self.device),
            stats=out.statistics, flush=flush, time_limit_seconds=time_limit_seconds,
            show_progress=show_progress, desc=self.name, sync_max_chunk=256, shard=shard,
        )
        if iters_done:
            out.running_samples.add(st["hist"][:iters_done])
        self._iters_done = offset + iters_done  # only completed iterations
        flow.params = st["params"]
        out.kernel = self.kernel
        return out


# the fused path's carried state, in the order its iteration takes it
_CARRIED = ("params", "x", "flp", "u", "acc")


def _carried(st: dict) -> tuple:
    """What the fused path's graph carries of its state ``st``: the
    weights, chains, flow log-probs, potentials and accumulators (the
    history stays where it lies)."""
    return (*(st[k] for k in _CARRIED[:-1]), dataclasses.replace(st["acc"], div_flags=None))

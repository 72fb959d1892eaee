"""DLMC: deterministic Langevin Monte Carlo with a flow as the density
estimator (counterpart of ``nfmc_tpu/samplers/nfmc/dlmc.py``).

* start: one gradient step on the negative log-likelihood;
* an iteration: (1) refit the flow by maximum likelihood to the current
  particles; (2) drift them deterministically, ``x <- x - tau grad(U +
  log q)``, or with ``latent_updates`` ``z <- z - tau (grad U - z)`` through
  the flow; (3) an independence Metropolis accept against fresh flow draws,
  with finiteness checked on the proposal side only and an unevaluable
  current side (NaN U, log q = -inf) forced to move;
* counters: B target calls and B gradient calls at the start, then B + 2 B
  target calls and B gradient calls an iteration;
* warmup does nothing and returns ``x0``.

With fixed-effort ``flow_fit_kwargs`` (no early stopping, no time limit,
e.g. ``dict(n_epochs=10)``) the refit is ``make_scan_fit`` with a fresh Adam
each iteration, and the iterations run through the chunked driver with the
flow's weights in its carried state, the refit's permutations hoisted from
the fit's generator a chunk at a time. On CUDA, on one rank, with a flow
that declares its kernels capturable, an iteration (refit, drift, accept)
is one captured graph, replayed (the JAX package's ``lax.scan`` with the
refit in its body; the refit's epochs a WHILE node). Any other
``flow_fit_kwargs`` run the host loop (``Flow.fit``, which may stop early).
Both paths share one drift and one accept.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ...core import graphs
from ...core.chains import all_rows
from ...core.driver import ChunkedScanDriver, StepInfo
from ...core.output import MCMCOutput
from ...core.sampler import NFMCKernel, NFMCParameters, Sampler
from ...core.tuning import train_val_split
from ...flows.train import fixed_effort_fit_config, make_scan_fit
from ...utils import (
    Progress,
    batched_grad,
    event_size_of,
    metropolis_acceptance_log_ratio,
    unevaluable_current_mask,
)


@dataclass
class DLMCKernel(NFMCKernel):
    step_size: float = 0.05


@dataclass
class DLMCParameters(NFMCParameters):
    latent_updates: bool = False


class DLMC(Sampler):
    multi_rank_chains = True
    # the fused iteration (refit, drift, accept): static shapes, the refit's
    # randomness hoisted, no host read; on one rank its chunks replay a CUDA
    # graph
    graph_capturable = True

    def __init__(self, event_shape, target, negative_log_likelihood,
                 kernel: Optional[DLMCKernel] = None, params: Optional[DLMCParameters] = None,
                 device=None):
        if kernel is None:
            kernel = DLMCKernel(event_shape)
        if params is None:
            params = DLMCParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        self.negative_log_likelihood = negative_log_likelihood
        self.kernel.flow.to(self.device)

    @property
    def name(self):
        return "DLMC"

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        out.running_samples.add(torch.as_tensor(x0, dtype=torch.float32))
        return out

    def make_draws(self, generator: torch.Generator, prefix, n_chains: int):
        """The accepts' randomness with leading dims ``prefix``: the flow
        proposals' base draws ``(*prefix, C, *event)`` and the log-uniforms
        ``(*prefix, C)``."""
        prefix = tuple(prefix)
        n = 1
        for s in prefix:
            n *= s
        z = self.kernel.flow.sample_base_fn(generator, n * n_chains)
        log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator,
                                     device=generator.device))
        return z.reshape(*prefix, n_chains, *z.shape[1:]), log_u

    def _make_drift_accept(self):
        """``drift(params, x) -> x'`` and ``accept(params, x, (z, log_u)) ->
        (x', mask, diverged)``, shared by both paths."""
        flow = self.kernel.flow
        tau = float(self.kernel.step_size)
        target = self.target
        latent_updates = self.params.latent_updates
        event_ndim = len(self.event_shape)

        def drift(params, x):
            if latent_updates:
                z, _ = flow.bijection.forward_fn(params, x)
                g = batched_grad(target)(x)
                z = z - tau * (g - z)
                return flow.bijection.inverse_fn(params, z)[0]
            g = batched_grad(lambda v: target(v) + flow.log_prob_fn(params, v))(x)
            return x - tau * g

        def accept(params, x, draws):
            z, log_u = draws
            n_chains = x.shape[0]
            x_tilde, flp_tilde = flow.push_base_fn(params, z)
            u_tilde = target(x_tilde)
            u_curr = target(x)
            flp_curr = flow.log_prob_fn(params, x)
            log_alpha = metropolis_acceptance_log_ratio(
                log_prob_target_curr=-u_curr,
                log_prob_target_prime=-u_tilde,
                log_prob_proposal_curr=flp_curr,
                log_prob_proposal_prime=flp_tilde,
            )
            # finiteness on the proposal side only: U(x) = +inf gives a
            # certain accept (the way out of a bad start), and an
            # unevaluable current side is forced to move
            finite = (torch.isfinite(x_tilde.reshape(n_chains, -1)).all(-1)
                      & torch.isfinite(u_tilde) & torch.isfinite(flp_tilde))
            mask = ((log_u < log_alpha) | unevaluable_current_mask(u_curr, flp_curr)) & finite
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), x_tilde, x)
            return x_new, mask, (~finite.all()).to(torch.int32)

        return drift, accept

    def sample_continue(self, x0, **kwargs) -> MCMCOutput:
        """Continue a run: the start's gradient step is not repeated."""
        self._skip_init_step = True
        try:
            return self.sample(x0, **kwargs)
        finally:
            self._skip_init_step = False

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        generator = self._generator(generator, seed)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        n_chains = self._n_global(x0.shape[0])
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        self.kernel.flow.to(self.device)
        t0 = time.time()
        if getattr(self, "_skip_init_step", False):
            x = x0
        else:
            x = x0 - self.kernel.step_size * batched_grad(self.negative_log_likelihood)(x0)
            out.statistics.update_counters(n_target_calls=n_chains,
                                           n_target_gradient_calls=n_chains)
        out.statistics.update_elapsed_time(time.time() - t0)
        fit_cfg = fixed_effort_fit_config(self.params.flow_fit_kwargs)
        if fit_cfg is not None:
            self._sample_fused(x, out, generator, fit_cfg, show_progress, time_limit_seconds)
        else:
            self._sample_host(x, out, generator, show_progress, time_limit_seconds)
        out.kernel = self.kernel
        return out

    def _make_fused_step(self, fit):
        """``make_step(tuning)`` of the fused iteration: ``step(x, params,
        (z, log_u, *rows))`` refits the flow with ``fit`` on all the
        particles (``rows`` its hoisted permutations), then drifts and
        accepts with the new weights (the JAX package's
        ``_make_fused_step``)."""
        shard = self.chain_shard
        drift, accept = self._make_drift_accept()

        def make_step(tuning):
            def step(x, params, draws):
                z, log_u, *rows = draws
                # every rank refits on all the particles, to the same weights
                params = fit(params, all_rows(x, shard), rows=rows)
                x, mask, diverged = accept(params, drift(params, x), (z, log_u))
                return x, params, StepInfo(n_accepted=mask.sum().to(torch.int32),
                                           diverged=diverged)

            return step

        return make_step

    def _sample_fused(self, x, out, generator, fit_cfg, show_progress, time_limit_seconds):
        """Refit, drift and accept as one iteration of the chunked driver,
        the flow's weights its carried state and the refit's rows its second
        draw source."""
        flow = self.kernel.flow
        shard = self.chain_shard
        n_chains = self._n_global(x.shape[0])
        n_epochs, lr, batch_size, keep_best_weights, shuffle = fit_cfg
        fit = make_scan_fit(flow, n_chains, n_epochs=n_epochs, lr=lr, batch_size=batch_size,
                            shuffle=shuffle, keep_best_weights=keep_best_weights,
                            train_pct=self.params.train_pct,
                            max_train_size=self.params.max_train_size,
                            max_val_size=self.params.max_val_size)
        (fit_seed,) = self._sub_seeds(generator, 1)
        fit_generator = torch.Generator(device=self.device).manual_seed(fit_seed)
        per_iter = n_chains * (event_size_of(self.event_shape) + 1) + fit.row_elems
        driver = ChunkedScanDriver(self.event_shape, self._make_fused_step(fit), self.make_draws,
                                   hoist_per_iter=lambda _x: per_iter,
                                   capturable=graphs.declared(self, (flow,)), collective=True)
        _x, params = driver.run(
            x, flow.params, generator, self.params.n_iterations, stats=out.statistics,
            samples=out.running_samples, calls_per_iter=3 * n_chains, grads_per_iter=n_chains,
            collect=self.params.store_samples, time_limit_seconds=time_limit_seconds,
            show_progress=show_progress, desc="DLMC sampling", shard=shard,
            fit_rows=lambda chunk: fit.draws(fit_generator, chunk))
        flow.params = params

    def _sample_host(self, x, out, generator, show_progress, time_limit_seconds):
        """The loop on the host, for refits that may stop early: ``Flow.fit``
        on a train/validation split of the particles (a ``ValueError`` keeps
        the weights it leaves), then the drift and the accept."""
        flow = self.kernel.flow
        shard = self.chain_shard
        n_chains = self._n_global(x.shape[0])

        def every(v):  # all the particles of v
            return v if shard is None else shard.gather(v, 0)

        drift, accept = self._make_drift_accept()
        stats = out.statistics
        bar = Progress(total=self.params.n_iterations, desc="DLMC sampling",
                       disable=not show_progress)
        for _ in range(self.params.n_iterations):
            if time_limit_seconds is not None:
                over = stats.elapsed_time_seconds >= time_limit_seconds
                if shard.any(over) if shard is not None else over:
                    break
            t0 = time.time()
            seed_split, seed_fit = self._sub_seeds(generator, 2)
            x_train, x_val = train_val_split(
                every(x)[None], train_pct=self.params.train_pct,
                max_train_size=self.params.max_train_size,
                max_val_size=self.params.max_val_size, seed=seed_split)
            try:
                flow.fit(x_train, x_val=x_val, **self.params.flow_fit_kwargs, seed=seed_fit,
                         mesh=None if shard is None else shard.mesh)
            except ValueError:
                pass
            draws = tuple(self._chain_rows(d, 1)[0]
                          for d in self.make_draws(generator, (1,), n_chains))
            with torch.no_grad():
                x, mask, diverged = accept(flow.params, drift(flow.params, x), draws)
            out.running_samples.add(x)
            stats.expectations.update(every(x))
            n_acc = mask.sum()
            if shard is not None:
                n_acc, diverged = shard.sum(n_acc), shard.max(diverged)
            stats.update_counters(n_target_calls=3 * n_chains, n_target_gradient_calls=n_chains,
                                  n_accepted_trajectories=int(n_acc),
                                  n_attempted_trajectories=n_chains, n_divergences=int(diverged))
            stats.update_elapsed_time(time.time() - t0)
            bar.update(1)
            if show_progress:
                bar.set_postfix_str(f"{stats}")
        bar.close()

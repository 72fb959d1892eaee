"""TESS: transport elliptical slice sampling (counterpart of
``nfmc_tpu/samplers/nfmc/tess.py``).

* the state is the latent ``u``; a step draws an ellipse ``v ~ N(0,
  cov)`` and a threshold ``log s = log pi^(u) + log phi(v) + log w``, with
  ``log pi^`` the pullback of the target through the flow's inverse and
  ``log phi`` the density ``v`` was drawn from, then rotates ``(u, v)``
  through ``max_ess_step_iterations`` rounds of a shrinking bracket. Every
  round is evaluated; the first accepted point wins (masks). The step
  returns the data-space ``x = f^{-1}(u)`` too;
* the current state's ``(log pi^(u), f^{-1}(u))`` is carried from the step
  that accepted it, so a step evaluates the target once a round;
* the reference's quirk is kept: the bracket's first angle is ``N(0, 1) *
  2 pi``, not uniform;
* deviation from the reference, as in the JAX package: the pullback adds
  the inverse's log-det (``log pi(f^{-1}(u)) + log|det df^{-1}/du|``); the
  reference subtracts it, which targets ``pi(x) / |J|^2``;
* warmup (20 iterations) alternates a step and a maximum-likelihood refit
  of the flow on the produced ``x``, from ``u ~ N(0, I)``, storing latent
  draws; with fixed-effort ``flow_fit_kwargs`` the refit is
  ``make_scan_fit`` inside the chunk (a fresh Adam each iteration, its
  permutations hoisted from the fit's generator), on CUDA on one rank a
  replay of one captured iteration with the refit in it, else a host loop
  with ``Flow.fit``;
* ``sample`` treats ``x0`` as the latent start and stores data-space draws;
* counters: ``(max_ess_step_iterations + 1) B`` target calls an iteration,
  no gradient call.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...core import graphs
from ...core.chains import all_rows
from ...core.driver import ChunkedScanDriver, StepInfo
from ...core.output import MCMCOutput
from ...core.sampler import NFMCKernel, NFMCParameters, Sampler
from ...core.tuning import train_val_split
from ...flows.train import fixed_effort_fit_config, make_scan_fit
from ...utils import LOG_2PI, Progress, event_size_of


@dataclass
class TESSKernel(NFMCKernel):
    cov: Optional[np.ndarray] = None

    def chol(self, device="cpu"):
        if self.cov is None:
            return None
        return torch.linalg.cholesky(torch.as_tensor(np.asarray(self.cov), dtype=torch.float32,
                                                     device=device))


@dataclass
class TESSParameters(NFMCParameters):
    n_warmup_iterations: int = 20
    max_ess_step_iterations: int = 5


def make_tess_step(flow, potential, event_shape: Tuple[int, ...], max_iterations: int = 5,
                   chol: Optional[torch.Tensor] = None):
    """``(init, step, draws)``:

    * ``init(params, u) -> (lp_u, x_u)``: the pullback log-density of ``u``
      and its data-space point;
    * ``draws(generator, prefix, n_chains) -> (z, w, theta0, shrink)``: a
      step's randomness with leading dims ``prefix``: the ellipse's raw
      normal ``(*prefix, C, *event)`` (``(*prefix, C, D)`` with ``chol``),
      the threshold uniform ``(*prefix, C)``, the angle's raw normal and the
      bracket's shrink uniforms ``(*prefix, [max_iterations,] C, 1, ...)``;
    * ``step(params, u, lp_u, x_u, draws) -> (x', u', lp', accepted)``.
    """
    event_ndim = len(event_shape)

    if chol is None:
        def log_phi(inputs):
            return flow.base_log_prob_fn(inputs)
    else:
        # v is drawn as chol z ~ N(0, cov), so the threshold and the accept
        # evaluate that density (the whitened quadratic form)
        dim = chol.shape[0]
        logdet_chol = torch.log(torch.diagonal(chol)).sum()

        def log_phi(inputs):
            batch_shape = inputs.shape[: inputs.dim() - event_ndim]
            flat = inputs.reshape(-1, dim)
            zw = torch.linalg.solve_triangular(chol, flat.T, upper=False).T
            lp = -0.5 * (zw * zw).sum(-1) - logdet_chol - 0.5 * dim * LOG_2PI
            return lp.reshape(batch_shape)

    def log_pi_hat(params, inputs):
        # log pi(f^{-1}(u)) + log|det df^{-1}/du| (the corrected sign)
        x, log_det = flow.bijection.inverse_fn(params, inputs)
        return -potential(x) + log_det, x

    def tess_init(params, u):
        return log_pi_hat(params, u)

    def tess_draws(generator, prefix, n_chains):
        prefix = tuple(prefix)
        dev = generator.device
        expand = (n_chains,) + (1,) * event_ndim
        z_shape = (n_chains, *event_shape) if chol is None else (n_chains, chol.shape[0])
        z = torch.randn((*prefix, *z_shape), generator=generator, device=dev)
        w = torch.rand((*prefix, n_chains), generator=generator, device=dev)
        theta0 = torch.randn((*prefix, *expand), generator=generator, device=dev)
        shrink = torch.rand((*prefix, max_iterations, *expand), generator=generator, device=dev)
        return z, w, theta0, shrink

    def tess_step(params, u, lp_u, x_u, draws):
        z, w, theta0, shrink = draws
        v = z.reshape(u.shape) if chol is None else (z @ chol.T).reshape(u.shape)
        log_s = lp_u + log_phi(v) + torch.log(w)
        # the reference's quirk: theta ~ N(0, 1) * 2 pi, not uniform
        theta = theta0 * (2.0 * math.pi)
        theta_min, theta_max = theta - 2.0 * math.pi, theta
        accepted = torch.zeros(lp_u.shape, dtype=torch.bool, device=u.device)
        u_prop, x_prop, lp_prop = u, x_u, lp_u
        expand = accepted.shape + (1,) * event_ndim
        for i in range(max_iterations):
            u_prime = u * torch.cos(theta) + v * torch.sin(theta)
            v_prime = v * torch.cos(theta) - u * torch.sin(theta)
            lp, x_prime = log_pi_hat(params, u_prime)
            newly = ((lp + log_phi(v_prime)) > log_s) & ~accepted
            bmask = newly.reshape(expand)
            u_prop = torch.where(bmask, u_prime, u_prop)
            x_prop = torch.where(bmask, x_prime, x_prop)
            lp_prop = torch.where(newly, lp, lp_prop)
            theta_neg = theta < 0
            theta_min = torch.where(theta_neg, theta, theta_min)
            theta_max = torch.where(theta_neg, theta_max, theta)
            theta = shrink[i] * (theta_max - theta_min) + theta_min
            accepted = accepted | newly
        return x_prop, u_prop, lp_prop, accepted

    return tess_init, tess_step, tess_draws


# the chain axis of each of tess_draws' tensors after the leading dims: the
# shrink uniforms hold the bracket's iterations first
TESS_DRAW_AXES = (0, 0, 0, 1)


def _info(accepted, u_new):
    return StepInfo(n_accepted=accepted.sum().to(torch.int32),
                    diverged=(~torch.isfinite(u_new).all()).to(torch.int32))


class TESS(Sampler):
    multi_rank_chains = True
    # the sampling run's step and the fused warmup's (its refit's rows
    # hoisted): static shapes, a fixed number of bracket rounds, no host read
    graph_capturable = True

    def __init__(self, event_shape, target, negative_log_likelihood,
                 kernel: Optional[TESSKernel] = None, params: Optional[TESSParameters] = None,
                 device=None):
        if kernel is None:
            kernel = TESSKernel(event_shape)
        if params is None:
            params = TESSParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        self.negative_log_likelihood = negative_log_likelihood
        self.kernel.flow.to(self.device)

    @property
    def name(self):
        return "TESS"

    def _make_tess_step(self):
        return make_tess_step(self.kernel.flow, self.negative_log_likelihood, self.event_shape,
                              max_iterations=self.params.max_ess_step_iterations,
                              chol=self.kernel.chol(self.device))

    def _calls_per_iter(self, n_chains: int) -> int:
        return (self.params.max_ess_step_iterations + 1) * n_chains

    def _hoist_per_iter(self, x) -> int:
        """f32 elements of one iteration's draws (over the global chains):
        z, w, theta0 and the shrink uniforms, which outweigh z when the
        event is small."""
        n = self._n_global(x.shape[0])
        return n * (event_size_of(self.event_shape) + 2 + self.params.max_ess_step_iterations)

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        """Alternate a step and a refit of the flow on the step's data-space
        draws, from ``u ~ N(0, I)``; ``x0`` gives only the number of chains."""
        generator = self._generator(generator, seed)
        self.kernel.flow.to(self.device)
        n_chains = self._n_global(x0.shape[0])
        fit_cfg = fixed_effort_fit_config(self.params.flow_fit_kwargs)
        t0 = time.time()
        u0 = self._chain_rows(torch.randn((n_chains, *self.event_shape), generator=generator,
                                          device=self.device), 0)
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        out.statistics.update_elapsed_time(time.time() - t0)
        if fit_cfg is not None:
            self._warmup_fused(u0, out, generator, fit_cfg, show_progress, time_limit_seconds)
        else:
            self._warmup_host(u0, out, generator, show_progress, time_limit_seconds)
        out.kernel = self.kernel
        return out

    def _warmup_host(self, u, out, generator, show_progress, time_limit_seconds):
        flow = self.kernel.flow
        shard = self.chain_shard
        n_chains = self._n_global(u.shape[0])

        def every(v):  # all the chains of v
            return v if shard is None else shard.gather(v, 0)

        tess_init, tess_step, tess_draws = self._make_tess_step()
        stats = out.statistics
        bar = Progress(total=self.params.n_warmup_iterations, desc="[Warmup] TESS",
                       disable=not show_progress)
        for _ in range(self.params.n_warmup_iterations):
            if time_limit_seconds is not None:
                over = stats.elapsed_time_seconds >= time_limit_seconds
                if shard.any(over) if shard is not None else over:
                    break
            t0 = time.time()
            seed_split, seed_fit = self._sub_seeds(generator, 2)
            draws = tess_draws(generator, (1,), n_chains)
            draws = tuple(self._chain_rows(d, 1 + a)[0] for d, a in zip(draws, TESS_DRAW_AXES))
            with torch.no_grad():
                # the flow is refitted every iteration, so lp and x are re-derived
                lp_u, x_u = tess_init(flow.params, u)
                x, u, _lp, accepted = tess_step(flow.params, u, lp_u, x_u, draws)
            # the warmup stores latent draws, as the reference does
            out.running_samples.add(u)
            u_all = every(u)
            stats.expectations.update(u_all)
            n_acc = accepted.sum()
            stats.update_counters(n_target_calls=self._calls_per_iter(n_chains),
                                  n_accepted_trajectories=int(n_acc if shard is None
                                                              else shard.sum(n_acc)),
                                  n_attempted_trajectories=n_chains,
                                  n_divergences=int(not bool(torch.isfinite(u_all).all())))
            x_train, x_val = train_val_split(
                every(x)[None], train_pct=self.params.train_pct,
                max_train_size=self.params.max_train_size,
                max_val_size=self.params.max_val_size, seed=seed_split)
            try:
                flow.fit(x_train, x_val=x_val, **self.params.flow_fit_kwargs, seed=seed_fit,
                         mesh=None if shard is None else shard.mesh)
            except ValueError:
                pass
            stats.update_elapsed_time(time.time() - t0)
            bar.update(1)
        bar.close()

    def _make_warmup_step(self, scan_fit):
        """``make_step(tuning)`` of the fused warmup: ``step(u, params,
        (*tess draws, *rows))`` re-derives ``(log pi^(u), f^{-1}(u))`` under
        the current weights, steps, then refits the flow with ``scan_fit``
        on all the chains' data-space draws (``rows`` its hoisted
        permutations)."""
        shard = self.chain_shard
        tess_init, tess_step, _draws = self._make_tess_step()
        n_tess = len(TESS_DRAW_AXES)

        def make_step(tuning):
            def step(u, params, draws):
                lp_u, x_u = tess_init(params, u)
                x, u_new, _lp, accepted = tess_step(params, u, lp_u, x_u, draws[:n_tess])
                # every rank refits on all the chains, to the same weights
                params = scan_fit(params, all_rows(x, shard), rows=draws[n_tess:])
                return u_new, params, _info(accepted, u_new)

            return step

        return make_step

    def _warmup_fused(self, u0, out, generator, fit_cfg, show_progress, time_limit_seconds):
        """The step and the refit as one iteration of the chunked driver,
        the latent ``u`` its position, the flow's weights its state and the
        refit's rows its second draw source."""
        flow = self.kernel.flow
        shard = self.chain_shard
        n_chains = self._n_global(u0.shape[0])
        n_epochs, lr, batch_size, keep_best_weights, shuffle = fit_cfg
        _init, _step, tess_draws = self._make_tess_step()
        scan_fit = make_scan_fit(flow, n_chains, n_epochs=n_epochs, lr=lr, batch_size=batch_size,
                                 shuffle=shuffle, keep_best_weights=keep_best_weights,
                                 train_pct=self.params.train_pct,
                                 max_train_size=self.params.max_train_size,
                                 max_val_size=self.params.max_val_size)
        (fit_seed,) = self._sub_seeds(generator, 1)
        fit_generator = torch.Generator(device=self.device).manual_seed(fit_seed)
        driver = ChunkedScanDriver(self.event_shape, self._make_warmup_step(scan_fit), tess_draws,
                                   hoist_per_iter=lambda x: (self._hoist_per_iter(x)
                                                             + scan_fit.row_elems),
                                   draw_chain_axes=TESS_DRAW_AXES,
                                   capturable=graphs.declared(self, (flow,)), collective=True)
        _u, params = driver.run(
            u0, flow.params, generator, self.params.n_warmup_iterations, stats=out.statistics,
            samples=out.running_samples, calls_per_iter=self._calls_per_iter(n_chains),
            grads_per_iter=0, collect=self.params.store_samples,
            time_limit_seconds=time_limit_seconds, show_progress=show_progress,
            desc="[Warmup] TESS", shard=shard,
            fit_rows=lambda chunk: scan_fit.draws(fit_generator, chunk))
        flow.params = params

    def _get_driver(self) -> ChunkedScanDriver:
        """The sampling run's driver, memoised across calls: its step bakes
        in the flow's structure, the likelihood, the bracket's rounds and
        the ellipse's covariance (the weights ride in the carried state)."""
        _init, tess_step, tess_draws = self._make_tess_step()
        cov = self.kernel.cov
        flow = self.kernel.flow

        # the position is the data-space x, so the stored draws and the
        # moments need no extra inverse; u and its log pi^ ride in the state
        def make_step(tuning):
            def step(x, kstate, draws):
                params, u, lp_u = kstate
                x_new, u_new, lp_new, accepted = tess_step(params, u, lp_u, x, draws)
                return x_new, (params, u_new, lp_new), _info(accepted, u_new)

            return step

        return self._cached_driver(
            (self.params.max_ess_step_iterations, id(flow.bijection),
             id(self.negative_log_likelihood),
             None if cov is None else hash(np.asarray(cov).tobytes()),
             None if self.chain_shard is None else self.chain_shard.size),
            lambda: ChunkedScanDriver(self.event_shape, make_step, tess_draws,
                                      hoist_per_iter=self._hoist_per_iter,
                                      draw_chain_axes=TESS_DRAW_AXES,
                                      capturable=graphs.declared(self, (flow,))),
            keepalive=(flow.bijection, self.negative_log_likelihood))

    def sample_continue(self, x, **kwargs) -> MCMCOutput:
        """Continue from a data-space draw (what ``sample`` stores): it is
        mapped back to the latent through the flow's forward."""
        flow = self.kernel.flow.to(self.device)
        with torch.no_grad():
            u, _ = flow.bijection.forward_fn(
                flow.params, torch.as_tensor(x, dtype=torch.float32, device=self.device))
        return self.sample(u, **kwargs)

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        """``x0`` is the latent start (the reference's contract)."""
        generator = self._generator(generator, seed)
        flow = self.kernel.flow.to(self.device)
        u0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        n_chains = self._n_global(u0.shape[0])
        out = MCMCOutput(self.event_shape, store_samples=self.params.store_samples,
                         on_device=self.params.store_samples_on_device)
        tess_init, _step, _draws = self._make_tess_step()
        driver = self._get_driver()
        t0 = time.time()
        with torch.no_grad():
            lp0, x0_data = tess_init(flow.params, u0)
        out.statistics.update_elapsed_time(time.time() - t0)
        driver.run(x0_data, (flow.params, u0, lp0), generator, self.params.n_iterations,
                   stats=out.statistics, samples=out.running_samples,
                   calls_per_iter=self._calls_per_iter(n_chains), grads_per_iter=0,
                   collect=self.params.store_samples, time_limit_seconds=time_limit_seconds,
                   show_progress=show_progress, desc="TESS sampling", shard=self.chain_shard)
        out.kernel = self.kernel
        return out

"""Preconditioned Monte Carlo (Karamanis, Beutler, Peacock & Seljak 2022 --
the pocoMC algorithm); counterpart of ``nfmc_tpu/transport/pmc.py``.

The reference lists PMC first among the algorithms "yet to be added"
(``README.md:12-14``). PMC is adaptive-temperature SMC with a
normalizing-flow preconditioner; per level (inverse temperature ``beta``,
path ``u(x, b) = (1-b) u_prior + b u_target``):
  1. choose ``delta`` by bisection (float64 numpy on the host) so the ESS
     of the incremental weights ``exp(-delta * (u_target - u_prior))`` stays
     at ``ess_target * n``;
  2. reweight (``log_Z += logsumexp(log_W + log_g)``) and resample;
  3. fit the flow to the pre-resample weighted cloud (full-batch Adam with
     a held-out fifth and val-selected best weights);
  4. run a preconditioned Crank-Nicolson (pCN) Metropolis sweep in the
     flow's latent space targeting ``pi_beta``: proposals
     ``z' = sqrt(1-rho^2) z + rho xi`` are reversible w.r.t. N(0, I), so
     the accept ratio sees only the residual ``u_lat(z) - ||z||^2/2``;
     ``rho`` adapts toward ``target_acceptance`` by Robbins-Monro on the
     device.
A level copies ``u_target - u_prior`` to the host once and reads the
sweep's acceptance once; the temperature's bisection runs on the host in
float64, as in the JAX package. On CUDA the fit's epochs and the sweep's
pCN steps are replays of two captured graphs (:meth:`_train`,
:meth:`_sweep`), as the JAX package jits each as one ``lax.scan``.

Particles that ``prior_sample`` returns as a DTensor run sharded over its
mesh (:mod:`nfmc_torch.transport.common`): a level gathers
``u_target - u_prior`` and the pre-resample cloud, so the temperature, the
weights and the resample index are the unsharded run's on every rank; the
fit is data-parallel over that cloud (one ``all_reduce`` a step) and the
sweep's acceptance a mean over every particle.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import graphs
from ..core.chains import chain_mean
from ..flows.train import _Adam, _finite_update, _flatten, _resume, _skeleton
from ..ops.coupling import unpack_like
from ..utils import Progress, as_numpy, resolve_device
from .common import (as_level, draw_rows, first_draw, flat_value_and_grad, gathered,
                     resample_offset, systematic_resample, take_particles, tempered)


def _ess_np(log_w: np.ndarray) -> float:
    """ESS (in particle counts) of unnormalized log-weights, host-side."""
    lw = log_w - np.logaddexp.reduce(log_w)
    return float(np.exp(-np.logaddexp.reduce(2.0 * lw)))


class PreconditionedMonteCarlo:
    def __init__(
        self,
        prior_potential: Callable,
        target_potential: Callable,
        flow,
        ess_target: float = 0.9,
        n_mcmc_steps: int = 10,
        target_acceptance: float = 0.65,
        adapt_rate: float = 0.5,
        n_train_epochs: int = 30,
        train_lr: float = 1e-2,
        max_levels: int = 200,
        initial_rho: float = 0.5,
    ):
        self.prior_potential = prior_potential
        self.target_potential = target_potential
        self.flow = flow
        self.ess_target = float(ess_target)
        self.n_mcmc_steps = int(n_mcmc_steps)
        self.target_acceptance = float(target_acceptance)
        self.adapt_rate = float(adapt_rate)
        self.max_levels = int(max_levels)
        self.n_train_epochs = int(n_train_epochs)
        self.train_lr = float(train_lr)
        self.initial_rho = min(max(float(initial_rho), 1e-4), 1.0 - 1e-4)
        self.u = tempered(prior_potential, target_potential)

    @torch.no_grad()
    def _delta_u(self, x):
        return self.target_potential(x) - self.prior_potential(x)

    def _weighted_loss(self, params, x, log_w, shard=None):
        """Self-normalized weighted negative log-likelihood: an estimate of
        ``-E_{pi_beta_new}[log q]`` from the pre-resample weighted cloud
        (every point unique, so the val split is a real holdout). With a
        ``shard``, this rank's share of it, over its rows of ``x``."""
        w = torch.softmax(log_w, 0)
        if shard is not None:
            w, x = shard.rows(w), shard.rows(x)
        return -torch.sum(w * self.flow.log_prob_fn(params, x))

    def _train(self, params, x, log_w, perm, shard=None):
        """The level's preconditioner fit: ``n_train_epochs`` full-batch
        Adam steps (skipped, moments and all, where the loss or a gradient
        is not finite) on four fifths of the rows of ``x[perm]``, the best
        weights by the loss on the other fifth, the tracker seeded with the
        warm-start params' own val loss (so a non-improving fit keeps the
        previous level's preconditioner). Val selection is load-bearing:
        a warm-started fixed-epoch fit overfits small particle sets.
        ``perm`` is a permutation of the rows (:meth:`train_draws`).
        Returns ``(best_params, losses)``.

        The JAX package jits the fit as one ``lax.scan`` over epochs
        (``nfmc_tpu/transport/pmc.py:141-147``). On CUDA, with one rank and
        a bijection that declares ``graph_capturable``, an epoch (the val
        loss, the guarded Adam step, the best-weights tracker) is one replay
        of a captured graph over the split that ``perm`` makes, cached on
        the object; the last val loss is one eager step after the replays.

        With a ``shard`` of several ranks every rank holds the whole cloud
        and trains data-parallel on its rows of each split: one
        ``all_reduce`` a step sums the gradient, the loss and the val loss
        at the same weights (the last weights' val loss alone after the
        loop)."""
        n = x.shape[0]
        n_val = max(n // 5, 1)
        x, log_w = x[perm], log_w[perm]
        graphed = graphs.transport_captures([self.flow.bijection], x.device, shard)
        if graphed:  # a captured fit runs on one rank, where the shares are the sums
            shard = None
        like = _skeleton(params)
        theta = _flatten(params)
        adam = _Adam(theta, self.train_lr)

        def tracked(theta, best, best_val, val):
            with torch.no_grad():
                better = torch.isfinite(val) & (val < best_val)
                return torch.where(better, theta, best), torch.where(better, val, best_val)

        def epoch(carry, consts, rows):
            theta, adam, best, best_val = _resume(carry, self.train_lr)
            x_val, x_train, lw_val, lw_train = consts
            with torch.no_grad():
                val = self._weighted_loss(unpack_like(theta, like), x_val, lw_val, shard)
            loss, g = flat_value_and_grad(
                lambda p: self._weighted_loss(p, x_train, lw_train, shard), theta, like)
            if shard is not None:
                both = shard.sum(torch.cat([g, loss.reshape(1), val.reshape(1)]))
                g, loss, val = both[:-2], both[-2], both[-1]
            best, best_val = tracked(theta, best, best_val, val)
            with torch.no_grad():
                theta = adam.step(theta, g, _finite_update(loss, g))
            return [theta, adam.mu, adam.nu, adam.count, best, best_val], [loss]

        graph_of = None
        if graphed:
            graph_of = graphs.replays(self, ("pmc_fit", self.train_lr), epoch,
                                      [((), torch.float32)], self.n_train_epochs,
                                      (self.flow.bijection,))
        # best_val starts at inf: the first epoch then takes the warm-start
        # val loss where it is finite, as the JAX package's seed does
        carry = [theta, adam.mu, adam.nu, adam.count, theta,
                 torch.full((), math.inf, device=x.device)]
        consts = [x[:n_val], x[n_val:], log_w[:n_val], log_w[n_val:]]
        carry, _, outs = graphs.iterations(epoch, carry, consts, lambda k: [],
                                           self.n_train_epochs, graph_of, self.n_train_epochs)
        theta, _, _, _, best, best_val = carry
        with torch.no_grad():
            val = self._weighted_loss(unpack_like(theta, like), consts[0], consts[2], shard)
        if shard is not None:
            val = shard.sum(val)
        best, _ = tracked(theta, best, best_val, val)
        losses = outs[0] if outs else torch.zeros(0, device=x.device)
        return unpack_like(best.clone(), params), losses

    def train_draws(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=generator, device=generator.device)

    def sweep_draws(self, generator: torch.Generator, shape):
        """The pCN sweep's draws: ``xi`` ``(n_mcmc_steps, *shape)`` and the
        accept uniforms ``(n_mcmc_steps, B)``."""
        dev = generator.device
        return (torch.randn((self.n_mcmc_steps, *shape), generator=generator, device=dev),
                torch.rand((self.n_mcmc_steps, shape[0]), generator=generator, device=dev))

    def _u_lat(self, params, z, beta):
        x, log_det_inv = self.flow.bijection.inverse_fn(params, z)
        return self.u(x, beta) - log_det_inv

    def _sweep(self, params, x, beta, rho_logit, draws, shard=None):
        """The latent pCN sweep at ``beta``: ``(x', rho_logit', mean
        acceptance)``, ``rho_logit`` a 0-d tensor adapted on the device, on
        the acceptance over every particle (with the particles' ``shard``).

        The JAX package jits the sweep as one ``lax.scan`` over its steps
        (``nfmc_tpu/transport/pmc.py:187-193``). On CUDA, with one rank and
        a bijection that declares ``graph_capturable``, a pCN step is one
        replay of a captured graph carrying ``z``, ``u_lat(z)`` and
        ``rho_logit``, ``beta`` a device scalar among its constants, the
        step's ``xi`` and uniforms read at its counter; the map into the
        latent space and back runs eagerly around the replays."""
        xi, uniforms = draws
        graphed = graphs.transport_captures([self.flow.bijection], x.device, shard)
        if graphed:  # on one rank the mean over every particle is this rank's
            shard = None
        like = _skeleton(params)
        theta = _flatten(params)
        beta = as_level(beta, x)

        def half_sumsq(z):
            return 0.5 * (z.reshape(z.shape[0], -1) ** 2).sum(-1)

        def step(carry, consts, rows):
            z, uz, rho_logit = carry
            theta, beta = consts
            xi_i, u_i = rows
            with torch.no_grad():
                rho = torch.sigmoid(rho_logit)
                z_prime = torch.sqrt(1.0 - rho ** 2) * z + rho * xi_i
                uzp = self._u_lat(unpack_like(theta, like), z_prime, beta)
                # pCN accept: only the residual Phi(z) = u_lat(z) - ||z||^2/2
                log_alpha = (uz - half_sumsq(z)) - (uzp - half_sumsq(z_prime))
                # accept-guard semantics per utils.unevaluable_current_mask:
                # a NaN current potential would freeze the particle forever,
                # so it moves to any evaluable proposal (a +inf current
                # already accepts through log_alpha = +inf); non-finite
                # proposals reject
                log_alpha = torch.where(torch.isnan(uz), math.inf, log_alpha)
                log_alpha = torch.where(torch.isfinite(uzp), log_alpha, -math.inf)
                accept = torch.log(u_i) < log_alpha
                mask = accept.reshape(accept.shape + (1,) * (z.dim() - 1))
                z = torch.where(mask, z_prime, z)
                uz = torch.where(accept, uzp, uz)
                acc = chain_mean(accept.to(torch.float32), shard)
                rho_logit = rho_logit + self.adapt_rate * (acc - self.target_acceptance)
            return [z, uz, rho_logit], [acc]

        with torch.no_grad():
            z, _ = self.flow.bijection.forward_fn(params, x)
            uz = self._u_lat(params, z, beta)
        graph_of = None
        if graphed:
            graph_of = graphs.replays(
                self, ("pmc_sweep", self.adapt_rate, self.target_acceptance), step,
                [((), torch.float32)], self.n_mcmc_steps, (self.flow.bijection,))
        (z, _, rho_logit), _, outs = graphs.iterations(
            step, [z, uz, rho_logit], [theta, beta], graphs.sliced([xi, uniforms]),
            self.n_mcmc_steps, graph_of, self.n_mcmc_steps)
        with torch.no_grad():
            x, _ = self.flow.bijection.inverse_fn(params, z)
        acc_mean = outs[0].mean() if outs else torch.full((), math.nan, device=x.device)
        return x, rho_logit.clone(), acc_mean

    # ---- adaptive temperature: largest delta keeping ESS at the target ------
    def _choose_delta(self, delta_u: np.ndarray, log_W: np.ndarray, beta: float) -> float:
        n = delta_u.shape[0]
        target = self.ess_target * n

        def ess(delta: float) -> float:
            return _ess_np(log_W - delta * delta_u)

        hi = 1.0 - beta
        if ess(hi) >= target:
            return hi
        lo = 0.0
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if ess(mid) >= target:
                lo = mid
            else:
                hi = mid
        # lo can only be 0.0 if even infinitesimal steps break the ESS target
        # (pathological weights); force minimal progress so the loop terminates
        return max(lo, (1.0 - beta) / self.max_levels, 1e-6)

    def run(
        self,
        prior_sample: Callable,
        n_particles: int = 100,
        show_progress: bool = False,
        full_output: bool = False,
        generator: Optional[torch.Generator] = None,
        seed: Optional[int] = None,
    ):
        """``prior_sample(batch_shape, generator=...)`` draws the particles
        on the flow's device; a DTensor runs them sharded (module doc)."""
        device = self.flow.get_device()
        g, drawn = first_draw(lambda g: prior_sample((n_particles,), generator=g), device,
                              generator, seed)
        x, shard = take_particles(drawn)
        if shard is not None:
            x = x.to(device)
        log_W = np.full((n_particles,), -math.log(n_particles))
        log_Z = 0.0
        rho_logit = torch.tensor(math.log(self.initial_rho) - math.log1p(-self.initial_rho),
                                 dtype=torch.float32, device=device)
        beta = 0.0
        params = self.flow.params
        beta_trace, ess_trace, acc_trace = [0.0], [], []
        history = [as_numpy(gathered(x, shard))] if full_output else None

        bar = Progress(total=self.max_levels, desc="PMC", disable=not show_progress)
        for _level in range(self.max_levels):
            if beta >= 1.0:
                break
            # 1. adaptive temperature increment
            delta_u = as_numpy(gathered(self._delta_u(x), shard))
            delta = self._choose_delta(delta_u, log_W, beta)
            beta_new = min(1.0, beta + delta)

            # 2. reweight + log-Z increment + resample
            log_w = log_W + (-(beta_new - beta) * delta_u)
            log_Z += float(np.logaddexp.reduce(log_w))
            ess_trace.append(_ess_np(log_w))
            log_w -= np.logaddexp.reduce(log_w)
            lw_dev = torch.as_tensor(log_w, dtype=torch.float32, device=device)
            x_prev = gathered(x, shard)  # the whole cloud: the resample index is global
            x = x_prev[systematic_resample(lw_dev, n_particles, resample_offset(g))]
            if shard is not None:
                x = shard.rows(x)
            log_W = np.full((n_particles,), -math.log(n_particles))

            # 3. fit the preconditioner on the pre-resample weighted cloud
            params, _losses = self._train(params, x_prev, lw_dev,
                                          self.train_draws(g, n_particles), shard)

            # 4. latent-space pCN Metropolis sweep at beta_new
            x, rho_logit, acc = self._sweep(
                params, x, float(np.float32(beta_new)), rho_logit,
                draw_rows(self.sweep_draws(g, (n_particles, *x.shape[1:])), shard), shard)
            acc_trace.append(float(acc))

            beta = beta_new
            beta_trace.append(beta)
            if full_output:
                history.append(as_numpy(gathered(x, shard)))
            bar.update(1)
            if show_progress:
                bar.set_postfix_str(f"beta {beta:.4f}, log Z: {log_Z:.3f}, acc: "
                                    f"{acc_trace[-1]:.2f}")
        bar.close()

        self.flow.params = params
        converged = beta >= 1.0
        if not converged:
            print(
                f"PMC warning: hit max_levels={self.max_levels} at beta={beta:.4f} < 1; "
                "log_Z and particles target the tempered (not final) density"
            )
        result = {
            "particles": as_numpy(gathered(x, shard)),
            "log_weights": log_W,
            "log_Z": log_Z,
            "beta_trace": np.asarray(beta_trace),
            "ess_trace": np.asarray(ess_trace),
            "acceptance_trace": np.asarray(acc_trace),
            "converged": converged,
        }
        if full_output:
            result["history"] = np.stack(history)
        return result


def pmc(prior, target, flow, n_particles: int = 100, show_progress: bool = False,
        seed: int = 0, device=None, **kwargs):
    """Wrapper in the house transport signature (cf. ``aft``/``craft``):
    ``prior``/``target`` are Potentials, ``flow`` a registry name or Flow,
    run on ``device`` (CUDA unless the caller names another)."""
    from ..api.registry import create_flow_object
    from ..flows import Flow as _Flow

    device = resolve_device(device)
    flow_object = flow if isinstance(flow, _Flow) else create_flow_object(flow, prior.event_shape)
    flow_object.to(device)
    algorithm = PreconditionedMonteCarlo(prior, target, flow_object, **kwargs)
    return algorithm.run(
        lambda batch_shape, generator=None: prior.sample(batch_shape, generator=generator),
        n_particles=n_particles, show_progress=show_progress,
        full_output=True, seed=seed,
    )

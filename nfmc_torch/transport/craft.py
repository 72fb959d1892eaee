"""CRAFT: Continual Repeated Annealed Flow Transport (Matthews et al. 2022),
corrected; counterpart of ``nfmc_tpu/transport/craft.py``.

The reference version crashes (it calls ``smc_flow_step`` with a
nonexistent signature; ``annealed_flow_transport.py:355-363``). Here: one
parameter set per annealing level, trained continually over
``n_training_steps`` SMC passes with the per-level loss
``sum_i W_i [ -u_{k-1}(x_i) + u_k(T_k(x_i)) - log|det| ]`` (reference
``:321-329`` modulo its log-det sign), then a final sampling pass. The
transport map is the bijection's ``inverse`` (latent -> data, as flow
sampling).

All levels share one bijection architecture (checked), so every level's
parameters go through level 0's bijection, each level with its own flat
parameter vector and AdamW state. A pass (train step, transport, the
ESS-gated resample and the MALA sweep at every level) is an eager loop over
the levels with no host synchronisation; the JAX package runs it as one
``lax.scan``.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.chains import refuse_sharded
from ..core.rng import resolve_generator
from ..flows.train import _AdamW, _finite_update, _flatten
from ..ops.coupling import unpack_like
from ..utils import Progress, as_numpy, resolve_device, tree_leaves, tree_unflatten
from .common import (flat_value_and_grad, log_ess, make_mala_sweep, resample_offset,
                     systematic_resample, tempered)


def _shapes(params):
    """The tree ``params`` with each tensor replaced by its shape."""
    return tree_unflatten(params, [tuple(t.shape) for t in tree_leaves(params)])


class CRAFT:
    def __init__(
        self,
        prior_potential: Callable,
        target_potential: Callable,
        bijections: List,
        sampling_threshold: float = 0.3,
        n_mcmc_steps: int = 5,
        mcmc_step_size: float = 0.05,
        lr: float = 1e-3,
    ):
        self.prior_potential = prior_potential
        self.target_potential = target_potential
        self.bijections = list(bijections)
        self.n_levels = len(bijections)
        self.sampling_threshold = float(sampling_threshold)
        self.lr = float(lr)
        self.u = tempered(prior_potential, target_potential)
        self.mala_sweep = make_mala_sweep(self.u, n_steps=n_mcmc_steps, step_size=mcmc_step_size)
        # every level's params go through ONE bijection (bijections[0]); a
        # heterogeneous list would silently run every level through level
        # 0's architecture: reject it up front
        shapes0 = _shapes(self.bijections[0].params)
        for i, b in enumerate(self.bijections[1:], start=1):
            if type(b) is not type(self.bijections[0]) or _shapes(b.params) != shapes0:
                raise ValueError(
                    f"CRAFT requires all levels to share one bijection "
                    f"architecture; level {i} differs from level 0"
                )
        n = self.n_levels
        self.lams = [float(v) for v in np.arange(1, n + 1, dtype=np.float32) / np.float32(n)]
        self.lams_prev = [float(v) for v in np.arange(0, n, dtype=np.float32) / np.float32(n)]

    def _loss(self, bij, params, x, w, lam_prev, lam_next):
        x_next, log_det = bij.inverse_fn(params, x)
        d = -self.u(x, lam_prev) + self.u(x_next, lam_next) - log_det
        # a zero-weight particle (w=0) at an unevaluable transported point
        # (d = +-inf) contributes 0 * inf = NaN; its true contribution is 0
        return torch.sum(torch.where(w > 0.0, w * d, 0.0))

    def level_draws(self, generator: torch.Generator, shape):
        """One level's draws: the resample offset and the sweep's draws."""
        return resample_offset(generator), self.mala_sweep.draws(generator, shape)

    def _level(self, k, theta, opt, x, log_W, draws):
        """Level k of a pass: with an optimizer ``opt`` first one AdamW step
        on ``theta`` (skipped, moments and all, where the loss or a gradient
        is not finite), then transport, reweight, the ESS-gated resample and
        the MALA sweep. Returns ``(theta, x, log_W, delta_log_Z)``."""
        bij = self.bijections[0]
        like = bij.params
        lam_prev, lam_next = self.lams_prev[k], self.lams[k]
        offset, sweep_draws = draws
        if opt is not None:
            w = torch.softmax(log_W, 0)
            loss, g = flat_value_and_grad(
                lambda p: self._loss(bij, p, x, w, lam_prev, lam_next), theta, like)
            with torch.no_grad():
                theta = opt.step(theta, g, _finite_update(loss, g))
        with torch.no_grad():
            x_next, log_det = bij.inverse_fn(unpack_like(theta, like), x)
            log_G = self.u(x, lam_prev) - self.u(x_next, lam_next) + log_det
            # inf - inf at consecutive unevaluable levels: the particle's
            # incremental weight is genuinely zero, not NaN
            log_G = torch.where(torch.isnan(log_G), -math.inf, log_G)
            log_w = log_W + log_G
            dlZ = torch.logsumexp(log_w, 0)
            n = log_w.shape[0]
            # degenerate level (every particle unevaluable): uniform reset
            # instead of NaN weights (as aft.py's val-weight guard)
            log_W_new = torch.where(
                torch.isfinite(dlZ),
                torch.where(torch.isfinite(log_w - dlZ), log_w - dlZ, -math.inf),
                -math.log(n))
            # the ESS-gated resample, decided on the device
            do = log_ess(log_w) - math.log(n) <= math.log(self.sampling_threshold)
            idx = torch.where(do, systematic_resample(log_W_new, n, offset),
                              torch.arange(n, device=x.device))
            x_next = x_next[idx]
            log_W_new = torch.where(do, -math.log(n), log_W_new)
        x_next = self.mala_sweep(x_next, lam_next, sweep_draws)
        return theta, x_next, log_W_new, dlZ

    def _pass(self, thetas, opts, x, log_W, draws):
        """One SMC pass over all levels; ``thetas`` (and ``opts``, when
        training) are updated in place. ``draws`` yields each level's
        :meth:`level_draws`. Returns ``(x, log_W, log_Z, xs)`` with ``xs``
        the particles after each level."""
        log_Z = torch.zeros((), device=x.device)
        xs = []
        for k, d in zip(range(self.n_levels), draws):
            thetas[k], x, log_W, dlZ = self._level(k, thetas[k], None if opts is None else opts[k],
                                                   x, log_W, d)
            log_Z = log_Z + dlZ
            xs.append(x)
        return x, log_W, log_Z, xs

    def _pass_draws(self, generator, shape):
        return (self.level_draws(generator, shape) for _ in range(self.n_levels))

    def train(self, prior_sample, n_particles: int = 100, n_training_steps: int = 100,
              show_progress: bool = False, generator: Optional[torch.Generator] = None,
              seed: Optional[int] = None):
        like = self.bijections[0].params
        device = tree_leaves(like)[0].device
        g = resolve_generator(device, generator, seed)
        thetas = [_flatten(b.params) for b in self.bijections]
        opts = [_AdamW(t, self.lr) for t in thetas]

        bar = Progress(total=n_training_steps, desc="CRAFT", disable=not show_progress)
        for _ in range(n_training_steps):
            x = prior_sample((n_particles,), generator=g)
            refuse_sharded("CRAFT", x)
            x = x.to(torch.float32)
            log_W = torch.full((n_particles,), -math.log(n_particles), device=device)
            _, _, log_Z, _ = self._pass(thetas, opts, x, log_W, self._pass_draws(g, x.shape))
            bar.update(1)
            if show_progress:  # the only per-pass synchronisation, opt-in
                bar.set_postfix_str(f"log Z: {float(log_Z):.3f}")
        bar.close()
        for b, t in zip(self.bijections, thetas):
            b.params = unpack_like(t, like)

    def sample(self, prior_sample, n_particles: int = 100,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        like = self.bijections[0].params
        device = tree_leaves(like)[0].device
        g = resolve_generator(device, generator, seed)
        x0 = prior_sample((n_particles,), generator=g)
        refuse_sharded("CRAFT", x0)
        x0 = x0.to(torch.float32)
        log_W = torch.full((n_particles,), -math.log(n_particles), device=device)
        thetas = [_flatten(b.params) for b in self.bijections]
        x, log_W, log_Z, xs = self._pass(thetas, None, x0, log_W, self._pass_draws(g, x0.shape))
        return {
            "particles": as_numpy(x),
            "log_weights": as_numpy(log_W),
            "log_Z": float(log_Z),
            "history": as_numpy(torch.stack([x0, *xs])),
        }


def craft(prior, target, flow, n_particles: int = 100, n_iterations: int = 100,
          n_annealing_steps: int = 20, show_progress: bool = False, seed: int = 0,
          device=None, **kwargs):
    """Wrapper with the reference signature (``transport/wrappers.py:29-49``),
    run on ``device`` (CUDA unless the caller names another)."""
    from ..api.registry import create_flow_object

    device = resolve_device(device)
    bijections = [create_flow_object(flow, prior.event_shape, seed=seed + i).to(device).bijection
                  for i in range(n_annealing_steps)]
    algorithm = CRAFT(prior, target, bijections, **kwargs)
    sample_fn = lambda batch_shape, generator=None: prior.sample(batch_shape, generator=generator)
    algorithm.train(sample_fn, n_particles=n_particles, n_training_steps=n_iterations,
                    show_progress=show_progress, seed=seed)
    return algorithm.sample(sample_fn, n_particles=n_particles, seed=seed + 1)

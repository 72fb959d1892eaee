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
ESS-gated resample and the MALA sweep at every level) reads nothing on the
host; the JAX package runs it as one jitted ``lax.scan`` over the levels
(``nfmc_tpu/transport/craft.py:77-78, 140-175``). On CUDA, with one rank
and a bijection that declares ``graph_capturable``
(:func:`nfmc_torch.core.graphs.transport_captures`), a training pass is one
replay of a captured graph whose body unrolls the levels, their weights
and AdamW moments rows of stacked carried tensors, and the sampling pass a
second graph of the same body without the optimizer; an eager prologue
makes each pass's prior draw and level draws with the run's generator in
the eager loop's order. :func:`~nfmc_torch.core.graphs.disable_graphs` or
several ranks run the same pass as an eager loop, with which the replays
agree bit for bit.

Particles that ``prior_sample`` returns as a DTensor run sharded over its
mesh (:mod:`nfmc_torch.transport.common`): each rank holds its rows and its
rows of every level's draws, made for the global particles; the weights'
softmax and log-sum, the ESS and the resample are global; a training step
sums the ranks' shares of the loss and of its gradient in one
``all_reduce``, so every rank takes the same step. The result holds every
particle on every rank.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import graphs
from ..core.chains import chain_logsumexp, chain_softmax
from ..flows.train import _AdamW, _finite_update, _flatten, _skeleton, _sum_shares
from ..ops.coupling import unpack_like
from ..utils import Progress, as_numpy, resolve_device, tree_leaves, tree_unflatten
from .common import (as_level, draw_rows, first_draw, flat_value_and_grad, gathered, log_ess,
                     make_mala_sweep, resample, resample_offset, take_particles, tempered)


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
        # the levels' weights go through level 0's bijection, unpacked
        # like this shape-only tree (a cached graph's body keeps no weights)
        self._like = _skeleton(self.bijections[0].params)
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

    def _level(self, k, theta, opt, x, log_W, draws, shard=None):
        """Level k of a pass: with an optimizer ``opt`` first one AdamW step
        on ``theta`` (skipped, moments and all, where the loss or a gradient
        is not finite), then transport, reweight, the ESS-gated resample and
        the MALA sweep. Returns ``(theta, x, log_W, delta_log_Z)``. With a
        ``shard``, ``x`` and ``log_W`` are this rank's rows and ``draws`` the
        global particles' (module doc)."""
        bij = self.bijections[0]
        like = self._like
        lam_prev, lam_next = as_level(self.lams_prev[k], x), as_level(self.lams[k], x)
        offset, sweep_draws = draws
        if opt is not None:
            w = chain_softmax(log_W, shard)
            loss, g = flat_value_and_grad(
                lambda p: self._loss(bij, p, x, w, lam_prev, lam_next), theta, like)
            g, loss = _sum_shares(g, loss, shard)
            with torch.no_grad():
                theta = opt.step(theta, g, _finite_update(loss, g))
        with torch.no_grad():
            x_next, log_det = bij.inverse_fn(unpack_like(theta, like), x)
            log_G = self.u(x, lam_prev) - self.u(x_next, lam_next) + log_det
            # inf - inf at consecutive unevaluable levels: the particle's
            # incremental weight is genuinely zero, not NaN
            log_G = torch.where(torch.isnan(log_G), -math.inf, log_G)
            log_w = log_W + log_G
            dlZ = chain_logsumexp(log_w, shard)
            n = log_w.shape[0] if shard is None else shard.n_global(log_w.shape[0])
            # degenerate level (every particle unevaluable): uniform reset
            # instead of NaN weights (as aft.py's val-weight guard)
            log_W_new = torch.where(
                torch.isfinite(dlZ),
                torch.where(torch.isfinite(log_w - dlZ), log_w - dlZ, -math.inf),
                -math.log(n))
            # the ESS-gated resample, decided on the device (from reduced
            # values: the same on every rank)
            do = log_ess(log_w, shard) - math.log(n) <= math.log(self.sampling_threshold)
            x_next = torch.where(do, resample(x_next, log_W_new, offset, shard), x_next)
            log_W_new = torch.where(do, -math.log(n), log_W_new)
        x_next = self.mala_sweep(x_next, lam_next, draw_rows(sweep_draws, shard))
        return theta, x_next, log_W_new, dlZ

    def _pass(self, thetas, opts, x, log_W, draws, shard=None):
        """One SMC pass over all levels; ``thetas`` (and ``opts``, when
        training) are updated in place. ``draws`` yields each level's
        :meth:`level_draws`. Returns ``(x, log_W, log_Z, xs)`` with ``xs``
        the particles after each level (this rank's rows with a
        ``shard``)."""
        log_Z = torch.zeros((), device=x.device)
        xs = []
        for k, d in zip(range(self.n_levels), draws):
            thetas[k], x, log_W, dlZ = self._level(k, thetas[k], None if opts is None else opts[k],
                                                   x, log_W, d, shard)
            log_Z = log_Z + dlZ
            xs.append(x)
        return x, log_W, log_Z, xs

    def _stacked_pass_draws(self, generator, shape):
        """A pass's draws, stacked over the levels in :meth:`level_draws`'
        order: the offsets ``(L,)``, the sweep noise and the uniforms."""
        levels = [self.level_draws(generator, shape) for _ in range(self.n_levels)]
        return (torch.stack([o for o, _ in levels]), torch.stack([d[0] for _, d in levels]),
                torch.stack([d[1] for _, d in levels]))

    @staticmethod
    def _particles(drawn, device):
        """A pass's start from its prior draws: ``(this rank's particles,
        the shard)``."""
        x, shard = take_particles(drawn)
        if shard is not None:
            x = x.to(device)
        return x, shard

    def _pass_step(self, n_particles, shard, train: bool):
        """A pass as the step of :func:`nfmc_torch.core.graphs.iterations`:
        ``rows`` the start ``x0`` and the stacked level draws; training,
        the carry is the levels' stacked flat weights, AdamW moments and
        counts (a row a level) and the output the pass's log Z; sampling,
        the weights are the one constant and the outputs the final
        log-weights, log Z and the particles after each level."""

        def step(carry, consts, rows):
            x0, offsets, noise, uniforms = rows
            log_W = torch.full((x0.shape[0],), -math.log(n_particles), device=x0.device)
            draws = zip(offsets, zip(noise, uniforms))
            if train:
                thetas = list(carry[0].unbind(0))
                opts = [_AdamW.resume(self.lr, *state)
                        for state in zip(carry[1].unbind(0), carry[2].unbind(0),
                                         carry[3].unbind(0))]
                _, _, log_Z, _ = self._pass(thetas, opts, x0, log_W, draws, shard)
                return [torch.stack(thetas), torch.stack([o.mu for o in opts]),
                        torch.stack([o.nu for o in opts]),
                        torch.stack([o.count for o in opts])], [log_Z]
            _, log_W, log_Z, xs = self._pass(list(consts[0].unbind(0)), None, x0, log_W, draws,
                                             shard)
            return [], [log_W, log_Z, torch.stack(xs)]

        return step

    def _graph_of(self, n_particles, train: bool, length: int, outs):
        """The pass's graph (:func:`nfmc_torch.core.graphs.replays`), cached
        on the object: its levels unrolled in one body, the training pass's
        and the sampling pass's two graphs of one shape."""
        return graphs.replays(
            self, ("craft", "train" if train else "sample", n_particles, self.lr,
                   self.sampling_threshold, self.mala_sweep.n_steps, self.mala_sweep.step_size),
            self._pass_step(n_particles, None, train), outs, length,
            (self.bijections[0], self.prior_potential, self.target_potential))

    def train(self, prior_sample, n_particles: int = 100, n_training_steps: int = 100,
              show_progress: bool = False, generator: Optional[torch.Generator] = None,
              seed: Optional[int] = None):
        """``n_training_steps`` training passes, each from new prior draws.
        On CUDA (one rank, a declared bijection) each pass is one replay of
        a captured graph of the pass, the JAX package's one jitted
        ``lax.scan`` over levels (``nfmc_tpu/transport/craft.py:77-78,
        140-175``): the levels unrolled in one body, their weights and AdamW
        moments rows of stacked carried tensors. An eager prologue makes a
        block's prior draws and level draws with the run's generator in the
        eager loop's order; the host reads log Z only for the progress bar."""
        like = self.bijections[0].params
        device = tree_leaves(like)[0].device
        if n_training_steps <= 0:
            return
        draw_prior = lambda g: prior_sample((n_particles,), generator=g)  # noqa: E731
        g, drawn = first_draw(draw_prior, device, generator, seed)
        thetas = torch.stack([_flatten(b.params) for b in self.bijections])
        opt = _AdamW(thetas, self.lr)
        carry = [thetas, opt.mu, opt.nu, torch.zeros(self.n_levels, device=device)]
        x0, shard = self._particles(drawn, device)
        first = [x0]

        def draw(k):
            out = []
            for _ in range(k):
                x = first.pop() if first else self._particles(draw_prior(g), device)[0]
                out.append((x, *self._stacked_pass_draws(g, (n_particles, *x.shape[1:]))))
            return [torch.stack(col) for col in zip(*out)]

        graph_of, length = None, 1
        if graphs.transport_captures(self.bijections[:1], device, shard):
            row = x0.numel() * (1 + self.n_levels * self.mala_sweep.n_steps) + self.n_levels * (
                1 + self.mala_sweep.n_steps * n_particles)
            length = graphs.hoist_length(n_training_steps, row)
            graph_of = self._graph_of(n_particles, True, length, [((), torch.float32)])
        step = self._pass_step(n_particles, shard, True)

        bar = Progress(total=n_training_steps, desc="CRAFT", disable=not show_progress)
        done = 0
        while done < n_training_steps:
            block = min(max(1, length) if show_progress else n_training_steps,
                        n_training_steps - done)
            carry, _, (log_Z,) = graphs.iterations(step, carry, [], draw, block, graph_of,
                                                   length)
            done += block
            bar.update(block)
            if show_progress:  # the only synchronisation, opt-in
                bar.set_postfix_str(f"log Z: {float(log_Z[-1]):.3f}")
        bar.close()
        for b, t in zip(self.bijections, carry[0]):
            b.params = unpack_like(t.clone(), like)

    def sample(self, prior_sample, n_particles: int = 100,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """One sampling pass: on CUDA a replay of a second captured graph,
        the training pass's body without the optimizer (the first call of
        a shape runs it eagerly and a later call replays it), which emits
        the particles after each level."""
        like = self.bijections[0].params
        device = tree_leaves(like)[0].device
        g, drawn = first_draw(lambda g: prior_sample((n_particles,), generator=g), device,
                              generator, seed)
        x0, shard = self._particles(drawn, device)
        thetas = torch.stack([_flatten(b.params) for b in self.bijections])
        inputs = [t.unsqueeze(0) for t in
                  (x0, *self._stacked_pass_draws(g, (n_particles, *x0.shape[1:])))]
        graph_of = None
        if graphs.transport_captures(self.bijections[:1], device, shard):
            n = x0.shape[0]
            graph_of = self._graph_of(n_particles, False, 1, [
                ((n,), torch.float32), ((), torch.float32),
                ((self.n_levels, *x0.shape), torch.float32)])
        _, _, (log_W, log_Z, xs) = graphs.iterations(
            self._pass_step(n_particles, shard, False), [], [thetas], graphs.sliced(inputs), 1,
            graph_of, 1)
        log_W, log_Z, xs = log_W[0], log_Z[0], xs[0]
        return {
            "particles": as_numpy(gathered(xs[-1], shard)),
            "log_weights": as_numpy(gathered(log_W, shard)),
            "log_Z": float(log_Z),
            "history": as_numpy(gathered(torch.cat([x0.unsqueeze(0), xs]), shard, 1)),
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

"""Annealed Importance Sampling (Neal 2001), counterpart of
``nfmc_tpu/transport/ais.py``.

The reference imports ``nfmc.mcmc.ais``, which does not exist
(``flow_annealed_bootstrap.py:4``); this is the real component: a linear
schedule with MALA transitions and importance weights
``log_w = sum_k [u_{k-1}(x_k) - u_k(x_k)]`` accumulated on the device.

On CUDA the levels are replays of one captured graph of a level
(:class:`AnnealChain`), as the JAX package runs them as one jitted
``lax.scan``. A start ``x0`` given as a DTensor placed ``Shard(0)`` over a
mesh's first axis runs sharded (:mod:`nfmc_torch.transport.common`): the
draws are made for the global particles and each rank anneals its rows
with its rows of them. No sum crosses the particles inside the chain, so the ranks meet only
to gather the result: ``(x, log_w)`` of the global shape on every rank.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..core import graphs
from ..core.chains import is_sharded
from ..utils import resolve_device
from .common import draw_rows, gathered, make_mala_sweep, run_generator, take_particles, tempered


class AnnealChain:
    """The AIS annealing loop: ``run(x0, draws) -> (x, log_w)`` over the
    linear schedule ``lam_k = k / n_steps`` (float32, as ``jnp.linspace``)
    with weight increments ``log_w += u(x, lam_prev) - u(x, lam_next)``
    followed by a sweep at the new level. ``draws`` is any iterable of the
    levels' sweep draws, e.g. ``run.draws(generator, x0.shape)``. Shared by
    :func:`make_ais` and FAB's bootstrap round (which anneals toward the
    params-dependent alpha=2 target, its levels unrolled in FAB's own
    graph: :meth:`levels`).

    The counterpart of the JAX package's jitted ``lax.scan`` over levels
    (``nfmc_tpu/transport/ais.py:25-55``): on CUDA (or under
    :func:`~nfmc_torch.core.graphs.without_capture`) the levels are replays
    of one captured graph of a level (:meth:`level`), which reads
    ``(lam_prev, lam_next)`` and the level's sweep draws at its counter;
    the graph is cached on the chain, keyed on the shapes, so that a
    ``make_ais`` closure called again replays it. Under
    :func:`~nfmc_torch.core.graphs.disable_graphs`, on several ranks, or
    inside another graph's body, the same level runs as an eager loop."""

    def __init__(self, u: Callable, sweep, n_steps: int):
        self.u, self.sweep, self.n_steps = u, sweep, int(n_steps)
        self.lambdas = [float(v) for v in np.linspace(0.0, 1.0, self.n_steps + 1,
                                                       dtype=np.float32)]

    def stacked_draws(self, generator: torch.Generator, shape):
        """Every level's sweep draws, made at once: noise ``(n_steps, sweep
        steps, *shape)`` and uniforms ``(n_steps, sweep steps, shape[0])``."""
        n, dev = self.sweep.n_steps, generator.device
        noise = torch.randn((self.n_steps, n, *shape), generator=generator, device=dev)
        uniforms = torch.rand((self.n_steps, n, shape[0]), generator=generator, device=dev)
        return noise, uniforms

    def draws(self, generator: torch.Generator, shape) -> list:
        """Every level's sweep draws (``MALASweep.draws``' layout): the
        levels' rows of :meth:`stacked_draws`."""
        return list(zip(*self.stacked_draws(generator, shape)))

    def level(self, x, log_w, lam_prev, lam_next, draws):
        """One level: the weight increment, then the sweep at ``lam_next``
        (0-d tensors or host floats). Returns ``(x, log_w)``."""
        with torch.no_grad():
            log_w = log_w + self.u(x, lam_prev) - self.u(x, lam_next)
            # out-of-support at BOTH levels gives inf - inf = NaN; the
            # particle's weight is genuinely zero: pin it to -inf so one
            # such particle cannot NaN every logsumexp-based estimate
            log_w = torch.where(torch.isnan(log_w), -math.inf, log_w)
        return self.sweep(x, lam_next, draws), log_w

    def levels(self, x, draws):
        """``(x, log_w)`` of the levels run one after the other from ``x``,
        each ``lam`` filled in as a kernel argument: the loop as one graph's
        body unrolls it (FAB's round)."""
        log_w = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for lam_prev, lam_next, d in zip(self.lambdas[:-1], self.lambdas[1:], draws):
            x, log_w = self.level(x, log_w, lam_prev, lam_next, d)
        return x, log_w

    def __call__(self, x0: torch.Tensor, draws: Iterable):
        """``(x, log_w)`` from the start ``x0``. Sharded (a DTensor ``x0``),
        the rank runs its rows, with its rows of the global ``draws``, on
        the draws' device, and returns the result gathered."""
        x, shard = x0, None
        draws = list(draws)
        if is_sharded(x0):
            x, shard = take_particles(x0)
            draws = [draw_rows(d, shard) for d in draws]
            if draws:
                x = x.to(draws[0][0].device)
        n = min(self.n_steps, len(draws))
        lams = torch.tensor(self.lambdas, dtype=torch.float32).to(x.device)
        log_w = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        if n and graphs.transport_captures([], x.device, shard) and not graphs.in_body():
            noise = torch.stack([d[0] for d in draws[:n]])
            uniforms = torch.stack([d[1] for d in draws[:n]])

            def step(carry, consts, rows):
                return list(self.level(*carry, *rows[:2], rows[2:])), []

            length = graphs.hoist_length(n, noise[0].numel() + uniforms[0].numel())
            graph_of = graphs.replays(self, ("anneal_chain",), step, [], length)
            (x, log_w), _, _ = graphs.iterations(
                step, [x, log_w], [], graphs.sliced([lams[:n], lams[1:n + 1], noise, uniforms]),
                n, graph_of, length)
            x, log_w = x.clone(), log_w.clone()  # the static buffers' next run overwrites them
        else:
            for k, d in enumerate(draws[:n]):
                x, log_w = self.level(x, log_w, lams[k], lams[k + 1], d)
        return gathered(x, shard), gathered(log_w, shard)


def anneal_chain(u: Callable, sweep, n_steps: int) -> AnnealChain:
    """The AIS annealing loop as one callable (:class:`AnnealChain`)."""
    return AnnealChain(u, sweep, n_steps)


def make_ais(prior_potential: Callable, target_potential: Callable,
             n_steps: int = 10, n_mcmc_steps: int = 3, step_size: float = 0.05) -> AnnealChain:
    """``ais(x0, draws) -> (x, log_w)`` where ``x0 ~ prior`` and ``draws =
    ais.draws(generator, x0.shape)``."""
    u = tempered(prior_potential, target_potential)
    sweep = make_mala_sweep(u, n_steps=n_mcmc_steps, step_size=step_size)
    return anneal_chain(u, sweep, n_steps)


def ais_base(x0, prior_potential, target_potential, n_steps: int = 10,
             n_mcmc_steps: int = 3, step_size: float = 0.05,
             generator: Optional[torch.Generator] = None, seed: Optional[int] = None,
             device=None):
    """Convenience one-shot form (reference-style signature): ``(x, log_w)``
    on ``device`` (CUDA unless the caller names another); a DTensor ``x0``
    runs sharded, its draws those of the global particles (from the first
    rank's seed when none is given)."""
    device = resolve_device(device)
    mesh = x0.device_mesh if is_sharded(x0) else None
    if mesh is None:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=device)
    g = run_generator(device, generator, seed, mesh)
    run = make_ais(prior_potential, target_potential, n_steps, n_mcmc_steps, step_size)
    return run(x0, run.draws(g, tuple(x0.shape)))

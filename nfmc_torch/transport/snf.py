"""Stochastic Normalizing Flows (Wu, Koehler & Noe 2020), corrected;
counterpart of ``nfmc_tpu/transport/snf.py``.

The reference's layered design (``transport/stochastic_normalizing_flows.py``)
crashes in its MCMC layers (it calls the modules ``hmc``/``mh`` as
functions, ``:72-87``). Here: alternating stochastic (MALA / HMC / MH) and
deterministic (flow) layers over a linear annealing schedule; ``inverse``
(latent -> data) accumulates per-layer log-weight increments ``delta_s`` and
returns ``log_w = -u_target(x) + u_prior(z) + sum delta_s``; training
maximizes ``E[log_w]`` by AdamW on the flow layers' parameters.

Layer weight increments:
* MALA layer (unadjusted Langevin): the exact path-ratio term
  ``delta_s = -0.5 (|eta~|^2 - |eta|^2)`` with
  ``eta~ = sqrt(eps/2)(grad U(x) + grad U(x')) - eta`` (reference ``:25-51``);
* Metropolis-corrected layers at the level potential: detailed balance gives
  ``delta_s = u(x') - u(x)``.

The loss is differentiated with respect to the flow parameters THROUGH the
stochastic layers that follow a flow layer, whose Langevin and leapfrog
steps use grad U: d loss / d theta contains the potential's Hessian. So the
layers take grad U with ``create_graph=True`` whenever their input carries a
graph to the parameters (:func:`_grad_u`); ``utils.batched_grad`` detaches
its input and would drop that term without an error. Only the potential is
differentiated twice: the flow layers' coupling kernel is differentiated
once, through its VJP kernel.

Each stochastic layer takes its random numbers as tensors
(``layer.draws(generator, shape)``).

A latent batch ``z`` given as a DTensor placed ``Shard(0)`` over a mesh's
first axis runs sharded (:mod:`nfmc_torch.transport.common`): every layer's
draws are made for the global batch and each rank keeps its rows of them
(``layer.draw_axis``, their particle axis). ``inverse`` has no sum across
particles and returns its result gathered; ``fit``'s loss is each rank's sum
of ``-log_w`` over its rows divided by the global count, summed over the
ranks with the gradient in one ``all_reduce`` a step, so every rank takes
(or skips) the same step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.chains import is_sharded
from ..core.rng import resolve_generator
from ..flows.train import _AdamW, _finite_update, _flatten, _sum_shares
from ..ops.coupling import unpack_like
from ..utils import (Progress, as_numpy, batched_grad, resolve_device, sum_except_batch,
                     tree_leaves, tree_map)
from .common import (draw_rows, flat_value_and_grad, gathered, run_generator, take_particles,
                     tempered)


def _grad_u(potential: Callable, x: torch.Tensor) -> torch.Tensor:
    """grad U(x), kept differentiable in ``x`` (second order in U) when
    ``x`` carries a graph and grad mode is on; else detached."""
    if torch.is_grad_enabled() and x.requires_grad:
        (g,) = torch.autograd.grad(potential(x).sum(), x, create_graph=True)
        return g
    return batched_grad(potential)(x)


class SNFLayer:
    has_params = False
    # the particle axis of the layer's draws
    draw_axis = 1

    def init(self, generator):
        return ()

    def draws(self, generator: torch.Generator, shape):
        return None

    def apply(self, params, x, potential: Callable, draws):
        """Returns (x', delta_s)."""
        raise NotImplementedError


class MALALayer(SNFLayer):
    draw_axis = 0

    def __init__(self, event_shape, time_step: float = 1.0, friction: float = 1.0,
                 mass: float = 1.0, beta: float = 1.0):
        self.event_shape = tuple(event_shape)
        self.beta = float(beta)
        self.eps = float(time_step / (friction * mass))

    def draws(self, generator, shape):
        return torch.randn(tuple(shape), generator=generator, device=generator.device)

    def apply(self, params, x, potential, draws):
        eta = draws
        g_x = _grad_u(potential, x)
        x_prime = x - self.eps * g_x + math.sqrt(2.0 * self.eps / self.beta) * eta
        g_xp = _grad_u(potential, x_prime)
        # backward noise solves x = x' - eps*g_xp + sqrt(2 eps/beta) eta~:
        # eta~ = sqrt(eps*beta/2) (g_x + g_xp) - eta  (beta enters the sqrt)
        eta_tilde = math.sqrt(self.eps * self.beta / 2.0) * (g_x + g_xp) - eta
        delta_s = -0.5 * (sum_except_batch(eta_tilde ** 2, self.event_shape)
                          - sum_except_batch(eta ** 2, self.event_shape))
        return x_prime, delta_s


def _metropolis_draws(generator, shape, n_steps):
    """``n_steps`` steps' normals ``(n_steps, *shape)`` and accept uniforms
    ``(n_steps, B)``."""
    dev = generator.device
    return (torch.randn((n_steps, *shape), generator=generator, device=dev),
            torch.rand((n_steps, shape[0]), generator=generator, device=dev))


class HMCLayer(SNFLayer):
    """A few Metropolis-adjusted HMC steps at the level potential."""

    def __init__(self, event_shape, n_steps: int = 3, n_leapfrog: int = 10,
                 step_size: float = 0.1):
        self.event_shape = tuple(event_shape)
        self.n_steps = int(n_steps)
        self.n_leapfrog = int(n_leapfrog)
        self.step_size = float(step_size)

    def draws(self, generator, shape):
        return _metropolis_draws(generator, shape, self.n_steps)

    def apply(self, params, x, potential, draws):
        momenta, uniforms = draws
        x0 = x
        h = self.step_size
        for i in range(self.n_steps):
            p = momenta[i]
            xq, pq, gq = x, p, _grad_u(potential, x)
            for _ in range(self.n_leapfrog):
                pq = pq - 0.5 * h * gq
                xq = xq + h * pq
                gq = _grad_u(potential, xq)
                pq = pq - 0.5 * h * gq
            h0 = potential(x) + 0.5 * sum_except_batch(p ** 2, self.event_shape)
            h1 = potential(xq) + 0.5 * sum_except_batch(pq ** 2, self.event_shape)
            accept = torch.log(uniforms[i]) < h0 - h1
            mask = accept.reshape(accept.shape + (1,) * (x.dim() - 1))
            x = torch.where(mask, xq, x)
        # Metropolis-corrected kernel at this level: delta_s = u(x') - u(x)
        return x, potential(x) - potential(x0)


class MHLayer(SNFLayer):
    def __init__(self, event_shape, n_steps: int = 5, step_size: float = 0.2):
        self.event_shape = tuple(event_shape)
        self.n_steps = int(n_steps)
        self.step_size = float(step_size)

    def draws(self, generator, shape):
        return _metropolis_draws(generator, shape, self.n_steps)

    def apply(self, params, x, potential, draws):
        normals, uniforms = draws
        x0 = x
        for i in range(self.n_steps):
            x_prime = x + self.step_size * normals[i]
            accept = torch.log(uniforms[i]) < potential(x) - potential(x_prime)
            mask = accept.reshape(accept.shape + (1,) * (x.dim() - 1))
            x = torch.where(mask, x_prime, x)
        return x, potential(x) - potential(x0)


class FlowLayer(SNFLayer):
    has_params = True

    def __init__(self, bijection):
        self.bijection = bijection
        self.event_shape = bijection.event_shape

    def init(self, generator):
        return self.bijection.init(generator)

    def apply(self, params, x, potential, draws):
        # latent -> data direction; delta_s = log|det d x'/d x|
        return self.bijection.inverse_fn(params, x)


class SNF:
    """Parameters are drawn on the CPU from ``seed`` (the same on every
    device) and moved to ``device`` (CUDA unless the caller names another)."""

    def __init__(self, layers: Sequence[SNFLayer], target_potential: Callable,
                 prior_potential: Callable, generator: Optional[torch.Generator] = None,
                 seed: Optional[int] = None, device=None):
        if not layers:
            raise ValueError("SNF needs at least one layer")
        self.layers = list(layers)
        self.target_potential = target_potential
        self.prior_potential = prior_potential
        self.device = resolve_device(device)
        g = resolve_generator("cpu", generator, seed)
        self.params = tree_map(lambda t: t.to(self.device), [l.init(g) for l in self.layers])
        n = len(self.layers)
        self.lambdas = [float(v) for v in np.linspace(1.0 / n, 1.0, n, dtype=np.float32)]
        self.u = tempered(prior_potential, target_potential)

    def draws(self, generator: torch.Generator, shape):
        """Every layer's draws for a batch of ``shape``."""
        return [layer.draws(generator, shape) for layer in self.layers]

    def _inverse_impl(self, params, z, draws):
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        x = z
        history = [x]
        # endpoint-safe tempered potential: the last layer sits at lam = 1
        # exactly, where (1-lam) * prior would give 0 * inf = NaN for
        # hard-support priors
        for layer, p, lam, d in zip(self.layers, params, self.lambdas, draws):
            x, delta_s = layer.apply(p, x, lambda v, _lam=lam: self.u(v, _lam), d)
            log_det = log_det + delta_s
            history.append(x)
        log_weights = -self.target_potential(x) + self.prior_potential(z) + log_det
        return torch.stack(history), x, log_weights

    def _batch(self, z):
        """``(this rank's rows of z on the device, its shard)``; the shard
        None for a plain batch."""
        if is_sharded(z):
            z, shard = take_particles(z)
            return z.to(self.device), shard
        return torch.as_tensor(z, dtype=torch.float32, device=self.device), None

    def _generator(self, generator, seed, shard):
        """The run's generator: with no seed on a sharded batch, the first
        rank's (:func:`nfmc_torch.transport.common.run_generator`)."""
        return run_generator(self.device, generator, seed, None if shard is None else shard.mesh)

    def _draws(self, generator, z, shard):
        """Every layer's draws for the global batch, this rank's rows of
        them."""
        shape = tuple(z.shape) if shard is None else (shard.n_global(z.shape[0]), *z.shape[1:])
        draws = self.draws(generator, shape)
        if shard is None:
            return draws
        return [draw_rows(d, shard, layer.draw_axis) for layer, d in zip(self.layers, draws)]

    def inverse(self, z, generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None):
        """``(history, x, log_weights)`` of the latent batch ``z`` (gathered
        when ``z`` is sharded)."""
        z, shard = self._batch(z)
        g = self._generator(generator, seed, shard)
        with torch.no_grad():
            history, x, log_w = self._inverse_impl(self.params, z, self._draws(g, z, shard))
        return gathered(history, shard, 1), gathered(x, shard), gathered(log_w, shard)

    def _loss(self, params, z, draws, shard=None):
        """``-mean(log_w)`` over the batch; with a ``shard``, this rank's
        share of it: its rows' sum over the global count."""
        _, _, log_w = self._inverse_impl(params, z, draws)
        if shard is None or shard.size == 1:
            return -torch.mean(log_w)
        return -log_w.sum() / shard.n_global(log_w.shape[0])

    def fit(self, z, n_epochs: int = 10, show_progress: bool = False,
            generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """AdamW (``optax.adamw(1e-3)``) on the flow layers' parameters; an
        epoch whose loss or any gradient is not finite is skipped on the
        host (a divergent leapfrog would otherwise NaN the parameters and
        the moments for good). Sharded, that is decided on the values
        summed over the ranks. ``loss_trace`` keeps each epoch's loss, on
        the device (summed over the ranks: the unsharded run's loss)."""
        z, shard = self._batch(z)
        g = self._generator(generator, seed, shard)
        like = self.params
        if not tree_leaves(like):
            return
        theta = _flatten(like)
        opt = _AdamW(theta, 1e-3)
        losses = []
        bar = Progress(total=n_epochs, desc="SNF", disable=not show_progress)
        for _ in range(n_epochs):
            draws = self._draws(g, z, shard)
            loss, grad = flat_value_and_grad(lambda p: self._loss(p, z, draws, shard), theta, like)
            grad, loss = _sum_shares(grad, loss, shard)
            losses.append(loss)
            bar.update(1)
            if not bool(_finite_update(loss, grad)):
                continue
            with torch.no_grad():
                theta = opt.step(theta, grad)
        bar.close()
        self.params = unpack_like(theta, like)
        self.loss_trace = torch.stack(losses) if losses else torch.zeros(0, device=self.device)


def snf(prior, target, flow: str = "realnvp", n_particles: int = 100,
        n_epochs: int = 10, show_progress: bool = False, seed: int = 0, device=None, **kwargs):
    """Wrapper with the reference signature (``transport/wrappers.py:61-69``):
    an HMC + RealNVP alternating stack, run on ``device`` (CUDA unless the
    caller names another)."""
    from ..flows import RealNVP

    event_shape = prior.event_shape
    model = SNF(
        layers=[
            HMCLayer(event_shape),
            FlowLayer(RealNVP(event_shape, n_layers=2)),
            HMCLayer(event_shape),
            FlowLayer(RealNVP(event_shape, n_layers=2)),
            HMCLayer(event_shape),
        ],
        target_potential=target,
        prior_potential=prior,
        seed=seed,
        device=device,
    )
    dev = model.device
    z = prior.sample((n_particles,), generator=torch.Generator(device=dev).manual_seed(seed + 1))
    model.fit(z, n_epochs=n_epochs, show_progress=show_progress, seed=seed + 2)
    # evaluate on FRESH prior draws: the training batch's weights are
    # optimistically biased (the loss maximized E[log w] on exactly that z)
    z_eval = prior.sample((n_particles,), generator=torch.Generator(device=dev).manual_seed(seed + 4))
    history, x, log_w = model.inverse(z_eval, seed=seed + 3)
    return {
        "history": as_numpy(history),
        "particles": as_numpy(x),
        "log_weights": as_numpy(log_w),
        "model": model,
    }

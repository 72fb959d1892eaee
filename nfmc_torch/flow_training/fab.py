"""FAB: Flow Annealed importance sampling Bootstrap (Midgley et al. 2023),
corrected; counterpart of ``nfmc_tpu/flow_training/fab.py``.

The reference version cannot run (it imports the nonexistent
``nfmc.mcmc.ais``, ``flow_annealed_bootstrap.py:4``; its wrapper calls
``create_flow_object`` without an event shape). Per iteration: (1) draw from
the flow and run AIS from ``q`` toward the alpha=2 optimal target
``p^2 / q`` (potential ``2 U(x) + log q(x)``), (2) push particles and
weights into a prioritized replay buffer, (3) take gradient steps on
``-E_w[ log q(x) ]`` over buffer draws with importance correction
``w_corr = q_old(x) / q_new(x)``, updating the buffered weights/densities.

The replay buffer lives on the device and persists on the object across
``run()`` calls (the reference's object-held ring buffer), with either path
below; its write position and fill count are 0-d int64 device tensors,
carried as the JAX package carries its ``int32`` ones. An iteration reads
nothing on the host. The JAX package runs a block of iterations as one
jitted ``lax.scan`` (``nfmc_tpu/flow_training/fab.py:108-207``); here, on
CUDA with a flow whose bijection declares ``graph_capturable`` (RealNVP,
the coupling splines: :func:`nfmc_torch.core.graphs.transport_captures`),
an iteration is one replay of a captured CUDA graph: the AIS round with its
levels unrolled, the sanitised ring write, the ``n_flow_training_steps``
replay steps and the reported loss, written at the graph's counter, over
static buffers that carry the weights, AdamW's moments and count and the
buffer. An eager prologue makes a block's draws (the base draws, the
levels' sweep draws and the replay steps' Gumbel noise) from the run's
generator in the eager loop's order, the block capped at
``RNG_HOIST_ELEMENT_LIMIT`` hoisted elements; the loss trace stays on the
device. :func:`~nfmc_torch.core.graphs.disable_graphs`, a flow without the
declaration or a mesh of several ranks runs the same iteration as an eager
loop, with which the replays agree bit for bit. Prioritized replay draws
are Gumbel-max
(``argmax(logits + Gumbel)``, ``jax.random.categorical``'s own draw) over
the buffered log-weights: no ``torch.multinomial``, which raises on an
all-zero row and checks on the host.

A flow whose parameters are replicated over a mesh
(:func:`nfmc_torch.parallel.replicate`), the one input of FAB that the JAX
package places on a mesh, runs on each rank's copy: GSPMD runs that
package's jitted iteration replicated, and so every rank here runs the
unsharded run, with the same generator (the first rank's seed when none is
given) and kernels, on plain tensors. The trained parameters come back
replicated over the same mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import graphs
from ..core.chains import ChainShard, on_local_copy
from ..flows.train import _AdamW, _finite_update, _flatten, _skeleton
from ..ops.coupling import unpack_like
from ..transport.ais import anneal_chain
from ..transport.common import categorical, gumbel, make_mala_sweep, run_generator, tempered
from ..utils import Progress, resolve_device


class FAB:
    def __init__(self, target_potential, flow, buffer_size: int = 10_000,
                 n_ais_steps: int = 8, ais_step_size: float = 0.05, lr: float = 3e-3,
                 n_mcmc_steps: int = 3):
        self.target_potential = target_potential
        self.flow = flow
        self.event_shape = flow.event_shape
        self.buffer_size = int(buffer_size)
        self.lr = float(lr)
        self.n_ais_steps = int(n_ais_steps)
        self.ais_step_size = float(ais_step_size)
        self.n_mcmc_steps = int(n_mcmc_steps)

    def _anneal(self, params):
        """The AIS chain from q toward p^2/q at ``params``: the shared
        annealing loop of transport/ais.py, tempering ``-log q`` into ``2 U
        + log q``. One evaluation of ``log q`` serves both ends (JAX's
        ``tempered`` evaluates it once for each: the same numbers)."""
        flow, target = self.flow, self.target_potential

        def u(v, lam):
            log_q = flow.log_prob_fn(params, v)
            return tempered(lambda _: -log_q, lambda _: 2.0 * target(v) + log_q)(v, lam)

        sweep = make_mala_sweep(u, n_steps=self.n_mcmc_steps, step_size=self.ais_step_size)
        return anneal_chain(u, sweep, self.n_ais_steps)

    def _stacked_ais_draws(self, generator: torch.Generator, n_particles: int):
        """An AIS round's draws: the base draw ``(n, *event)``, then every
        level's sweep noise and uniforms, stacked over the levels."""
        z = self.flow.sample_base_fn(generator, n_particles)
        return (z, *self._anneal(None).stacked_draws(generator, (n_particles, *self.event_shape)))

    def ais_draws(self, generator: torch.Generator, n_particles: int):
        """An AIS round's draws: the base draw ``(n, *event)`` and each
        level's sweep draws."""
        z, noise, uniforms = self._stacked_ais_draws(generator, n_particles)
        return z, list(zip(noise, uniforms))

    def _ais_round(self, params, draws):
        """``(x, log_w, log q(x))`` of one AIS round from the base draw, its
        levels unrolled (:meth:`AnnealChain.levels`). The pre-AIS log q is
        not used: the buffer stores the flow density of the post-AIS
        particles."""
        z, level_draws = draws
        with torch.no_grad():
            x, _ = self.flow.push_base_fn(params, z)
        x, log_w = self._anneal(params).levels(x, level_draws)
        with torch.no_grad():
            return x, log_w, self.flow.log_prob_fn(params, x)

    def _train_step(self, theta, opt, like, x, log_q_old, enabled):
        """One AdamW step on ``-mean(w_corr * log q_new)``; ``enabled``
        False (a 0-d bool tensor) vetoes the update outright, as does a
        non-finite loss or gradient. Returns ``(theta, loss, log q_new)``."""
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            log_q_new = self.flow.log_prob_fn(unpack_like(th, like), x)
            w_corr = torch.exp(torch.clamp(log_q_old - log_q_new.detach(), -10.0, 10.0))
            loss = -torch.mean(w_corr * log_q_new)
            (g,) = torch.autograd.grad(loss, th)
        loss = loss.detach()
        with torch.no_grad():
            theta = opt.step(theta, g, _finite_update(loss, g) & enabled)
        return theta, loss, log_q_new.detach()

    def _init_buffer(self, device):
        """The empty replay buffer: rows, log-weights, log-densities, and
        the write position and fill as 0-d int64 device tensors (the JAX
        package's ``int32`` carries)."""
        size = self.buffer_size
        return (torch.zeros((size, *self.event_shape), dtype=torch.float32, device=device),
                torch.zeros((size,), dtype=torch.float32, device=device),
                torch.zeros((size,), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def iteration_draws(self, generator: torch.Generator, n_flow_training_steps: int,
                        n_ais_particles: int, n_training_particles: int):
        """One iteration's draws: the AIS round's and the replay steps'
        Gumbel noise ``(n_flow_training_steps, n_training_particles,
        buffer_size)``."""
        return (self.ais_draws(generator, n_ais_particles),
                gumbel(generator, (n_flow_training_steps, n_training_particles,
                                   self.buffer_size)))

    def _iteration(self, theta, opt, like, buf_state, draws):
        """One bootstrap iteration on the carried (theta, optimizer, replay
        buffer): an AIS round into the buffer, then the replay steps.
        Returns ``(theta, buf_state, reported loss)``."""
        ais_draws, replay_noise = draws
        buf_state = self._fill(unpack_like(theta, like), buf_state, ais_draws)
        return self._replay(theta, opt, like, buf_state, replay_noise)

    def _fill(self, params, buf_state, ais_draws):
        """An AIS round at ``params`` written into the ring buffer, in
        place; the write position and the fill advance on the device."""
        buf_x, buf_lw, buf_lq, index, filled = buf_state
        x, log_w, log_q = self._ais_round(params, ais_draws)
        n = x.shape[0]
        with torch.no_grad():
            # sanitize BEFORE the buffer write: a divergent AIS round (NaN
            # weight/position/density) would poison the replay logits. Bad
            # rows get weight -inf (never drawn) and zeroed positions and
            # densities.
            row_ok = (torch.isfinite(x.reshape(n, -1)).all(-1) & torch.isfinite(log_w)
                      & torch.isfinite(log_q))
            x = torch.where(row_ok.reshape((-1,) + (1,) * len(self.event_shape)), x, 0.0)
            log_w = torch.where(row_ok, log_w, -math.inf)
            log_q = torch.where(row_ok, log_q, 0.0)
            # ring-buffer write (a leading-axis scatter), as JAX's .at[pos]
            pos = (index + torch.arange(n, device=x.device)) % self.buffer_size
            buf_x[pos], buf_lw[pos], buf_lq[pos] = x, log_w, log_q
            index = (index + n) % self.buffer_size
            filled = (filled + n).clamp_max(self.buffer_size)
        return buf_x, buf_lw, buf_lq, index, filled

    def _replay(self, theta, opt, like, buf_state, replay_noise):
        """The prioritized replay steps on the buffer, one a noise draw (a
        row of ``replay_noise``): ``(theta, buf_state, the reported loss)``."""
        buf_x, buf_lw, buf_lq, index, filled = buf_state
        with torch.no_grad():
            valid = torch.arange(self.buffer_size, device=buf_lw.device) < filled
        losses = []
        for noise in replay_noise:
            with torch.no_grad():
                logits = torch.where(valid, buf_lw, -math.inf)
                # no finite-weight row to draw from (e.g. a fully divergent
                # first AIS round): the Gumbel-max over all -inf logits
                # degenerates to index 0, the zeroed placeholder row, and
                # training would drag the flow toward a point mass at the
                # origin. Veto the whole step instead.
                any_valid = (logits > -math.inf).any()
                idx = categorical(logits, noise)
                lq_old = buf_lq[idx]
            theta, loss, lq_new = self._train_step(theta, opt, like, buf_x[idx], lq_old, any_valid)
            with torch.no_grad():
                # importance-correct the buffered weights/densities. Rows
                # whose density under the new params is not finite get
                # weight -inf (never drawn again). Duplicate indices write
                # the same value each time (each is a function of its row),
                # as JAX's .at[idx].set does.
                upd_ok = any_valid & torch.isfinite(lq_new)
                old_lw = buf_lw[idx]
                buf_lw[idx] = torch.where(upd_ok, old_lw + lq_old - lq_new,
                                          torch.where(any_valid, -math.inf, old_lw))
                buf_lq[idx] = torch.where(upd_ok, lq_new, torch.where(any_valid, 0.0, lq_old))
                losses.append(torch.where(any_valid, loss, math.nan))  # NaN marks a skip
        # nanmean: vetoed steps drop out of the reported loss; an iteration
        # with every step vetoed reports NaN, an empty scan 0
        loss_rep = (torch.nanmean(torch.stack(losses)) if losses
                    else torch.zeros((), device=theta.device))
        return theta, (buf_x, buf_lw, buf_lq, index, filled), loss_rep

    def run(self, n_iterations: int = 50, n_flow_training_steps: int = 20,
            n_ais_particles: int = 100, n_training_particles: int = 50,
            show_progress: bool = False, generator: Optional[torch.Generator] = None,
            seed: Optional[int] = None):
        if n_iterations > 0 and n_ais_particles > self.buffer_size:
            # the ring write pos = (index + arange(n)) % size would wrap and
            # overwrite rows within one round (== size is a legal full-buffer
            # write)
            raise ValueError(
                f"n_ais_particles ({n_ais_particles}) exceeds buffer_size "
                f"({self.buffer_size}); one AIS round would overwrite its own rows"
            )
        with on_local_copy(self.flow) as mesh:
            device = self.flow.get_device()
            return self._run(n_iterations, n_flow_training_steps, n_ais_particles,
                             n_training_particles, show_progress,
                             run_generator(device, generator, seed, mesh),
                             None if mesh is None else ChainShard(mesh))

    def _run(self, n_iterations, n_flow_training_steps, n_ais_particles, n_training_particles,
             show_progress, g, shard=None):
        device = self.flow.get_device()
        like = _skeleton(self.flow.params)
        theta = _flatten(self.flow.params)
        opt = _AdamW(theta, self.lr)
        # the replay buffer persists across run() calls (reference parity:
        # the ring buffer lives on the object, flow_annealed_bootstrap.py:9-26)
        buf_state = getattr(self, "_buf_state", None)
        if buf_state is None:
            buf_state = self._init_buffer(device)
        sizes = (int(n_flow_training_steps), int(n_ais_particles), int(n_training_particles))

        def step(carry, consts, rows):
            theta, mu, nu, count, *buf = carry
            z, noise, uniforms, replay_noise = rows
            opt = _AdamW.resume(self.lr, mu, nu, count)
            theta, buf, loss = self._iteration(theta, opt, like, tuple(buf),
                                               ((z, list(zip(noise, uniforms))), replay_noise))
            return [theta, opt.mu, opt.nu, opt.count, *buf], [loss]

        def draw(k):
            its = [(*self._stacked_ais_draws(g, sizes[1]),
                    gumbel(g, (sizes[0], sizes[2], self.buffer_size))) for _ in range(k)]
            return [torch.stack(col) for col in zip(*its)]

        graph_of, length = None, 1
        if graphs.transport_captures([self.flow.bijection], device, shard):
            row = (sizes[1] * (1 + self.n_ais_steps * self.n_mcmc_steps)
                   * int(np.prod(self.event_shape)) + self.n_ais_steps * self.n_mcmc_steps
                   * sizes[1] + sizes[0] * sizes[2] * self.buffer_size)
            length = graphs.hoist_length(n_iterations, row)
            graph_of = graphs.replays(
                self, ("fab", sizes, self.buffer_size, self.lr, self.n_ais_steps,
                       self.n_mcmc_steps, self.ais_step_size), step, [((), torch.float32)],
                length, (self.flow.bijection, self.flow._base_log_prob_override,
                         self.target_potential))

        carry = [theta, opt.mu, opt.nu, opt.count, *buf_state]
        losses = []
        bar = Progress(total=n_iterations, desc="FAB", disable=not show_progress)
        done = 0
        while done < n_iterations:
            # a block of replays between progress updates (one when silent)
            block = min(max(1, length) if show_progress else n_iterations, n_iterations - done)
            carry, _, outs = graphs.iterations(step, carry, [], draw, block, graph_of, length)
            losses.append(outs[0])
            done += block
            bar.update(block)
        bar.close()
        # copies: the carried tensors may be a graph's static buffers
        self._buf_state = tuple(t.clone() for t in carry[4:])
        # (n_iterations,) replay loss, on the device; n_iterations=0 is legal
        # (a no-op run)
        self.loss_trace = (torch.cat(losses) if losses
                           else torch.zeros((0,), dtype=torch.float32, device=device))
        self.flow.params = unpack_like(carry[0].clone(), like)
        return self.flow


_CTOR_KEYS = ("buffer_size", "n_ais_steps", "ais_step_size", "lr", "n_mcmc_steps")


def _split_ctor_kwargs(kwargs):
    return {k: kwargs.pop(k) for k in _CTOR_KEYS if k in kwargs}


def flow_annealed_importance_sampling_bootstrap_base(target_potential, flow, **kwargs):
    ctor_kwargs = _split_ctor_kwargs(kwargs)
    return FAB(target_potential, flow, **ctor_kwargs).run(**kwargs)


def fab(target, flow: str = "realnvp", show_progress: bool = False, seed: int = 0,
        device=None, **kwargs):
    """Wrapper (reference ``flow_training/wrappers.py:6-15``); the flow itself
    is the importance-sampling proposal. Runs on ``device`` (CUDA unless the
    caller names another)."""
    from ..api.registry import create_flow_object

    flow_object = create_flow_object(flow, target.event_shape, seed=seed).to(
        resolve_device(device))
    algorithm = FAB(target, flow_object, **_split_ctor_kwargs(kwargs))
    return algorithm.run(show_progress=show_progress, seed=seed, **kwargs)

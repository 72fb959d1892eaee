"""Annealed Flow Transport (Arbel, Matthews & Doucet 2021), corrected;
counterpart of ``nfmc_tpu/transport/aft.py``.

The reference sketch (``nfmc/algorithms/transport/annealed_flow_transport.py:
152-293``) is non-functional (it passes the module ``mh`` as a callable,
``:120-128``) and its SMC arithmetic is wrong (``log_w = logaddexp(log_W,
log_G)`` for ``log_W + log_G``, ``delta_log_Z = sum(log_w)`` for
``logsumexp``, ``:21-27,104``). This follows the published algorithm, per
level k (linear schedule lam_k = k/(K-1)):
  1. train the flow T_k on the current (train) particles to push
     eta_{k-1} toward pi_k: minimize  sum_i W_i [u_k(T(x_i)) - log|det T'|];
  2. transport & reweight: log_G = u_{k-1}(x) - u_k(T(x)) + log|det T'|,
     delta log_Z = logsumexp(log_W + log_G), then normalize log_W;
  3. resample (systematic) when the train group's ESS/n < threshold;
  4. MALA correction at pi_k.

Three particle groups (base / train / val) as in the reference design:
log_Z from base, flow fitting from train with val early stopping. The level
loop runs on the host, with one host synchronisation a level (the log-Z
increment and the resample decision, which the JAX package reads there
too). On CUDA a level's fit is replays of one captured graph of an epoch
(:meth:`AnnealedFlowTransport._fit_level`), as the JAX package jits it as
one ``lax.scan``; the selection, the transports and the sweeps run eagerly
between the fits.

A group that ``prior_sample`` returns as a DTensor runs sharded over its
mesh (:mod:`nfmc_torch.transport.common`): the level fit sums its ranks'
shares of the losses and the gradient in one ``all_reduce`` a step, the
weights' log-sums and softmaxes and the ESS are global, and a resample
gathers the group. The result holds every particle on every rank.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core import graphs
from ..core.chains import chain_logsumexp, chain_softmax
from ..flows.train import _Adam, _flatten, _resume, _skeleton, _sum_shares
from ..ops.coupling import unpack_like
from ..utils import Progress, as_numpy, resolve_device
from .common import (as_level, draw_rows, first_draw, flat_value_and_grad, gathered, log_ess,
                     make_mala_sweep, rank_share, resample, resample_offset, run_shard,
                     take_particles, tempered)


def _uniform(n: int, x: torch.Tensor) -> torch.Tensor:
    """Uniform log-weights of a group of ``n`` particles, ``x``'s rows of it."""
    return torch.full((x.shape[0],), -math.log(n), device=x.device)


class AnnealedFlowTransport:
    def __init__(
        self,
        prior_potential: Callable,
        target_potential: Callable,
        flow,
        n_steps: int = 20,
        sampling_threshold: Optional[float] = None,
        n_mcmc_steps: int = 5,
        mcmc_step_size: float = 0.05,
        n_train_epochs: int = 50,
        train_lr: float = 1e-2,
    ):
        self.prior_potential = prior_potential
        self.target_potential = target_potential
        self.flow = flow
        self.n_steps = int(n_steps)
        self.sampling_threshold = sampling_threshold
        self.n_train_epochs = int(n_train_epochs)
        self.train_lr = float(train_lr)
        self.u = tempered(prior_potential, target_potential)
        self.mala_sweep = make_mala_sweep(self.u, n_steps=n_mcmc_steps, step_size=mcmc_step_size)

    def _loss_fn(self, params, x, w, lam):
        x_t, log_det = self.flow.bijection.forward_fn(params, x)
        return torch.sum(w * (self.u(x_t, lam) - log_det))

    def _fit_level(self, params, x_train, w_train, x_val, w_val, lam, shards=(None, None)):
        """One level's training loop: ``n_train_epochs`` full-batch Adam
        steps (``optax.adam(train_lr)``, fresh moments, unguarded as in the
        JAX package) with the val loss before each and after the last, the
        best weights tracked on the device. The tracker starts at the
        warm-start params' own val loss, so a fit that never improves on
        the carry-in cannot replace it. Returns ``(best_params, best_val)``.

        The JAX package jits the loop as one ``lax.scan`` over epochs
        (``nfmc_tpu/transport/aft.py:58-65``). On CUDA, with one rank and a
        bijection that declares ``graph_capturable``, an epoch (the val
        loss, the Adam step, the best-weights tracker) is one replay of a
        captured graph, ``lam`` a device scalar among the graph's constants,
        so that one graph, cached on the object, serves every level of a
        shape; the last val loss is one eager step after the replays.

        ``shards``: the train and the val group's. With either sharded over
        several ranks, each rank computes its share of both losses, and one
        ``all_reduce`` a step sums the gradient with the val loss at the
        same weights (the last weights' val loss alone after the loop)."""
        run = run_shard(shards)
        device = x_train.device
        graphed = graphs.transport_captures([self.flow.bijection], device, run)
        if graphed:  # a captured fit runs on one rank, where the shares are the sums
            shards, run = (None, None), None
        like = _skeleton(params)
        theta = _flatten(params)
        adam = _Adam(theta, self.train_lr)

        def val_share(theta, x_val, w_val, lam):
            with torch.no_grad():
                return rank_share(self._loss_fn(unpack_like(theta, like), x_val, w_val, lam),
                                  shards[1], run)

        def tracked(theta, best, best_val, val):
            with torch.no_grad():
                better = torch.isfinite(val) & (val < best_val)
                return torch.where(better, theta, best), torch.where(better, val, best_val)

        def epoch(carry, consts, rows):
            theta, adam, best, best_val = _resume(carry, self.train_lr)
            x_train, w_train, x_val, w_val, lam = consts
            val = val_share(theta, x_val, w_val, lam)
            _, g = flat_value_and_grad(lambda p: self._loss_fn(p, x_train, w_train, lam),
                                       theta, like)
            g, val = _sum_shares(rank_share(g, shards[0], run), val, run)
            best, best_val = tracked(theta, best, best_val, val)
            with torch.no_grad():
                theta = adam.step(theta, g)
            return [theta, adam.mu, adam.nu, adam.count, best, best_val], []

        graph_of = None
        if graphed:
            graph_of = graphs.replays(self, ("aft_fit", self.train_lr), epoch, [], 1,
                                      (self.flow.bijection,))
        # best_val starts at inf: the first epoch then takes the warm-start
        # val loss where it is finite, as the JAX package's seed does
        carry = [theta, adam.mu, adam.nu, adam.count, theta,
                 torch.full((), math.inf, device=device)]
        consts = [x_train, w_train, x_val, w_val, as_level(lam, x_train)]
        carry, _, _ = graphs.iterations(epoch, carry, consts, lambda k: [], self.n_train_epochs,
                                        graph_of, self.n_train_epochs)
        theta, _, _, _, best, best_val = carry
        val = val_share(theta, x_val, w_val, consts[-1])
        if run is not None:
            val = run.sum(val)
        best, best_val = tracked(theta, best, best_val, val)
        return unpack_like(best.clone(), params), best_val.clone()

    @torch.no_grad()
    def _transport(self, params, x, log_W, lam_prev, lam_next, use_flow, shard=None):
        """Transport and reweight one group through the fitted map, or
        through the identity where ``use_flow`` (a 0-d bool tensor) is
        False: ``(x_t, log_W_new, delta_log_Z, log ESS of the increments'
        weights)``, the last two over the group's global particles."""
        x_f, log_det = self.flow.bijection.forward_fn(params, x)
        x_t = torch.where(use_flow, x_f, x)
        log_det = torch.where(use_flow, log_det, 0.0)
        log_G = self.u(x, lam_prev) - self.u(x_t, lam_next) + log_det
        log_w = log_W + log_G
        delta_log_Z = chain_logsumexp(log_w, shard)
        return x_t, log_w - delta_log_Z, delta_log_Z, log_ess(log_w, shard)

    @torch.no_grad()
    def _select_transport(self, params, x_val, lw_val, lam_prev, lam_next, shard=None):
        """Per-level safeguard fused with the val group's transport: accept
        the fitted map only if it does not hurt the incremental-weight ESS
        measured on the VAL group (independent of the base particles whose
        weights enter log_Z: any fixed map keeps the SMC estimator valid,
        the identity included, which is plain tempered SMC for that level).
        Returns ``(use_flow, transported val group, its new weights)``."""
        x_f, log_det = self.flow.bijection.forward_fn(params, x_val)
        u_prev = self.u(x_val, lam_prev)
        log_G_flow = u_prev - self.u(x_f, lam_next) + log_det
        log_G_id = u_prev - self.u(x_val, lam_next)
        ess_flow = log_ess(lw_val + log_G_flow, shard)
        ess_id = log_ess(lw_val + log_G_id, shard)
        # a non-finite ess_id (e.g. every val particle at U=+inf under a
        # hard-support target) must NOT veto a finite fitted transport
        use_flow = torch.isfinite(ess_flow) & ((ess_flow >= ess_id) | ~torch.isfinite(ess_id))
        x_t = torch.where(use_flow, x_f, x_val)
        log_w = lw_val + torch.where(use_flow, log_G_flow, log_G_id)
        norm = chain_logsumexp(log_w, shard)
        lw_new = log_w - norm
        # degenerate level (both maps unevaluable on every val particle):
        # reset to uniform rather than write NaN weights, which would lock
        # every later selection to the identity; per-row NaNs under a
        # finite norm degrade to -inf (never resampled)
        lw_new = torch.where(torch.isfinite(norm),
                             torch.where(torch.isfinite(lw_new), lw_new, -math.inf),
                             -math.log(log_w.shape[0] if shard is None
                                       else shard.n_global(log_w.shape[0])))
        return use_flow, x_t, lw_new

    def run(
        self,
        prior_sample: Callable,
        n_particles: int = 100,
        n_train_particles: int = 100,
        n_val_particles: int = 100,
        show_progress: bool = False,
        full_output: bool = False,
        generator: Optional[torch.Generator] = None,
        seed: Optional[int] = None,
    ):
        """``prior_sample(batch_shape, generator=...)`` draws the three
        groups on the flow's device; a group it returns as a DTensor runs
        sharded (module doc)."""
        device = self.flow.get_device()
        threshold = self.sampling_threshold
        if threshold is None:
            threshold = 0.3 if 1.0 / n_particles <= 0.3 else 1.0 / n_particles
        sizes = (n_particles, n_train_particles, n_val_particles)
        g, drawn = first_draw(lambda g: [prior_sample((n,), generator=g) for n in sizes], device,
                              generator, seed)
        xs, shards = zip(*(take_particles(x) for x in drawn))
        xs = [x.to(device) if s is not None else x for x, s in zip(xs, shards)]
        lws = [_uniform(n, x) for n, x in zip(sizes, xs)]
        log_Z = 0.0
        history = [as_numpy(gathered(xs[0], shards[0]))] if full_output else None
        ess_trace = []

        params = self.flow.params
        bar = Progress(total=self.n_steps - 1, desc="AFT", disable=not show_progress)
        for k in range(1, self.n_steps):
            lam_prev = (k - 1) / (self.n_steps - 1)
            lam_next = k / (self.n_steps - 1)
            (x_base, x_train, x_val), (lw_base, lw_train, lw_val) = xs, lws

            # 1. fit the flow on the weighted train particles (val best weights)
            params, _ = self._fit_level(params, x_train, chain_softmax(lw_train, shards[1]),
                                        x_val, chain_softmax(lw_val, shards[2]), lam_next,
                                        shards[1:])

            # 2. transport & reweight (the fitted map, or the identity when
            # it would hurt the val group's ESS)
            use_flow, x_val, lw_val = self._select_transport(params, x_val, lw_val, lam_prev,
                                                             lam_next, shards[2])
            x_base, lw_base, dlZ, _ = self._transport(params, x_base, lw_base, lam_prev,
                                                      lam_next, use_flow, shards[0])
            x_train, lw_train, _, ess_t = self._transport(params, x_train, lw_train, lam_prev,
                                                          lam_next, use_flow, shards[1])
            dlZ, ess_t = torch.stack([dlZ, ess_t]).tolist()  # the level's one synchronisation
            log_Z += dlZ
            # log_ess is the log of the ABSOLUTE ESS (in [0, log n])
            ess_trace.append(math.exp(ess_t))
            xs, lws = [x_base, x_train, x_val], [lw_base, lw_train, lw_val]

            # 3. resample on the train-ESS criterion (reference design)
            if ess_t - math.log(n_train_particles) <= math.log(threshold):
                xs = [resample(x, lw, resample_offset(g), s) for x, lw, s in zip(xs, lws, shards)]
                lws = [_uniform(n, x) for n, x in zip(sizes, xs)]

            # 4. MCMC correction at the new level
            xs = [self.mala_sweep(x, lam_next, draw_rows(
                self.mala_sweep.draws(g, (n, *x.shape[1:])), s))
                for x, n, s in zip(xs, sizes, shards)]

            if full_output:
                history.append(as_numpy(gathered(xs[0], shards[0])))
            bar.update(1)
            if show_progress:
                bar.set_postfix_str(f"log Z: {log_Z:.3f}")
        bar.close()

        self.flow.params = params
        result = {
            "particles": as_numpy(gathered(xs[0], shards[0])),
            "log_weights": as_numpy(gathered(lws[0], shards[0])),
            "log_Z": log_Z,
            "ess_trace": ess_trace,
        }
        if full_output:
            result["history"] = np.stack(history)
        return result


def aft(prior, target, flow, n_particles: int = 100, n_iterations: int = 20,
        show_progress: bool = False, seed: int = 0,
        n_train_particles: Optional[int] = None,
        n_val_particles: Optional[int] = None, device=None, **kwargs):
    """Wrapper with the reference signature (``transport/wrappers.py:9-26``):
    ``prior``/``target`` are Potentials, ``flow`` a registry name or Flow,
    run on ``device`` (CUDA unless the caller names another).

    ``n_train_particles``/``n_val_particles`` size the flow-fitting groups
    (reference design: three separate groups, default 100 each). With the
    100-particle default the per-level flows underfit and each level's
    importance correction adds weight variance, which biases the log-Z
    estimate low (Jensen); production log-Z runs should scale these with
    ``n_particles``.
    """
    from ..api.registry import create_flow_object
    from ..flows import Flow as _Flow

    device = resolve_device(device)
    flow_object = flow if isinstance(flow, _Flow) else create_flow_object(flow, prior.event_shape)
    flow_object.to(device)
    algorithm = AnnealedFlowTransport(prior, target, flow_object, n_steps=n_iterations, **kwargs)
    return algorithm.run(
        lambda batch_shape, generator=None: prior.sample(batch_shape, generator=generator),
        n_particles=n_particles, show_progress=show_progress,
        n_train_particles=n_train_particles or 100,
        n_val_particles=n_val_particles or 100,
        full_output=True, seed=seed,
    )

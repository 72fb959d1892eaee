"""Nested sampling with flow-guided live-point replacement, corrected;
counterpart of ``nfmc_tpu/transport/ns.py``.

The reference sketch (``transport/nested.py:8-35``) references an undefined
``rejection_sampling`` helper and tracks no evidence. This is a working
nested sampler (Skilling 2006): live points from the prior, worst-point
replacement under the hard constraint ``L(x) > L_worst``, evidence
accumulation with the ``X_i = exp(-i / n_live)`` prior-volume shrinkage.

Replacements must be prior-distributed on ``{L > L_worst}`` or the
shrinkage law (and log_Z) is biased. Early iterations use constrained prior
rejection; later the flow (refit to the live set every ``n_live``
iterations, as in the reference sketch) is an importance proposal: a
population from the flow, each candidate weighted by ``prior(x)/q(x)``,
restricted to the constraint, one candidate resampled by those weights
(SIR). The loop runs on the host; each proposal pass (flow sample,
likelihood, both densities) runs on the flow's device and is copied back.

On a mesh the run is whole on every rank, as the JAX package's is (it turns
the live points into a host array): live points that ``prior.sample``
returns as a DTensor are gathered, and a flow whose parameters are
replicated over a mesh (:func:`nfmc_torch.parallel.replicate`) runs on each
rank's copy and comes back replicated. Every rank then computes the
unsharded run's numbers.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core.chains import is_sharded, on_local_copy
from ..utils import Progress, as_numpy, resolve_device
from .common import first_draw


class NestedSampling:
    def __init__(self, prior, log_likelihood: Callable, flow,
                 n_live_points: int = 100, latent_scale: float = 1.0,
                 n_population_draws: int = 50, flow_fit_kwargs: Optional[dict] = None):
        self.prior = prior
        self.log_likelihood = log_likelihood
        self.flow = flow
        self.n_live = int(n_live_points)
        self.latent_scale = float(latent_scale)  # kept for API compat (unused)
        self.n_pop = int(n_population_draws)
        self.flow_fit_kwargs = flow_fit_kwargs or {"n_epochs": 30, "lr": 0.01}

    @torch.no_grad()
    def _flow_propose(self, params, generator):
        """Population draw from the flow and what the SIR pick needs:
        likelihoods and log prior/flow-density importance weights, on the
        host."""
        xp, logq = self.flow.sample_fn(params, generator, self.n_pop, return_log_prob=True)
        lls = self.log_likelihood(xp)
        log_w = -self.prior(xp) - logq  # log[prior(x)/q(x)] up to a constant
        return as_numpy(xp), as_numpy(lls), as_numpy(log_w)

    @staticmethod
    def _whole(x, generator):
        """Prior draws, whole: a DTensor is gathered (onto the generator's
        device)."""
        return x.full_tensor().to(generator.device) if is_sharded(x) else x

    @torch.no_grad()
    def _prior_draw(self, generator):
        cand = self._whole(self.prior.sample((self.n_pop,), generator=generator), generator)
        return as_numpy(cand), as_numpy(self.log_likelihood(cand))

    def run(self, n_iterations: int = 1000, show_progress: bool = False,
            generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        with on_local_copy(self.flow) as mesh:
            with torch.no_grad():
                g, x0 = first_draw(lambda g: self.prior.sample((self.n_live,), generator=g),
                                   self.flow.get_device(), generator, seed, mesh)
            return self._run(n_iterations, show_progress, g, self._whole(x0, g))

    def _run(self, n_iterations, show_progress, g, x0):
        with torch.no_grad():
            x0 = x0.to(torch.float32)
            x = np.array(as_numpy(x0), dtype=np.float32, copy=True)
            ll = np.array(as_numpy(self.log_likelihood(x0)), copy=True)

        n_rs_iterations = 2 * self.n_live
        log_Z = -np.inf
        log_X_prev = 0.0
        dead_points, dead_ll = [], []
        # the SIR pick's host rng, seeded from the generator (the JAX
        # package seeds it from a key)
        rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (), generator=g,
                                                      device=g.device)))

        bar = Progress(total=n_iterations, desc="NS", disable=not show_progress)
        for i in range(n_iterations):
            worst = int(np.argmin(ll))
            l_worst = float(ll[worst])

            replacement = None
            if i >= n_rs_iterations:
                # flow population + SIR to the constrained prior: restrict to
                # L > L_worst, then resample ONE candidate by prior/q weights
                x_prop, lls, lw = self._flow_propose(self.flow.params, g)
                ok = np.where(np.isfinite(lls) & (lls > l_worst) & np.isfinite(lw))[0]
                if len(ok) > 0:
                    w = np.exp(lw[ok] - lw[ok].max())
                    w_sum = w.sum()
                    if np.isfinite(w_sum) and w_sum > 0:
                        pick = ok[rng.choice(len(ok), p=w / w_sum)]
                        replacement = (x_prop[pick], float(lls[pick]))

            if replacement is None:
                # constrained rejection sampling from the prior (batched,
                # exactly prior-distributed on {L > L_worst})
                for _ in range(200):
                    cand, lls = self._prior_draw(g)
                    ok = np.where(lls > l_worst)[0]
                    if len(ok) > 0:
                        replacement = (np.asarray(cand, dtype=np.float32)[ok[0]],
                                       float(lls[ok[0]]))
                        break
            if replacement is None:
                # cannot improve the worst point: terminate WITHOUT counting
                # it dead (it stays live for the final X/n_live term below;
                # counting it in both places would double-count one shell)
                break

            # evidence increment w_i = (X_{i-1} - X_i) L_worst, recorded only
            # once the point actually leaves the live set
            log_X = -(i + 1) / self.n_live
            log_w = np.log(math.exp(log_X_prev) - math.exp(log_X) + 1e-300) + l_worst
            log_Z = np.logaddexp(log_Z, log_w)
            log_X_prev = log_X
            dead_points.append(x[worst].copy())
            dead_ll.append(l_worst)

            x[worst], ll[worst] = replacement

            if i % self.n_live == 0 and i > 0:
                # the refit's seed comes from the run's generator, as every
                # other draw of the run does: the same on every rank
                refit_seed = int(np.random.default_rng((g.initial_seed(), i)).integers(2**62))
                try:
                    self.flow.fit(x, **{"seed": refit_seed, **self.flow_fit_kwargs})
                except ValueError:
                    pass
            bar.update(1)
            if show_progress:
                bar.set_postfix_str(f"log Z: {log_Z:.3f}, L*: {l_worst:.3f}")
        bar.close()

        # final live-point contribution
        for j in range(self.n_live):
            log_w = log_X_prev - math.log(self.n_live) + float(ll[j])
            log_Z = np.logaddexp(log_Z, log_w)

        return {
            "log_Z": float(log_Z),
            "live_points": x,
            "live_log_likelihoods": ll,
            "dead_points": np.stack(dead_points) if dead_points else np.empty((0,)),
            "dead_log_likelihoods": np.asarray(dead_ll),
        }


def ns(prior, target, flow: str = "realnvp", n_particles: int = 100,
       n_iterations: int = 1000, show_progress: bool = False, seed: int = 0, device=None):
    """Wrapper with the reference signature (``transport/wrappers.py:52-59``):
    ``log_likelihood = -target``, run on ``device`` (CUDA unless the caller
    names another)."""
    from ..api.registry import create_flow_object

    device = resolve_device(device)
    flow_object = create_flow_object(flow, prior.event_shape).to(device)
    algorithm = NestedSampling(
        prior=prior,
        log_likelihood=lambda x: -target(x),
        flow=flow_object,
        n_live_points=n_particles,
    )
    return algorithm.run(n_iterations=n_iterations, show_progress=show_progress, seed=seed)

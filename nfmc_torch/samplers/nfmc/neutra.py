"""NeuTra: MCMC in the latent space of a flow (counterpart of
``nfmc_tpu/samplers/nfmc/neutra.py``).

* the inner sampler (HMC, MH or ChEES-HMC) runs in the latent space on the
  adjusted target ``U~(z) = U(f^{-1}(z)) - log|det df^{-1}/dz|``;
* the stored draws stay latent; the moments are taken of the data-space
  draws through the inner sampler's ``data_transform = z -> f^{-1}(z)``;
* ``x0`` is reused as the latent start (the reference's quirk), or, with
  ``params.transport_x0``, mapped forward through the flow, ``z0 = f(x0)``;
* warmup is the reverse-KL ``variational_fit`` of the flow on 30% of the
  time budget, then the inner sampler's tuning run.

Each HMC gradient of ``U~`` is one pass through the flow's inverse and
back: on CUDA the coupling kernel's inverse and its VJP in the inverse
direction, taken with respect to ``z`` alone (``value_and_batched_grad``).
The flow's weights enter the inner run detached, so nothing accumulates
gradients on them whatever their ``requires_grad``. On CUDA the inner HMC
or MH run replays a captured iteration, the kernels and the VJP's autograd
pass inside the graph; the graph reads the weights where they lie, so a
flow given new weight tensors captures anew (``graph_flows``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Type

import torch

from ...core.output import MCMCOutput
from ...core.sampler import NFMCKernel, NFMCParameters, Sampler
from ...utils import event_size_of, tree_leaves, tree_map
from ..mcmc.base import MCMCSampler, MetropolisKernel, MetropolisParameters
from ..mcmc.chees import CheesHMC, CheesHMCKernel, CheesHMCParameters
from ..mcmc.hmc import HMC, HMCKernel, HMCParameters
from ..mcmc.mh import MH, MHKernel, MHParameters


@dataclass
class NeuTraKernel(NFMCKernel):
    pass


@dataclass
class NeuTraParameters(NFMCParameters):
    batch_inverse_size: int = 128  # kept for parity; unused, as in the reference
    warmup_fit_kwargs: Optional[dict] = None
    # map the data-space x0 to the latent start through the flow's forward,
    # z0 = f(x0), instead of reusing it as a latent point (the reference)
    transport_x0: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.warmup_fit_kwargs is None:
            # the reference's defaults with a 128-draw reverse-KL batch
            self.warmup_fit_kwargs = {
                "early_stopping": True,
                "early_stopping_threshold": 5000,
                "keep_best_weights": True,
                "n_samples": 128,
                "n_epochs": 50000,
                "lr": 0.005,  # the reference's 0.05 diverges
            }


class NeuTra(Sampler):
    #: the warmup's stored draws are latent (the inner run's space)
    warmup_draws_are_latent = True

    def __init__(self, event_shape, target, inner_sampler_class: Type[MCMCSampler],
                 inner_kernel: MetropolisKernel, inner_params: MetropolisParameters,
                 kernel: Optional[NeuTraKernel] = None,
                 params: Optional[NeuTraParameters] = None, device=None):
        if kernel is None:
            kernel = NeuTraKernel(event_shape)
        if params is None:
            params = NeuTraParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        self.kernel.flow.to(self.device)
        inner_params.n_iterations = self.params.n_iterations
        self.inner_sampler = inner_sampler_class(event_shape, self.adjusted_target, inner_kernel,
                                                 inner_params, device=self.device)
        self.inner_sampler.data_transform = self._latent_to_data
        # the inner run's step calls the flow; its graphs read the flow's
        # weights where they lie
        self.inner_sampler.graph_flows = (self.kernel.flow,)

    @property
    def name(self):
        return "NeuTra"

    def _refresh_inner_if_stale(self):
        """The flow's weights as the inner run sees them: detached copies
        (views, no data copied), re-taken only when a weight tensor or the
        target was replaced. The token holds every weight tensor's id, and
        the tensors are kept so that the ids stay valid."""
        flow = self.kernel.flow
        params = flow.params
        token = (id(self.target),) + tuple(id(t) for t in tree_leaves(params))
        if getattr(self, "_built_params_token", None) != token:
            self._built_params_token = token
            self._built_params_ref = (params, self.target)
            self._inner_params = tree_map(lambda t: t.detach(), params)
        return self._inner_params

    def adjusted_target(self, z):
        """``U~(z) = U(f^{-1}(z)) - log|det df^{-1}/dz|``."""
        x, log_det_inverse = self.kernel.flow.bijection.inverse_fn(
            self._refresh_inner_if_stale(), z)
        return self.target(x) - log_det_inverse

    def _initial_latent(self, x0):
        """The inner run's start: ``x0`` itself (the reference), or ``f(x0)``
        with ``params.transport_x0``."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        if not self.params.transport_x0:
            return x0
        with torch.no_grad():
            return self.kernel.flow.bijection.forward_fn(self._refresh_inner_if_stale(), x0)[0]

    def _latent_to_data(self, z):
        with torch.no_grad():
            return self.kernel.flow.bijection.inverse_fn(self._refresh_inner_if_stale(), z)[0]

    def _configure_inner(self):
        inner = self.inner_sampler.params
        inner.store_samples = self.params.store_samples
        inner.store_samples_on_device = self.params.store_samples_on_device
        self.kernel.flow.to(self.device)
        self._refresh_inner_if_stale()

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        seed_fit, seed_inner = self._sub_seeds(self._generator(generator, seed), 2)
        fit_limit = 0.3 * time_limit_seconds if time_limit_seconds is not None else None
        t0 = time.time()
        # the user's warmup_fit_kwargs win over show_progress and the limit
        fit_kwargs = {"time_limit_seconds": fit_limit, "show_progress": show_progress,
                      "seed": seed_fit, **self.params.warmup_fit_kwargs}
        if self.chain_shard is not None:
            fit_kwargs["mesh"] = self.chain_shard.mesh  # each rank on its slice of the draws
        self.kernel.flow.to(self.device).variational_fit(lambda v: -self.target(v), **fit_kwargs)
        elapsed = time.time() - t0
        inner_limit = (time_limit_seconds - elapsed) if time_limit_seconds is not None else None
        self._configure_inner()
        self.inner_sampler.params.tuning_mode()
        self.inner_sampler.params.n_warmup_iterations = self.params.n_warmup_iterations
        return self.inner_sampler.warmup(self._initial_latent(x0), show_progress=show_progress,
                                         time_limit_seconds=inner_limit, seed=seed_inner)

    def sample_continue(self, z0, **kwargs) -> MCMCOutput:
        """Continue from a latent state (the stored draws are latent), so
        ``params.transport_x0`` is bypassed."""
        old = self.params.transport_x0
        self.params.transport_x0 = False
        try:
            return self.sample(z0, **kwargs)
        finally:
            self.params.transport_x0 = old

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        self.inner_sampler.params.n_iterations = self.params.n_iterations
        self.inner_sampler.params.sampling_mode()
        self._configure_inner()
        out = self.inner_sampler.sample(self._initial_latent(x0), show_progress=show_progress,
                                        time_limit_seconds=time_limit_seconds,
                                        generator=self._generator(generator, seed))
        out.kernel.flow = self.kernel.flow
        return out


class NeuTraHMC(NeuTra):
    multi_rank_chains = True

    def __init__(self, event_shape, target, inner_kernel: Optional[HMCKernel] = None,
                 inner_params: Optional[HMCParameters] = None, kernel=None, params=None,
                 device=None):
        if inner_kernel is None:
            inner_kernel = HMCKernel(event_size=event_size_of(event_shape))
        if inner_params is None:
            inner_params = HMCParameters()
        super().__init__(event_shape, target, HMC, inner_kernel, inner_params, kernel, params,
                         device=device)

    @property
    def name(self):
        return "NeuTra-HMC"


class NeuTraMH(NeuTra):
    multi_rank_chains = True

    def __init__(self, event_shape, target, inner_kernel: Optional[MHKernel] = None,
                 inner_params: Optional[MHParameters] = None, kernel=None, params=None,
                 device=None):
        if inner_kernel is None:
            inner_kernel = MHKernel(event_size=event_size_of(event_shape))
        if inner_params is None:
            inner_params = MHParameters()
        super().__init__(event_shape, target, MH, inner_kernel, inner_params, kernel, params,
                         device=device)

    @property
    def name(self):
        return "NeuTra-MH"


class NeuTraChEES(NeuTra):
    """NeuTra with a ChEES-HMC inner sampler: the adaptive trajectory runs in
    the latent space, each leapfrog's gradient through the flow's inverse
    and its VJP."""

    multi_rank_chains = True

    def __init__(self, event_shape, target, inner_kernel: Optional[CheesHMCKernel] = None,
                 inner_params: Optional[CheesHMCParameters] = None, kernel=None, params=None,
                 device=None):
        if inner_kernel is None:
            inner_kernel = CheesHMCKernel(event_size=event_size_of(event_shape))
        if inner_params is None:
            inner_params = CheesHMCParameters()
        super().__init__(event_shape, target, CheesHMC, inner_kernel, inner_params, kernel, params,
                         device=device)

    @property
    def name(self):
        return "NeuTra-ChEES"

"""Bijection protocol and the Flow wrapper.

Bijections are config objects; their numeric parameters are an explicit
list of per-layer ``{"w": [...], "b": [...]}`` dicts of tensors, the layout
of ``nfmc_tpu/flows/base.py``. ``forward`` maps data to latent and returns
``(z, log |det dz/dx|)``; ``sample`` draws from the base and applies
``inverse``; ``log_prob(x) = base_log_prob(forward(x)) + log_det``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..core.rng import resolve_generator
from ..utils import event_size_of, std_normal_log_prob


def _map_params(params, fn):
    return [{k: [fn(t) for t in v] for k, v in p.items()} for p in params]


class Bijection:
    """Invertible map with static config; params are an explicit list."""

    def __init__(self, event_shape: Sequence[int]):
        self.event_shape: Tuple[int, ...] = tuple(int(s) for s in event_shape)
        self.params: Any = None

    @property
    def event_size(self) -> int:
        return event_size_of(self.event_shape)

    def init(self, generator: torch.Generator):
        raise NotImplementedError

    def forward_fn(self, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """data -> latent; returns (z, log_det) with log_det shaped (batch,)."""
        raise NotImplementedError

    def inverse_fn(self, params, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """latent -> data; returns (x, log_det)."""
        raise NotImplementedError

    def forward(self, x):
        return self.forward_fn(self.params, x)

    def inverse(self, z):
        return self.inverse_fn(self.params, z)

    def n_parameters(self) -> int:
        return sum(t.numel() for p in self.params for v in p.values() for t in v)


class Flow:
    """Normalizing flow = bijection + standard-normal base distribution.

    Parameters are drawn on the CPU from ``seed`` (so a seed gives the same
    flow on every device) and moved with :meth:`to`.
    """

    def __init__(self, bijection: Bijection, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        self.bijection = bijection
        if bijection.params is None:
            bijection.params = bijection.init(resolve_generator("cpu", generator, seed))
        self._base_log_prob_override: Optional[Callable] = None
        self._base_sample_override: Optional[Callable] = None

    @property
    def params(self):
        return self.bijection.params

    @params.setter
    def params(self, value):
        self.bijection.params = value

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return self.bijection.event_shape

    def state_dict(self):
        """A copy of the parameters (for weight rollback)."""
        return _map_params(self.params, lambda t: t.detach().clone())

    def load_state_dict(self, state) -> None:
        self.params = state

    def to(self, device) -> "Flow":
        device = torch.device(device)
        if self.get_device() != device:
            self.params = _map_params(self.params, lambda t: t.to(device))
        return self

    def get_device(self) -> torch.device:
        return self.params[0]["w"][0].device

    # ---- functional API -----------------------------------------------------
    def base_log_prob_fn(self, z: torch.Tensor) -> torch.Tensor:
        if self._base_log_prob_override is not None:
            return self._base_log_prob_override(z)
        return std_normal_log_prob(z, self.event_shape)

    def set_base_log_prob(self, fn: Optional[Callable],
                          sample_fn: Optional[Callable] = None) -> None:
        """Override the base density. ``sample_fn(generator, n)`` must draw
        from the distribution whose density ``fn`` evaluates; without it,
        sampling raises rather than draw from N(0, I) while reporting
        ``fn``'s density."""
        self._base_log_prob_override = fn
        self._base_sample_override = sample_fn if fn is not None else None

    def log_prob_fn(self, params, x: torch.Tensor) -> torch.Tensor:
        z, log_det = self.bijection.forward_fn(params, x)
        return self.base_log_prob_fn(z) + log_det

    def sample_base_fn(self, generator: torch.Generator, n: int) -> torch.Tensor:
        if self._base_log_prob_override is not None:
            if self._base_sample_override is None:
                raise ValueError(
                    "base_log_prob is overridden but no paired base sampler was "
                    "provided: sampling would draw z ~ N(0, I) while reporting "
                    "the override's density. Pass sample_fn to set_base_log_prob."
                )
            return self._base_sample_override(generator, n)
        return torch.randn((n, *self.event_shape), generator=generator,
                           device=generator.device)

    def push_base_fn(self, params, z: torch.Tensor):
        """Map base draws ``z`` to ``(x, log q(x))`` with
        log q(x) = base_log_prob(z) - log|det dx/dz|."""
        x, log_det_inv = self.bijection.inverse_fn(params, z)
        return x, self.base_log_prob_fn(z) - log_det_inv

    def sample_fn(self, params, generator: torch.Generator, n: int,
                  return_log_prob: bool = False):
        x, log_q = self.push_base_fn(params, self.sample_base_fn(generator, n))
        return (x, log_q) if return_log_prob else x

    # ---- stateful API ---------------------------------------------------------
    def base_log_prob(self, z):
        return self.base_log_prob_fn(z)

    def log_prob(self, x):
        with torch.no_grad():
            return self.log_prob_fn(self.params, x)

    def sample(self, n: int, return_log_prob: bool = False,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        g = resolve_generator(self.get_device(), generator, seed)
        with torch.no_grad():
            return self.sample_fn(self.params, g, int(n), return_log_prob)

    # ---- training --------------------------------------------------------------
    def fit(self, x_train, **kwargs):
        """Forward-KL MLE on samples (:func:`nfmc_torch.flows.train.fit`)."""
        from .train import fit as _fit

        return _fit(self, x_train, **kwargs)

    def variational_fit(self, target_log_prob, **kwargs):
        """Reverse-KL fit to ``target_log_prob`` (:func:`nfmc_torch.flows.train.variational_fit`)."""
        from .train import variational_fit as _vfit

        return _vfit(self, target_log_prob, **kwargs)

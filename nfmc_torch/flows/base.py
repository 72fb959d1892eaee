"""Bijection protocol, ``Inverse`` / ``Chain`` and the Flow wrapper.

Bijections are config objects; their numeric parameters are an explicit
tree of tensors (:func:`nfmc_torch.utils.tree_leaves`): a list of per-layer
``{"w": [...], "b": [...]}`` conditioner dicts for the coupling and masked
flows, dicts of tensors for the residual flows, a list per child for a
``Chain``, as in ``nfmc_tpu/flows/base.py``. ``forward`` maps data to latent
and returns ``(z, log |det dz/dx|)``; ``sample`` draws from the base and
applies ``inverse``; ``log_prob(x) = base_log_prob(forward(x)) + log_det``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from ..core.rng import resolve_generator
from ..utils import event_size_of, resolve_device, std_normal_log_prob, tree_leaves, tree_map

_MASK32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values below 2^32
    (every product stays below 2^63)."""
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _MASK32
    return h ^ (h >> 16)


def hutchinson_probes(v: torch.Tensor, n_probes: int,
                      generator_or_key: Union[None, int, torch.Generator] = None) -> torch.Tensor:
    """Rademacher probes for stochastic trace / log-det estimators, derived
    per row of ``v`` (``(..., d)`` -> ``(..., n_probes, d)``).

    As in ``nfmc_tpu/flows/base.py::hutchinson_probes``, a row's probes are
    a function of its bits (a position-weighted sum of its float32 words
    mod 2^32, so permuted rows differ) and of the probe key: deterministic,
    different between inputs, and no key is threaded through the
    ``(params, x)`` API. The signs come from an integer hash of (mix, key,
    probe, index) computed on ``v``'s device, so no generator is seeded
    from a device value (a host synchronisation a call); the draws differ
    from JAX's. ``generator_or_key``: an int, a ``torch.Generator`` (its
    initial seed) or None (0)."""
    if isinstance(generator_or_key, torch.Generator):
        key = generator_or_key.initial_seed()
    else:
        key = int(generator_or_key or 0)
    d = v.shape[-1]
    bits = v.detach().to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _MASK32
    weights = torch.arange(d, dtype=torch.int64, device=v.device) * 2 + 1
    # each word times its odd weight mod 2^32, in 16-bit halves so that no
    # int64 product overflows
    prod = ((bits & 0xFFFF) * weights + (((bits >> 16) * weights) & 0xFFFF) * 65536) & _MASK32
    mix = prod.sum(-1) & _MASK32  # (...,)
    idx = torch.arange(int(n_probes) * d, dtype=torch.int64, device=v.device)
    h = _mix32((mix[..., None] ^ (key & _MASK32)) & _MASK32)
    h = _mix32((h + idx * 0x9E3779B1) & _MASK32)
    signs = 1.0 - 2.0 * ((h >> 11) & 1).to(v.dtype)
    return signs.reshape(*v.shape[:-1], int(n_probes), d)


class Bijection:
    """Invertible map with static config; params are an explicit tree."""

    #: weight of ``regularization`` in the ``fit`` / ``variational_fit``
    #: losses (0: no term)
    regularization_weight: float = 0.0

    def __init__(self, event_shape: Sequence[int]):
        self.event_shape: Tuple[int, ...] = tuple(int(s) for s in event_shape)
        self.params: Any = None
        #: optional key of the stochastic log-det's probe stream
        self.probe_key: Optional[int] = None

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

    def regularization(self, params, x: torch.Tensor) -> torch.Tensor:
        """Training regularizer, weighted by ``regularization_weight`` in the
        training losses: per-sample values shaped ``(batch,)`` (weighted like
        the samples), or a scalar (applied unweighted). 0 by default."""
        return torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, x):
        return self.forward_fn(self.params, x)

    def inverse(self, z):
        return self.inverse_fn(self.params, z)

    def n_parameters(self) -> int:
        return sum(t.numel() for t in tree_leaves(self.params))


class Inverse(Bijection):
    """Swap forward and inverse of a bijection."""

    def __init__(self, inner: Bijection):
        super().__init__(inner.event_shape)
        self.inner = inner

    def init(self, generator):
        return self.inner.init(generator)

    def forward_fn(self, params, x):
        return self.inner.inverse_fn(params, x)

    def inverse_fn(self, params, z):
        return self.inner.forward_fn(params, z)

    @property
    def regularization_weight(self) -> float:  # type: ignore[override]
        # the wrapped bijection's regularizer survives the wrapping
        return float(getattr(self.inner, "regularization_weight", 0.0))

    def regularization(self, params, x):
        return self.inner.regularization(params, x)

    @property
    def layers(self):
        return getattr(self.inner, "layers", [])


class Chain(Bijection):
    """Composition: forward applies the bijections in order (data -> latent);
    its params are a list of the children's."""

    def __init__(self, bijections: Sequence[Bijection]):
        if not bijections:
            raise ValueError("Chain needs at least one bijection")
        super().__init__(bijections[0].event_shape)
        self.bijections = list(bijections)

    def init(self, generator):
        return [b.init(generator) for b in self.bijections]

    def _zeros(self, v):
        return torch.zeros(v.shape[: v.dim() - len(self.event_shape)], dtype=v.dtype,
                           device=v.device)

    def forward_fn(self, params, x):
        log_det = self._zeros(x)
        for b, p in zip(self.bijections, params):
            x, ld = b.forward_fn(p, x)
            log_det = log_det + ld
        return x, log_det

    def inverse_fn(self, params, z):
        log_det = self._zeros(z)
        for b, p in zip(reversed(self.bijections), reversed(params)):
            z, ld = b.inverse_fn(p, z)
            log_det = log_det + ld
        return z, log_det

    @property
    def regularization_weight(self) -> float:  # type: ignore[override]
        # an on/off gate: regularization() applies each child's own weight
        return 1.0 if any(getattr(b, "regularization_weight", 0.0)
                          for b in self.bijections) else 0.0

    def regularization(self, params, x):
        """The children's regularizers, each weighted by its own weight and
        evaluated at its own input in the forward (data -> latent) pass, up
        to the last regularized child."""
        total = self._zeros(x)
        weights = [float(getattr(b, "regularization_weight", 0.0)) for b in self.bijections]
        last = max((i for i, w in enumerate(weights) if w), default=-1)
        for i, (b, p) in enumerate(zip(self.bijections, params)):
            if i > last:
                break
            if weights[i]:
                r = b.regularization(p, x)
                total = total + weights[i] * (r if r.dim() else r.expand(total.shape))
            if i < last:
                x, _ = b.forward_fn(p, x)
        return total


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
        return tree_map(lambda t: t.detach().clone(), self.params)

    def load_state_dict(self, state) -> None:
        self.params = state

    def to(self, device=None) -> "Flow":
        """Move the parameters to ``device`` (None: the default device,
        :func:`nfmc_torch.utils.resolve_device`)."""
        device = resolve_device(device)
        if self.get_device() != device:
            self.params = tree_map(lambda t: t.to(device), self.params)
        return self

    def get_device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

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

    def sample(self, n: int, no_grad: bool = True, return_log_prob: bool = False,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """``n`` draws (and their log q with ``return_log_prob``), with the
        graph to the parameters kept unless ``no_grad``."""
        g = resolve_generator(self.get_device(), generator, seed)
        with torch.set_grad_enabled(not no_grad):
            return self.sample_fn(self.params, g, int(n), return_log_prob)

    # ---- training --------------------------------------------------------------
    def fit(self, x_train, **kwargs):
        """Forward-KL MLE on samples (:func:`nfmc_torch.flows.train.fit`).
        On CUDA a flow whose bijection declares ``graph_capturable`` replays
        a captured epoch, cached on the flow, so a refit of the same shapes
        replays a graph captured once."""
        from .train import fit as _fit

        return _fit(self, x_train, **kwargs)

    def variational_fit(self, target_log_prob, **kwargs):
        """Reverse-KL fit to ``target_log_prob`` (:func:`nfmc_torch.flows.train.variational_fit`)."""
        from .train import variational_fit as _vfit

        return _vfit(self, target_log_prob, **kwargs)

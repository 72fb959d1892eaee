"""Sampler base classes and kernel/parameter config dataclasses.

Kernels are user-facing config objects; the numeric state a run carries is
a separate object owned by each sampler.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..utils import event_size_of, resolve_device
from .chains import SHARDED_ENTRIES, sharded_entry
from .output import MCMCOutput
from .rng import resolve_generator


@dataclass
class MCMCKernel:
    """Base tunable-state config."""

    def __post_init__(self):
        pass


@dataclass
class MCMCParameters:
    """Run configuration."""

    n_iterations: int = 100
    n_warmup_iterations: int = 100
    tuning: bool = False
    store_samples: bool = True
    # keep stored draws on the device instead of copying them to host memory
    store_samples_on_device: bool = False
    # the JAX package's lax.scan unroll factor of the chunked loop, a pure
    # scheduling hint there; accepted for the same configurations, with no
    # effect on the port's eager loops
    scan_unroll: int = 1

    def __post_init__(self):
        pass

    def tuning_mode(self):
        self.tuning = True

    def sampling_mode(self):
        self.tuning = False


def _default_flow(event_shape):
    from ..flows import Flow, RealNVP

    return Flow(RealNVP(event_shape))


@dataclass
class NFMCKernel(MCMCKernel):
    """Kernel holding a normalizing flow (RealNVP by default)."""

    event_shape: Tuple[int, ...] = ()
    flow: Any = None

    def __post_init__(self):
        super().__post_init__()
        self.event_shape = tuple(self.event_shape)
        if self.flow is None:
            self.flow = _default_flow(self.event_shape)


@dataclass
class NFMCParameters(MCMCParameters):
    train_pct: float = 0.7
    max_train_size: int = 4096
    max_val_size: int = 4096
    flow_fit_kwargs: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        super().__post_init__()
        if self.flow_fit_kwargs is None:
            self.flow_fit_kwargs = {
                "early_stopping": True,
                "early_stopping_threshold": 50,
                "batch_size": "adaptive",
                "show_progress": False,
            }


class Sampler:
    """Abstract sampler. ``device`` defaults to CUDA and raises when CUDA is
    absent (pass ``device="cpu"`` to run on the CPU).

    ``warmup``, ``sample`` and ``sample_continue`` run chain-sharded when
    ``x0`` is a DTensor (:mod:`nfmc_torch.core.chains`); during such a call
    ``chain_shard`` holds this rank's :class:`~nfmc_torch.core.chains.ChainShard`.
    A class that has been shown to match its unsharded runs on more than one
    rank sets ``multi_rank_chains = True`` itself."""

    chain_shard = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in SHARDED_ENTRIES:
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "sharded_entry", False):
                setattr(cls, name, sharded_entry(fn))

    def __init__(
        self,
        event_shape: Union[Tuple[int, ...], list],
        target,
        kernel: MCMCKernel,
        params: MCMCParameters,
        device=None,
    ):
        self.event_shape = tuple(event_shape)
        self.target = target
        self.kernel = kernel
        self.params = params
        self.event_size = event_size_of(self.event_shape)
        self.device = resolve_device(device)

    @property
    def name(self) -> str:
        return "Generic sampler"

    def _n_global(self, n_local: int) -> int:
        """The run's chain count: ``n_local`` times the ranks the chains are
        sharded over."""
        return n_local if self.chain_shard is None else self.chain_shard.n_global(n_local)

    def _chain_rows(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's rows of a tensor with the global chain axis ``axis``
        (all of it without a shard)."""
        return t if self.chain_shard is None else self.chain_shard.rows(t, axis)

    def _generator(self, generator: Optional[torch.Generator] = None,
                   seed: Optional[int] = None) -> torch.Generator:
        return resolve_generator(self.device, generator, seed)

    def _cached_driver(self, config, factory, keepalive=()):
        """Memoise a ``ChunkedScanDriver`` across ``sample()`` calls, so that
        a later call replays the graphs an earlier one captured (the JAX
        package's ``_cached_driver``, which keeps its jitted chunks).
        ``config`` (a tuple of plain comparable tokens) must capture
        everything the driver's steps bake in; ``keepalive`` holds the
        objects behind its ``id(...)`` tokens, so that the ids cannot be
        recycled while the driver lives."""
        if getattr(self, "_driver_cache_cfg", None) != config:
            self._driver_cache_val = factory()
            self._driver_cache_cfg = config
            self._driver_cache_refs = keepalive
        return self._driver_cache_val

    def _sub_seeds(self, generator: torch.Generator, n: int):
        """``n`` seeds drawn from ``generator``, for the streams a call splits off."""
        return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator=None, seed=None) -> MCMCOutput:
        raise NotImplementedError

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator=None, seed=None) -> MCMCOutput:
        raise NotImplementedError

    def sample_continue(self, x0, **kwargs) -> MCMCOutput:
        """Continue a chain from ``x0``, a previous run's
        ``running_samples.last_sample``. For most samplers this is
        :meth:`sample`; those whose ``sample`` gives ``x0`` an entry meaning
        that must not repeat on a continuation (ESS, TESS, DLMC, NeuTra, PT,
        AdaptiveIMH) define their own."""
        return self.sample(x0, **kwargs)

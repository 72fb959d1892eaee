"""Potential base class: a batched negative unnormalised log-density."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a CPU generator seeded 0 (the JAX package's
    ``key(0)`` default)."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


class Potential:
    """``U(x)``, batched over leading dims. Subclasses implement
    :meth:`compute` with differentiable torch operations, so one autograd
    pass gives every row's gradient.

    Constant arrays (the names in ``_constants``) are kept on the host as
    numpy and copied to a device once, on first use there
    (:meth:`_on`)."""

    _constants: Tuple[str, ...] = ()

    def __init__(self, event_shape: Sequence[int]):
        self.event_shape: Tuple[int, ...] = tuple(int(s) for s in event_shape)

    def _on(self, device):
        """The ``_constants`` arrays as float32 tensors on ``device``."""
        cache = self.__dict__.setdefault("_device_constants", {})
        if device not in cache:
            cache[device] = tuple(torch.as_tensor(np.asarray(getattr(self, n), np.float32),
                                                  device=device) for n in self._constants)
        return cache[device]

    def sample(self, batch_shape: Sequence[int],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Exact draws ``(*batch_shape, *event)`` on the generator's device,
        where the target has an exact sampler."""
        raise NotImplementedError(f"{type(self).__name__} has no exact sampler")

    # ground truth, where it is known analytically (host numpy arrays)
    @property
    def mean(self) -> Optional[np.ndarray]:
        return None

    @property
    def second_moment(self) -> Optional[np.ndarray]:
        return None

    @property
    def event_size(self) -> int:
        size = 1
        for s in self.event_shape:
            size *= s
        return size

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.compute(x)


class CallablePotential(Potential):
    """Wrap a plain batched callable ``U: (B, *event) -> (B,)``."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], event_shape: Sequence[int]):
        super().__init__(event_shape)
        self._fn = fn

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)


def as_potential(target, event_shape=None) -> Potential:
    if isinstance(target, Potential):
        return target
    if event_shape is None:
        raise ValueError("event_shape must be provided for a plain callable target")
    return CallablePotential(target, event_shape)

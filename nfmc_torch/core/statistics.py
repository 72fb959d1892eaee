"""Host-side statistics: counters and streaming moments.

Per-iteration values accumulate on the device as compensated float32 sums
(``core/driver.py``) and fold into these float64 host objects once per
flush: once per run, or per chunk under a live progress bar.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..utils import as_numpy


@dataclass
class MCMCExpectation:
    """Streaming E[f(x)] over (iterations x chains)."""

    event_shape: Tuple[int, ...]
    f: Callable = lambda v: v
    n_seen: int = 0
    running_value: np.ndarray | float = 0.0

    def update(self, x) -> None:
        """Fold in draws ``x`` shaped (iterations, chains, *event) or
        (chains, *event), a torch tensor or an array, in float64."""
        x = as_numpy(x)
        if x.ndim == len(self.event_shape) + 1:
            x = x[None]
        elif x.ndim != len(self.event_shape) + 2:
            raise ValueError(f"bad shape {x.shape} for event {self.event_shape}")
        n_new = x.shape[0] * x.shape[1]
        mean_new = np.mean(self.f(x.astype(np.float64)), axis=(0, 1))
        total = self.n_seen + n_new
        self.running_value = self.n_seen / total * self.running_value + n_new / total * mean_new
        self.n_seen = total

    def update_from_sums(self, value_sum, n_new: int) -> None:
        """Fold in a pre-reduced sum of f(x) over (iterations x chains)."""
        if n_new == 0:
            return
        total = self.n_seen + n_new
        mean_new = np.asarray(value_sum, dtype=np.float64) / n_new
        self.running_value = self.n_seen / total * self.running_value + n_new / total * mean_new
        self.n_seen = total

    def reset(self) -> None:
        self.n_seen = 0
        self.running_value = 0.0

    def as_tensor(self):
        return np.asarray(self.running_value, dtype=np.float64)


class MCMCExpectationDict:
    """Named expectations with a shared data transform, applied to the draws
    before each expectation's ``f`` (NeuTra sets it)."""

    def __init__(self, expectations: Dict[str, MCMCExpectation],
                 data_transform: Callable = lambda v: v):
        self.expectations = expectations
        self.data_transform = data_transform

    def update(self, x) -> None:
        x_t = self.data_transform(x)
        for exp in self.expectations.values():
            exp.update(x_t)

    def reset(self) -> None:
        for exp in self.expectations.values():
            exp.reset()

    def as_tensor(self):
        return {k: v.as_tensor() for k, v in self.expectations.items()}

    def __getitem__(self, key):
        return self.expectations[key]


@dataclass
class MCMCStatistics:
    """Counters + built-in first/second moment expectations."""

    event_shape: Tuple[int, ...]
    n_accepted_trajectories: int = 0
    n_attempted_trajectories: int = 0
    n_divergences: int = 0
    n_target_gradient_calls: int = 0
    n_target_calls: int = 0
    elapsed_time_seconds: float = 0.0
    data_transform: Callable = field(default=lambda v: v)
    expectations: Optional[MCMCExpectationDict] = None

    def __post_init__(self):
        self.event_shape = tuple(self.event_shape)
        if self.expectations is None:
            self.expectations = MCMCExpectationDict(
                {
                    "first_moment": MCMCExpectation(self.event_shape, f=lambda v: v),
                    "second_moment": MCMCExpectation(self.event_shape, f=lambda v: v**2),
                },
                data_transform=self.data_transform,
            )

    def update_counters(self, n_accepted_trajectories: int = 0, n_attempted_trajectories: int = 0,
                        n_divergences: int = 0, n_target_gradient_calls: int = 0,
                        n_target_calls: int = 0) -> None:
        self.n_accepted_trajectories += int(n_accepted_trajectories)
        self.n_attempted_trajectories += int(n_attempted_trajectories)
        self.n_divergences += int(n_divergences)
        self.n_target_gradient_calls += int(n_target_gradient_calls)
        self.n_target_calls += int(n_target_calls)

    def update_moments_from_sums(self, sum_x, sum_x2, n_seen: int) -> None:
        self.expectations["first_moment"].update_from_sums(as_numpy(sum_x), n_seen)
        self.expectations["second_moment"].update_from_sums(as_numpy(sum_x2), n_seen)

    def update_elapsed_time(self, delta_time_seconds: float) -> None:
        self.elapsed_time_seconds += float(delta_time_seconds)

    @property
    def running_first_moment(self):
        return self.expectations["first_moment"].as_tensor()

    @property
    def running_second_moment(self):
        return self.expectations["second_moment"].as_tensor()

    @property
    def running_variance(self):
        # E[x^2] - E[x]^2 can cancel to a small negative; clamp at 0
        return np.maximum(self.running_second_moment - self.running_first_moment**2, 0.0)

    @property
    def acceptance_rate(self) -> float:
        if self.n_attempted_trajectories == 0:
            return math.nan
        return self.n_accepted_trajectories / self.n_attempted_trajectories

    @property
    def calls_per_second(self) -> float:
        if self.elapsed_time_seconds > 0:
            return self.n_target_calls / self.elapsed_time_seconds
        return math.nan

    @property
    def grads_per_second(self) -> float:
        if self.elapsed_time_seconds > 0:
            return self.n_target_gradient_calls / self.elapsed_time_seconds
        return math.nan

    def __repr__(self) -> str:
        return (
            f"acc-rate: {self.acceptance_rate:.2f}, "
            f"kcalls/s: {self.calls_per_second / 1000:.2f}, "
            f"kgrads/s: {self.grads_per_second / 1000:.2f}, "
            f"divergences: {self.n_divergences}"
        )

    def as_dict(self) -> dict:
        return {
            "n_accepted_trajectories": self.n_accepted_trajectories,
            "n_attempted_trajectories": self.n_attempted_trajectories,
            "n_divergences": self.n_divergences,
            "n_target_gradient_calls": self.n_target_gradient_calls,
            "n_target_calls": self.n_target_calls,
            "elapsed_time_seconds": self.elapsed_time_seconds,
            "grads_per_second": self.grads_per_second,
            "acceptance_rate": self.acceptance_rate,
            "calls_per_second": self.calls_per_second,
        }


@dataclass
class JumpNFMCStatistics(MCMCStatistics):
    """Adds the flow-jump counters."""

    n_accepted_jumps: int = 0
    n_attempted_jumps: int = 0

    @property
    def jump_acceptance_rate(self) -> float:
        if self.n_attempted_jumps == 0:
            return math.nan
        return self.n_accepted_jumps / self.n_attempted_jumps

    def update_counters(self, *, n_accepted_jumps: int = 0, n_attempted_jumps: int = 0,
                        **kwargs) -> None:
        # keyword-only: positionally these slots are the trajectory counters
        super().update_counters(**kwargs)
        self.n_accepted_jumps += int(n_accepted_jumps)
        self.n_attempted_jumps += int(n_attempted_jumps)

    def __repr__(self) -> str:
        return (
            f"MCMC acc-rate: {self.acceptance_rate:.2f}, "
            f"Jump acc-rate: {self.jump_acceptance_rate:.2f}, "
            f"kcalls/s: {self.calls_per_second / 1000:.2f}, "
            f"kgrads/s: {self.grads_per_second / 1000:.2f}, "
            f"divergences: {self.n_divergences}"
        )

    def as_dict(self) -> dict:
        return {**super().as_dict(), "jump_acceptance_rate": self.jump_acceptance_rate}


@dataclass
class PTStatistics(MCMCStatistics):
    """Adds the replica-exchange swap counters: the trajectory counters cover
    the cold rung (what a user consumes), the swap counters every edge of
    the ladder."""

    n_accepted_swaps: int = 0
    n_attempted_swaps: int = 0

    @property
    def swap_acceptance_rate(self) -> float:
        if self.n_attempted_swaps == 0:
            return math.nan
        return self.n_accepted_swaps / self.n_attempted_swaps

    def update_counters(self, *, n_accepted_swaps: int = 0, n_attempted_swaps: int = 0,
                        **kwargs) -> None:
        # keyword-only, as JumpNFMCStatistics.update_counters
        super().update_counters(**kwargs)
        self.n_accepted_swaps += int(n_accepted_swaps)
        self.n_attempted_swaps += int(n_attempted_swaps)

    def __repr__(self) -> str:
        return (
            f"cold acc-rate: {self.acceptance_rate:.2f}, "
            f"swap acc-rate: {self.swap_acceptance_rate:.2f}, "
            f"kcalls/s: {self.calls_per_second / 1000:.2f}, "
            f"kgrads/s: {self.grads_per_second / 1000:.2f}, "
            f"divergences: {self.n_divergences}"
        )

    def as_dict(self) -> dict:
        return {**super().as_dict(), "swap_acceptance_rate": self.swap_acceptance_rate}

"""MCMCOutput: bundles samples, statistics and the kernel."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .samples import MCMCSamples
from .statistics import JumpNFMCStatistics, MCMCStatistics


class MCMCOutput:
    def __init__(
        self,
        event_shape: Sequence[int],
        running_samples: Optional[MCMCSamples] = None,
        statistics: Optional[MCMCStatistics] = None,
        kernel=None,
        store_samples: bool = True,
        max_samples: Optional[int] = None,
        on_device: bool = False,
    ):
        self.event_shape = tuple(event_shape)
        self.store_samples = store_samples
        self.max_samples = max_samples
        self.running_samples = running_samples or MCMCSamples(
            self.event_shape, store_samples=store_samples, max_samples=max_samples,
            on_device=on_device,
        )
        self.statistics = statistics or MCMCStatistics(self.event_shape)
        self.kernel = kernel

    @property
    def samples(self) -> Optional[torch.Tensor]:
        """``(n_stored, n_chains, *event)``; None when not storing or when
        nothing was stored."""
        if not self.store_samples or self.running_samples.n_samples == 0:
            return None
        return self.running_samples.as_tensor()

    def resample(self, n: int, seed: int = 0) -> torch.Tensor:
        """``n`` stored draws picked uniformly with replacement; the indices
        come from ``np.random.default_rng(seed)``, as in the JAX package."""
        samples = self.samples
        if samples is None:
            raise ValueError(
                "no stored samples (store_samples=False or empty run) — "
                "resample needs the chain history"
            )
        flat = samples.reshape(-1, *self.event_shape)
        idx = np.random.default_rng(seed).integers(low=0, high=len(flat), size=(n,))
        return flat[torch.as_tensor(idx, device=flat.device)]

    def _stored_chains(self) -> torch.Tensor:
        if not self.store_samples or self.running_samples.n_samples == 0:
            raise ValueError(
                "no stored samples (store_samples=False or empty run) — "
                "diagnostics need the chain history"
            )
        s = self.running_samples.as_tensor()
        return s.reshape(s.shape[0], s.shape[1], -1)

    def effective_sample_size(self, max_window: int = 8192, dim_slab: int = 25,
                              return_extrapolation: bool = False):
        """Per-dimension ESS (summed over chains) of the stored draws, shape
        ``(event_size,)``, computed where the draws are stored
        (:mod:`nfmc_torch.diagnostics`). A history longer than
        ``max_window`` is estimated on its trailing window and extrapolated
        linearly in the draw count; ``return_extrapolation=True`` also
        returns that factor (1.0: none applied)."""
        from ..diagnostics import effective_sample_size

        chains = self._stored_chains()
        ess = effective_sample_size(chains, max_window=max_window, dim_slab=dim_slab)
        if return_extrapolation:
            n = chains.shape[0]
            factor = 1.0 if max_window is None else n / min(max_window, n)
            return ess, factor
        return ess

    def potential_scale_reduction(self) -> torch.Tensor:
        """Per-dimension split R-hat of the stored draws, shape ``(event_size,)``."""
        from ..diagnostics import potential_scale_reduction

        return potential_scale_reduction(self._stored_chains())

    def summary(self, max_dims: int = 10) -> str:
        """Per-dimension mean, sd, central 90% interval, ESS and split R-hat
        of the stored draws, and the run's counters, as a table (print it).
        R-hat reads ``n/a`` under 4 stored draws."""
        from ..diagnostics import effective_sample_size, potential_scale_reduction

        chains_dev = self._stored_chains()
        ess = effective_sample_size(chains_dev).cpu().numpy()
        try:
            rhat = potential_scale_reduction(chains_dev).cpu().numpy()
        except ValueError:
            rhat = None
        chains = chains_dev.cpu().numpy()
        d = chains.shape[-1]
        flat = chains.reshape(-1, d)
        mean = flat.mean(axis=0)
        sd = flat.std(axis=0)
        q5, q95 = np.percentile(flat, [5.0, 95.0], axis=0)

        shown = min(d, max_dims)
        lines = [
            f"{'dim':>4}  {'mean':>9}  {'sd':>9}  {'5%':>9}  {'95%':>9}"
            f"  {'ess':>9}  {'r_hat':>6}"
        ]
        for i in range(shown):
            rh = f"{rhat[i]:>6.3f}" if rhat is not None else f"{'n/a':>6}"
            lines.append(
                f"{i:>4}  {mean[i]:>9.3f}  {sd[i]:>9.3f}  {q5[i]:>9.3f}"
                f"  {q95[i]:>9.3f}  {ess[i]:>9.0f}  {rh}"
            )
        if d > shown:
            lines.append(f"... ({d - shown} more dimensions)")
        st = self.statistics
        rhat_txt = f"{rhat.max():.3f}" if rhat is not None else "n/a"
        lines.append(
            f"draws: {chains.shape[0]} x {chains.shape[1]} chains | "
            f"accept {float(st.acceptance_rate):.3f} | "
            f"divergences {int(st.n_divergences)} | "
            f"max r_hat {rhat_txt} | min ess {ess.min():.0f}"
        )
        return "\n".join(lines)

    @property
    def mean(self):
        return self.statistics.running_first_moment

    @property
    def variance(self):
        return self.statistics.running_variance

    @property
    def second_moment(self):
        return self.statistics.running_second_moment


class JumpNFMCOutput(MCMCOutput):
    def __init__(self, event_shape, **kwargs):
        kwargs["statistics"] = kwargs.get("statistics") or JumpNFMCStatistics(tuple(event_shape))
        super().__init__(event_shape, **kwargs)

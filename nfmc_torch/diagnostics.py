"""Convergence diagnostics on the samples' device: effective sample size and
split R-hat (counterpart of ``nfmc_tpu/diagnostics.py``).

The chain history stays where it is stored (on the card with
``store_samples_on_device``); only reduced per-dimension values and scalars
cross to the host. Long histories are windowed to ``max_window`` trailing
draws and extrapolated linearly in n, and the event dimension runs in
``dim_slab`` slabs, which bounds the FFT's padded buffer.
"""
from __future__ import annotations

import numpy as np
import torch

# Relative variance floor: a (chain, dim) whose lag-0 autocovariance is below
# this fraction of its mean-square value is a stuck (constant) chain, whose
# autocorrelation is undefined; it scores ESS 0.
_ZERO_VAR_REL = 1e-10


def _autocov_fft(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance along axis 0; x: (n, ...) mean-centred."""
    n = x.shape[0]
    nfft = 1 << int(np.ceil(np.log2(max(2 * n, 2))))
    f = torch.fft.rfft(x, n=nfft, dim=0)
    acov = torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[:n]
    return acov / n


def _ess_kernel(samples: torch.Tensor) -> torch.Tensor:
    """Per-dimension ESS summed over chains; ``(n, c, d) -> (d,)``.

    Geyer's initial positive sequence with pairs at even offsets,
    ``Gamma_m = rho_{2m} + rho_{2m+1}`` (``Gamma_0 = 1 + rho_1``), truncated
    where a pair first turns non-positive (a cumulative-product keep mask);
    ``tau = -1 + 2 * sum(kept Gamma)`` is floored at 1, and a stuck chain
    contributes 0."""
    n, c, d = samples.shape
    x = samples - samples.mean(0, keepdim=True)
    acov = _autocov_fft(x)  # (n, c, d), biased
    var0 = acov[0]  # (c, d)
    msq = (samples * samples).mean(0)  # (c, d) scale reference
    valid = var0 > _ZERO_VAR_REL * (msq + 1e-30)
    rho = acov / torch.where(valid, var0, torch.ones_like(var0))[None]
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, c, d).sum(1)
    keep = torch.cumprod((pairs > 0.0).to(pairs.dtype), dim=0)
    tau = -1.0 + 2.0 * (pairs * keep).sum(0)  # (c, d)
    ess = torch.where(valid, n / tau.clamp_min(1.0), torch.zeros_like(tau))
    return ess.sum(0)  # (d,)


def effective_sample_size(samples: torch.Tensor, max_window: int = 8192,
                          dim_slab: int = 25) -> torch.Tensor:
    """Per-dimension ESS summed over chains; ``(n_draws, n_chains, d) -> (d,)``.

    Histories longer than ``max_window`` are estimated on the trailing window
    and extrapolated linearly in the draw count (fair when the
    autocorrelation time is well under the window), and the event dimension
    runs in ``dim_slab`` slabs. ``max_window=None`` / ``dim_slab=None`` take
    the whole history / all dimensions at once."""
    samples = torch.as_tensor(samples)
    n, _, d = samples.shape
    window = samples if max_window is None else samples[-min(max_window, n):]
    slab = d if dim_slab is None else dim_slab
    parts = [_ess_kernel(window[..., i:i + slab]) for i in range(0, d, slab)]
    return torch.cat(parts) * (n / window.shape[0])


def potential_scale_reduction(samples: torch.Tensor) -> torch.Tensor:
    """Split R-hat (Gelman-Rubin) per dimension; ``(n, c, d) -> (d,)``.

    Needs ``n >= 4`` draws (each split half needs 2 for a ddof=1 variance)
    and raises otherwise. Chains all stuck at one point report 1.0; stuck at
    different points, +inf."""
    samples = torch.as_tensor(samples)
    n, c, d = samples.shape
    if n < 4:
        raise ValueError(f"split-R-hat needs at least 4 draws, got {n} — run longer or "
                         "skip R-hat on smoke runs")
    half = n // 2
    split = torch.cat([samples[:half], samples[half:2 * half]], dim=1)  # (half, 2c, d)
    chain_mean = split.mean(0)  # (m, d)
    chain_var = split.var(0, correction=1)
    b = half * chain_mean.var(0, correction=1)
    w = chain_var.mean(0)
    var_plus = (half - 1) / half * w + b / half
    scale = (split * split).mean((0, 1))  # (d,) relative reference
    tiny = _ZERO_VAR_REL * (scale + 1e-30)
    stuck = torch.where(b > tiny, torch.full_like(b, float("inf")), torch.ones_like(b))
    return torch.where(w > tiny, torch.sqrt(var_plus / w.clamp_min(1e-30)), stuck)


def summarize(samples, max_window: int = 8192, dim_slab: int = 25) -> dict:
    """Mean ESS, min ESS and max R-hat as host scalars. R-hat runs on the
    same trailing window as the ESS and is ``None`` under 4 draws."""
    samples = torch.as_tensor(samples)
    flat = samples.reshape(samples.shape[0], samples.shape[1], -1)
    ess = effective_sample_size(flat, max_window=max_window, dim_slab=dim_slab)
    window = flat[-min(max_window, flat.shape[0]):]
    rhat_max = float(potential_scale_reduction(window).max()) if window.shape[0] >= 4 else None
    return {"ess_mean": float(ess.mean()), "ess_min": float(ess.min()), "rhat_max": rhat_max}

"""Two-sample validation of MCMC draws, on the host in NumPy (counterpart
of ``nfmc_tpu/validation.py``, kept as the port's own copy).

Chains within one run are independent, so under the null the two runs'
chains are exchangeable, and permuting chain labels between the groups
gives an exact null distribution for any statistic, with no
autocorrelation-time estimation. The null needs the whole chain law to
match across the groups: two implementations of one algorithm in matched
configurations, or one implementation at two seeds.

- :func:`ks_statistic`: the pooled two-sample Kolmogorov-Smirnov distance.
- :func:`energy_distance`: the Szekely-Rizzo energy distance.
- :func:`chain_permutation_test`: exact permutation p-values over chain
  labels for a max-over-dims KS statistic and for the energy distance.
- :func:`mcmc_two_sample_report`: two ``(T, C, d)`` stacks in, statistics,
  p-values and the verdict out.
"""
from typing import Dict, Optional

import numpy as np

__all__ = [
    "ks_statistic",
    "energy_distance",
    "chain_permutation_test",
    "mcmc_two_sample_report",
    "per_dim_ess",
]


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS distance ``sup_t |F_a(t) - F_b(t)|`` for 1-d samples."""
    a = np.sort(np.asarray(a, dtype=np.float64).ravel())
    b = np.sort(np.asarray(b, dtype=np.float64).ravel())
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.max(np.abs(cdf_a - cdf_b)))


def energy_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Székely–Rizzo energy distance ``2 E|X-Y| - E|X-X'| - E|Y-Y'|``."""
    a = np.asarray(a, dtype=np.float64).reshape(len(a), -1)
    b = np.asarray(b, dtype=np.float64).reshape(len(b), -1)

    def _mean_pdist(u, v):
        total = 0.0
        for i in range(0, len(u), 512):
            blk = u[i : i + 512]
            d2 = ((blk[:, None, :] - v[None, :, :]) ** 2).sum(-1)
            total += np.sqrt(np.maximum(d2, 0.0)).sum()
        return total / (len(u) * len(v))

    return float(2 * _mean_pdist(a, b) - _mean_pdist(a, a) - _mean_pdist(b, b))


def per_dim_ess(draws: np.ndarray) -> np.ndarray:
    """Per-dimension effective sample size of a ``(T, C, d)`` draw stack,
    summed over chains (host NumPy mirror of
    :func:`nfmc_torch.diagnostics.effective_sample_size`, Geyer initial
    positive sequence). Reported for context only — the permutation test
    does NOT use it (see module docstring)."""
    T, C, d = draws.shape
    x = np.asarray(draws, dtype=np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    # biased autocovariance (acov/T), PER CHAIN — matches diagnostics'
    # _autocov_fft exactly; an unbiased acov/(T-t) + chain-averaged-rho
    # variant differs materially on heterogeneous chains (one stuck chain
    # inflates the shared tau and deflates every chain's ESS, where the
    # device estimator only discounts the stuck chain)
    nfft = 1
    while nfft < 2 * T:
        nfft *= 2
    f = np.fft.rfft(x, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:T].real / T
    rho = acov / np.maximum(acov[0:1], 1e-300)  # (T, C, d)
    # Geyer pairing Gamma_m = rho_{2m} + rho_{2m+1} (Gamma_0 = 1 + rho_1),
    # kept while positive per chain (cumprod mask = sequential early break)
    n_pairs = T // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, C, d).sum(axis=1)
    keep = np.cumprod(pairs > 0.0, axis=0)
    tau = -1.0 + 2.0 * np.sum(pairs * keep, axis=0)  # (C, d)
    ess = T / np.maximum(tau, 1.0)
    return ess.sum(axis=0)  # (d,)


def chain_permutation_test(
    draws_a: np.ndarray,
    draws_b: np.ndarray,
    n_perm: int = 200,
    alpha: float = 0.01,
    max_iters_ks: int = 256,
    max_points_energy: int = 24,
    rng: Optional[np.random.Generator] = None,
) -> Dict:
    """Exact two-sample test with chains as the exchangeable unit.

    ``draws_a``/``draws_b``: ``(T, C, d)`` stacks (T may differ, C may
    differ). Statistics: (1) max-over-dims pooled KS — the max-statistic
    form handles the across-dims multiplicity exactly, no Bonferroni — and
    (2) multivariate energy distance. Both are recomputed under ``n_perm``
    random reassignments of the ``C_a + C_b`` chains into groups of size
    ``C_a``/``C_b``; p-values use the add-one permutation estimator. Within-
    chain iterations are subsampled (strided) to bound cost — valid because
    the whole chain moves with its label under the permutation.
    """
    rng = rng or np.random.default_rng(0)
    a = np.asarray(draws_a, dtype=np.float64)
    b = np.asarray(draws_b, dtype=np.float64)
    if a.ndim != 3 or b.ndim != 3 or a.shape[-1] != b.shape[-1]:
        raise ValueError("expected (T, C, d) stacks with matching d")
    # stride iterations; keep whole chains. Truncate to a COMMON per-chain
    # length: with T_a != T_b each chain would otherwise carry its length
    # through the permutation, so chain labels would not be exchangeable and
    # the KS p-value would be miscalibrated (the test must be exact under
    # the null; the energy path below does the same truncation).
    a_ks = a[:: max(1, int(np.ceil(a.shape[0] / max_iters_ks)))]
    b_ks = b[:: max(1, int(np.ceil(b.shape[0] / max_iters_ks)))]
    per_ks = min(a_ks.shape[0], b_ks.shape[0])
    a_ks, b_ks = a_ks[:per_ks], b_ks[:per_ks]
    ca, cb = a.shape[1], b.shape[1]
    d = a.shape[-1]

    # per-chain draw matrices for KS: chains[i] -> (T', d)
    chains_ks = [a_ks[:, i] for i in range(ca)] + [b_ks[:, i] for i in range(cb)]
    # aggressively thinned per-chain points for the energy statistic; both
    # stacks truncate to a COMMON per-chain count (ceil-based striding gives
    # unequal counts when T_a != T_b, and the block indexing in ``en_stat``
    # requires every chain to contribute exactly ``per`` points)
    a_en = a[:: max(1, int(np.ceil(a.shape[0] / max_points_energy)))]
    b_en = b[:: max(1, int(np.ceil(b.shape[0] / max_points_energy)))]
    per = min(a_en.shape[0], b_en.shape[0])
    a_en, b_en = a_en[:per], b_en[:per]
    chains_en = [a_en[:, i] for i in range(ca)] + [b_en[:, i] for i in range(cb)]

    def ks_stat(idx_a, idx_b):
        pa = np.concatenate([chains_ks[i] for i in idx_a])
        pb = np.concatenate([chains_ks[i] for i in idx_b])
        return max(ks_statistic(pa[:, j], pb[:, j]) for j in range(d))

    # energy: precompute the full pairwise-distance matrix once over all
    # thinned points; permutations then only re-index block sums
    pts = np.concatenate(chains_en)  # (n_chains_total * per, d)
    n_pts = len(pts)
    dist = np.empty((n_pts, n_pts))
    for i in range(0, n_pts, 512):
        blk = pts[i : i + 512]
        dist[i : i + 512] = np.sqrt(
            np.maximum(((blk[:, None, :] - pts[None, :, :]) ** 2).sum(-1), 0.0)
        )

    def en_stat(idx_a, idx_b):
        pa = np.concatenate([np.arange(i * per, (i + 1) * per) for i in idx_a])
        pb = np.concatenate([np.arange(i * per, (i + 1) * per) for i in idx_b])
        d_ab = dist[np.ix_(pa, pb)].mean()
        d_aa = dist[np.ix_(pa, pa)].mean()
        d_bb = dist[np.ix_(pb, pb)].mean()
        return 2 * d_ab - d_aa - d_bb

    idx = np.arange(ca + cb)
    obs_ks = ks_stat(idx[:ca], idx[ca:])
    obs_en = en_stat(idx[:ca], idx[ca:])
    ge_ks = 0
    ge_en = 0
    for _ in range(n_perm):
        perm = rng.permutation(ca + cb)
        ge_ks += ks_stat(perm[:ca], perm[ca:]) >= obs_ks
        ge_en += en_stat(perm[:ca], perm[ca:]) >= obs_en
    p_ks = float((ge_ks + 1) / (n_perm + 1))
    p_en = float((ge_en + 1) / (n_perm + 1))
    return {
        "ks_max": round(obs_ks, 5),
        "ks_p_value": round(p_ks, 4),
        "energy_distance": round(obs_en, 6),
        "energy_p_value": round(p_en, 4),
        "n_perm": n_perm,
        "n_chains": [int(ca), int(cb)],
        "alpha": alpha,
        "ok": bool(p_ks > alpha and p_en > alpha),
    }


def mcmc_two_sample_report(draws_a: np.ndarray, draws_b: np.ndarray,
                           alpha: float = 0.01, n_perm: int = 200,
                           rng: Optional[np.random.Generator] = None) -> Dict:
    """Full two-sample comparison of two MCMC draw stacks ``(T, C, d)``.

    Chain-permutation exact test (see module docstring) + reported effective
    sizes for context. ``ok`` is the permutation verdict at family level
    ``~2 * alpha`` (two statistics)."""
    draws_a = np.asarray(draws_a, dtype=np.float64)
    draws_b = np.asarray(draws_b, dtype=np.float64)
    if draws_a.ndim != 3 or draws_b.ndim != 3:
        raise ValueError("expected (T, C, d) draw stacks")
    test = chain_permutation_test(draws_a, draws_b, n_perm=n_perm,
                                  alpha=alpha, rng=rng)
    return {
        **test,
        "n_eff_a": [round(float(v), 1) for v in per_dim_ess(draws_a)],
        "n_eff_b": [round(float(v), 1) for v in per_dim_ess(draws_b)],
    }

"""Dense-metric (full-covariance mass matrix) HMC and MALA (counterpart of
``nfmc_tpu/samplers/mcmc/dense.py``).

The samplers carry a covariance estimate ``Sigma ~ Cov(x)`` (the Stan
"dense metric": kinetic energy ``0.5 p^T Sigma p``, momenta ``p ~ N(0,
Sigma^{-1})``), adapted in the warmup by two cross-chain EMAs, one over the
even chains and one over the odd. Every ``metric_refresh_every`` tuning
steps the refresh shrinks their mean geodesically toward ``mu I`` by ``1 -
r``, ``r`` the halves' normalised cross-correlation (the share of the dense
structure that is real), and factorises it: ``chol`` (``Sigma = A A^T``)
and its inverse. The steps apply the metric by matrix products with these
factors only, and every quadratic form is whitened (a sum of squares of
``p A`` or ``r A^{-T}``).

When the evidence says the dense structure is noise (``r`` below
``scalar_fallback_r`` for ``scalar_fallback_patience`` refreshes in a row)
the metric is exactly ``mu I``: the refresh writes scalar factors, the step
jitter is off, and a sampling run after such a warmup is built with the
scalar math (no dense products); it leaves scalar mode when ``r`` recovers
past ``scalar_recover_r``. The refresh reads its mode decision on the host,
one synchronisation a refresh, and runs ``eigh`` only for dense factors.

The JAX package runs a chunk as one ``lax.scan`` whose step holds the
refresh under a ``lax.cond`` on ``t % metric_refresh_every`` (and the mode
under another). Here a chunk's step is the iteration without the refresh:
the proposal, the accept, the covariance EMAs, ``t + 1`` (a device counter,
as in JAX) and the dual-averaging step, replayed as a captured CUDA graph
on CUDA. The refresh runs eagerly on the carried state after the
iterations where it falls, which the host knows from its own count
(``_resume_t`` and the tuning iterations run): ``ChunkedScanDriver`` pauses
the chunk there, in the eager loop as in the replays. A step called
directly (``_make_step_aux``) refreshes inline, reading ``t`` on the host.

The float32 products assume TF32 off for matrix products on the card
(PyTorch's default), as the JAX package runs them at
``precision="highest"``; the package does not change that switch.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core.chains import chain_mean
from ...core.tuning import DualAveragingParams, DualAveragingState, da_init, da_update_step_size
from ...utils import event_size_of, flatten_event
from .base import MetropolisKernel, MetropolisParameters
from .hmc import HMC, HMCParameters
from .langevin import Langevin, LangevinParameters


@dataclasses.dataclass
class DenseMetropolisState:
    """The dense kernels' state. ``cov_a``/``cov_b`` are the EMAs of the
    even and the odd chains: independent noise around the same covariance.
    ``jitter_frac`` gates the step jitter: 0 for the initial (user-trusted)
    metric, 1 once a refresh has adapted it."""

    step_size: torch.Tensor  # f32 scalar
    cov_a: torch.Tensor  # (d, d)
    cov_b: torch.Tensor  # (d, d)
    chol: torch.Tensor  # (d, d) lower A, A A^T = the shrunk covariance
    chol_inv: torch.Tensor  # (d, d) A^{-1}
    jitter_frac: torch.Tensor  # f32 scalar in [0, 1]
    t: torch.Tensor  # i32 scalar: tuning steps run (the refresh cadence)
    mu: torch.Tensor  # f32 scalar: trace(cov) / d, the scalar metric
    scalar_mode: torch.Tensor  # bool scalar
    r_low_streak: torch.Tensor  # i32: refreshes in a row with r below the gate
    da: DualAveragingState

    @property
    def cov(self) -> torch.Tensor:
        """The combined covariance estimate, without shrinkage."""
        return 0.5 * (self.cov_a + self.cov_b)


def _host_factorize(cov: np.ndarray, ridge: float):
    """float64 Cholesky factor and its inverse of a covariance estimate, on
    the host; the ridge keeps a float32 estimate factorisable."""
    cov64 = np.asarray(cov, dtype=np.float64)
    cov64 = 0.5 * (cov64 + cov64.T)
    d = cov64.shape[0]
    cov64 = cov64 + ridge * max(float(np.mean(np.diag(cov64))), 1.0) * np.eye(d)
    chol = np.linalg.cholesky(cov64)
    chol_inv = np.linalg.inv(chol)
    return chol.astype(np.float32), chol_inv.astype(np.float32)


_RESUME_STASHES = ("_resume_halves", "_resume_factors", "_resume_jitter_frac", "_resume_t",
                   "_resume_mu", "_resume_scalar_mode", "_resume_r_low_streak")


class _DenseCovKernelMixin:
    """``mass_cov``'s check and the state of the dense kernels."""

    def _init_cov(self):
        d = self.event_size
        if self.mass_cov is None:
            self.mass_cov = np.eye(d, dtype=np.float32)
        else:
            self.mass_cov = np.asarray(self.mass_cov, dtype=np.float32)
            if self.mass_cov.shape != (d, d):
                raise ValueError(f"mass_cov shape {self.mass_cov.shape} != ({d}, {d})")
            try:
                _host_factorize(self.mass_cov, self.make_state_ridge)
            except np.linalg.LinAlgError as e:
                raise ValueError(
                    f"mass_cov must be positive definite (Cholesky factorization failed: {e})"
                ) from e

    def make_state(self, device) -> DenseMetropolisState:
        if getattr(self, "_resume_src", None) is not self.mass_cov or (
            getattr(self, "_resume_src_value", None) is not None
            and not np.array_equal(np.asarray(self.mass_cov), self._resume_src_value)
        ):
            # a mass_cov set since the last run (replaced or changed in
            # place) wins over the run's adapted state; the dual averaging
            # and the step stay
            for attr in _RESUME_STASHES:
                if hasattr(self, attr):
                    delattr(self, attr)
        da = getattr(self, "_resume_da", None)
        halves = getattr(self, "_resume_halves", None)
        jf = getattr(self, "_resume_jitter_frac", None)
        resumed = getattr(self, "_resume_factors", None)
        mu = getattr(self, "_resume_mu", None)
        streak = getattr(self, "_resume_r_low_streak", None)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        cov = f32(self.mass_cov)
        cov_a, cov_b = (cov, cov) if halves is None else halves
        if resumed is not None:
            chol, chol_inv = resumed  # the warmup's shrunk factors
        else:
            chol, chol_inv = _host_factorize(self.mass_cov, self.make_state_ridge)
        if mu is None:
            mu = float(np.trace(np.asarray(self.mass_cov))) / max(1, self.event_size)
        return DenseMetropolisState(
            step_size=f32(self.step_size),
            cov_a=f32(cov_a), cov_b=f32(cov_b), chol=f32(chol), chol_inv=f32(chol_inv),
            # the initial metric is exact: no jitter until a refresh adapts it
            jitter_frac=f32(0.0 if jf is None else jf),
            t=torch.tensor(int(getattr(self, "_resume_t", 0)), dtype=torch.int32, device=device),
            mu=f32(mu),
            scalar_mode=torch.tensor(bool(getattr(self, "_resume_scalar_mode", False)),
                                     device=device),
            r_low_streak=torch.as_tensor(0 if streak is None else streak, dtype=torch.int32,
                                         device=device),
            da=da.to(device) if da is not None else da_init(self.step_size, self.da_params, device),
        )

    def sync_from_state(self, state: DenseMetropolisState) -> None:
        # one device-to-host copy for everything the host reads
        host = torch.cat([state.step_size.reshape(1), state.mu.reshape(1),
                          state.scalar_mode.reshape(1).to(torch.float32),
                          state.r_low_streak.reshape(1).to(torch.float32),
                          state.t.reshape(1).to(torch.float32),
                          state.cov.reshape(-1)]).cpu().numpy()
        d = state.cov_a.shape[0]
        self.step_size = float(host[0])
        self.mass_cov = host[5:].reshape(d, d)
        # the warmup's adaptation carries into the next run: the dual
        # averaging, the refresh counter, the halves, the SHRUNK factors, the
        # jitter gate and the scalar mode; the tensors stay on the device
        self._resume_da = state.da
        self._resume_t = int(host[4])
        self._resume_halves = (state.cov_a, state.cov_b)
        self._resume_jitter_frac = state.jitter_frac
        self._resume_factors = (state.chol, state.chol_inv)
        self._resume_mu = float(host[1])
        self._resume_scalar_mode = bool(host[2])
        self._resume_r_low_streak = int(host[3])
        # a mass_cov set after this (by identity or by value) drops them
        self._resume_src = self.mass_cov
        self._resume_src_value = np.array(self.mass_cov, copy=True)

    def __repr__(self):
        diag = np.diag(np.asarray(self.mass_cov))
        return (f"log step: {math.log(self.step_size):.2f}, "
                f"metric diag range: [{float(diag.min()):.3g}, {float(diag.max()):.3g}]")


@dataclass
class DenseHMCKernel(_DenseCovKernelMixin, MetropolisKernel):
    n_leapfrog_steps: int = 20
    mass_cov: Optional[np.ndarray] = None  # (d, d); identity by default
    make_state_ridge: float = 1e-6

    __repr__ = _DenseCovKernelMixin.__repr__

    def __post_init__(self):
        super().__post_init__()
        self._init_cov()


@dataclass
class DenseLangevinKernel(_DenseCovKernelMixin, MetropolisKernel):
    step_size: Optional[float] = None  # d^(-1/3) by default, as MALA's
    mass_cov: Optional[np.ndarray] = None
    make_state_ridge: float = 1e-6

    __repr__ = _DenseCovKernelMixin.__repr__

    def __post_init__(self):
        if self.step_size is None:
            self.step_size = self.event_size ** (-1.0 / 3.0)
        super().__post_init__()
        self._init_cov()


@dataclass
class DenseMetricParameters(MetropolisParameters):
    """``tune_inv_mass_diag`` gates the dense metric's adaptation (the
    diagonal family's name, so front-door ``param_kwargs`` stay uniform)."""

    metric_adjustment: float = 0.05  # the cross-chain covariance EMA's weight
    metric_refresh_every: int = 8  # tuning steps between refreshes
    metric_ridge: float = 1e-6  # the diagonal added to each batch covariance
    # scalar mode: entered after scalar_fallback_patience refreshes in a row
    # with r below scalar_fallback_r, left when r passes scalar_recover_r
    scalar_fallback_r: float = 0.15
    scalar_fallback_patience: int = 2
    scalar_recover_r: float = 0.3


@dataclass
class DenseHMCParameters(DenseMetricParameters, HMCParameters):
    # the adapted metric's noise spreads the leapfrog frequencies; the
    # per-chain jitter keeps near-resonant directions from stalling
    step_jitter: float = 0.2


@dataclass
class DenseLangevinParameters(DenseMetricParameters, LangevinParameters):
    pass


class _DenseMetricMixin:
    """The metric adaptation and the build-time choice of the scalar math,
    shared by DenseHMC and DenseMALA."""

    # A sampling run (which cannot change the mode: only the tuning refresh
    # writes it) after a warmup that ended in scalar mode is built with the
    # scalar math. A tuning run is built dense; in scalar mode the dense
    # math gives the same numbers (the refresh writes chol = sqrt(mu) I and
    # the jitter gate is off), so a mode flip mid-warmup changes the cost,
    # never the result.
    def _host_scalar_mode(self) -> bool:
        return bool(getattr(self.kernel, "_resume_scalar_mode", False))

    def _make_step_aux(self, tuning, inline_refresh: bool = True):
        self._build_scalar = (not tuning) and self._host_scalar_mode()
        self._build_inline_refresh = inline_refresh
        return super()._make_step_aux(tuning)

    def _make_chunk_step(self, tuning):
        return self._make_step_aux(tuning, inline_refresh=False)

    def _graph_mode(self, tuning):
        return ((not tuning) and self._host_scalar_mode(),)

    def _run_pause(self, tuning, n_chains):
        """The refresh after each iteration where ``t``, counted on the host
        from the kernel's ``_resume_t``, reaches a multiple of
        ``metric_refresh_every`` (a tuning run that adapts the metric of
        more than one chain counts ``t``)."""
        if not (tuning and getattr(self.params, "tune_inv_mass_diag", False) and n_chains > 1):
            return None
        t0 = int(getattr(self.kernel, "_resume_t", 0))
        every = max(1, int(self.params.metric_refresh_every))
        refresh = self._make_refresh()

        def work(state):
            if isinstance(state, tuple):
                return (refresh(state[0]), *state[1:])
            return refresh(state)

        return (lambda k: (t0 + k) % every == 0, work)

    def _make_refresh(self):
        """``refresh(mstate) -> mstate``: the shrunk factors from the EMA
        halves and the mode decision, kept where they are finite (the JAX
        package's ``lax.cond`` branch)."""
        p = self.params
        r_lo, r_hi = float(p.scalar_fallback_r), float(p.scalar_recover_r)
        patience = int(p.scalar_fallback_patience)

        def refresh(cov_a, cov_b, streak, scalar_mode):
            """The shrunk factors from the halves, and the mode decision."""
            d = cov_a.shape[0]
            sym_a = 0.5 * (cov_a + cov_a.T)
            sym_b = 0.5 * (cov_b + cov_b.T)
            comb = 0.5 * (sym_a + sym_b)
            mu = torch.trace(comb) / d
            eye = torch.eye(d, dtype=comb.dtype, device=comb.device)
            dev_a = sym_a - mu * eye
            dev_b = sym_b - mu * eye
            # the halves share the signal and not the noise: their normalised
            # cross-correlation is the real share of the dense structure
            cross = (dev_a * dev_b).sum()
            na, nb = (dev_a * dev_a).sum(), (dev_b * dev_b).sum()
            r = torch.clamp(cross / torch.sqrt(na * nb + 1e-30), 0.0, 1.0)
            s = 1.0 - r
            # the gate reads max(r, r_diag): the diagonal's own split-half
            # correlation sees a per-dim anisotropy the full-matrix r drowns
            diag_a, diag_b = torch.diagonal(dev_a), torch.diagonal(dev_b)
            r_diag = torch.clamp((diag_a * diag_b).sum()
                                 / torch.sqrt((diag_a * diag_a).sum() * (diag_b * diag_b).sum()
                                              + 1e-30), 0.0, 1.0)
            r_gate = torch.maximum(r, r_diag)
            streak2 = torch.where(r_gate < r_lo, streak + 1, torch.zeros_like(streak))
            mode2 = torch.where(scalar_mode, r_gate < r_hi, streak2 >= patience)
            # the branch, read on the host: eigh runs for dense factors only
            if bool(mode2):
                sqmu = torch.sqrt(torch.clamp(mu, min=1e-12))
                a, a_inv, ok = sqmu * eye, (1.0 / sqmu) * eye, None
            else:
                # geodesic shrinkage toward mu I: the eigenvalues interpolate
                # multiplicatively, lam^(1-s) mu^s
                lam, vecs = torch.linalg.eigh(comb)
                lam = torch.clamp(lam, min=1e-12)
                lam_s = lam ** (1.0 - s) * torch.clamp(mu, min=1e-12) ** s
                shrunk = (vecs * lam_s[None, :]) @ vecs.T
                # cholesky_ex: a matrix that is not positive definite gives
                # info != 0 (no raise, no sync) and the old factors stay
                a, info = torch.linalg.cholesky_ex(0.5 * (shrunk + shrunk.T) + 1e-9 * mu * eye)
                a_inv = torch.linalg.solve_triangular(a, eye, upper=False)
                ok = info == 0
            finite = torch.isfinite(a).all() & torch.isfinite(a_inv).all()
            return a, a_inv, finite if ok is None else finite & ok, mu, mode2, streak2

        def apply(m: DenseMetropolisState) -> DenseMetropolisState:
            a, a_inv, ok, mu, mode2, streak2 = refresh(m.cov_a, m.cov_b, m.r_low_streak,
                                                       m.scalar_mode)
            # any adapted metric engages the jitter gate
            return dataclasses.replace(
                m, chol=torch.where(ok, a, m.chol), chol_inv=torch.where(ok, a_inv, m.chol_inv),
                jitter_frac=torch.where(ok, torch.ones_like(m.jitter_frac), m.jitter_frac),
                mu=torch.where(ok, mu, m.mu), scalar_mode=torch.where(ok, mode2, m.scalar_mode),
                r_low_streak=torch.where(ok, streak2, m.r_low_streak))

        return apply

    def make_update_kernel(self):
        p = self.params
        tune_metric = getattr(p, "tune_inv_mass_diag", False)
        tune_step = getattr(p, "tune_step_size", False) and getattr(p, "adjustment", False)
        alpha = p.metric_adjustment
        refresh_every = max(1, int(p.metric_refresh_every))
        ridge = p.metric_ridge
        da_params = getattr(self.kernel, "da_params", None) or DualAveragingParams()
        shard = self.chain_shard
        split = shard is not None and shard.size > 1
        refresh = self._make_refresh() if getattr(self, "_build_inline_refresh", True) else None

        def update(mstate: DenseMetropolisState, x: torch.Tensor, mask: torch.Tensor):
            n_local = x.shape[0]
            n_chains = self._n_global(n_local)
            cov_a, cov_b, t = mstate.cov_a, mstate.cov_b, mstate.t
            chol, chol_inv, jitter_frac = mstate.chol, mstate.chol_inv, mstate.jitter_frac
            mu_c, scalar_mode, streak = mstate.mu, mstate.scalar_mode, mstate.r_low_streak
            if tune_metric and n_chains > 1:
                d = cov_a.shape[0]
                x_flat = x.reshape(n_local, -1)
                eye = torch.eye(d, dtype=x_flat.dtype, device=x_flat.device)

                def batch_cov(xs, n):
                    """The covariance of ``n`` chains, ``xs`` this rank's of
                    them (two passes over the ranks when they are split)."""
                    if not split:
                        xc = xs - xs.mean(0, keepdim=True)
                        return (xc.T @ xc) / (xs.shape[0] - 1) + ridge * eye
                    xc = xs - shard.sum(xs.sum(0, keepdim=True)) / n
                    return shard.sum(xc.T @ xc) / (n - 1) + ridge * eye

                if n_chains > 3:
                    # independent halves of the chains (even and odd global
                    # index): independent noise
                    first = 0 if shard is None else (shard.rank * n_local) % 2
                    c_a = batch_cov(x_flat[first::2], (n_chains + 1) // 2)
                    c_b = batch_cov(x_flat[1 - first::2], n_chains // 2)
                else:
                    # too few chains to split: one shared estimate (r = 1)
                    c_a = c_b = batch_cov(x_flat, n_chains)
                a_new = alpha * c_a + (1.0 - alpha) * cov_a
                b_new = alpha * c_b + (1.0 - alpha) * cov_b
                # a non-finite batch (diverged chains) leaves the EMAs as they were
                finite = torch.isfinite(a_new).all() & torch.isfinite(b_new).all()
                cov_a = torch.where(finite, a_new, cov_a)
                cov_b = torch.where(finite, b_new, cov_b)
                t = t + 1
            da, step_size = mstate.da, mstate.step_size
            if tune_step:
                da, step_size = da_update_step_size(da, chain_mean(mask.to(torch.float32), shard),
                                                    da_params)
            new = DenseMetropolisState(step_size=step_size, cov_a=cov_a, cov_b=cov_b, chol=chol,
                                       chol_inv=chol_inv, jitter_frac=jitter_frac, t=t, mu=mu_c,
                                       scalar_mode=scalar_mode, r_low_streak=streak, da=da)
            # the refresh reads the EMA halves and writes the factors, the
            # mode and the streak; the dual averaging touches none of them
            if refresh is not None and tune_metric and n_chains > 1 \
                    and int(t) % refresh_every == 0:
                new = refresh(new)
            return new

        return update


class DenseHMC(_DenseMetricMixin, HMC):
    """HMC with a dense metric; see the module docstring."""

    multi_rank_chains = True
    # the iteration without the refresh: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[DenseHMCKernel] = None,
                 params: Optional[DenseHMCParameters] = None, device=None):
        if kernel is None:
            kernel = DenseHMCKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = DenseHMCParameters()
        super(HMC, self).__init__(event_shape, target, kernel, params, device=device)

    @property
    def name(self):
        return "DenseHMC"

    # ---- metric hooks (A = chol(Sigma), Sigma = M^{-1}) ----------------------
    def _jitter_frac(self, mstate):
        # scalar mode runs jitter-free, which also keeps the dense math equal
        # to the scalar math there
        return mstate.jitter_frac * (1.0 - mstate.scalar_mode.to(torch.float32))

    def _momentum(self, mstate, p_raw):
        # rows xi^T A^{-1}: p ~ N(0, Sigma^{-1}) = N(0, M)
        return p_raw @ mstate.chol_inv

    def _precondition(self, mstate, v):
        w = flatten_event(v, self.event_shape) @ mstate.chol  # (A^T v)^T
        return (w @ mstate.chol.T).reshape(v.shape)

    def _kinetic(self, mstate, p):
        w = flatten_event(p, self.event_shape) @ mstate.chol  # (A^T p)^T
        return 0.5 * (w * w).sum(-1)  # 0.5 p^T Sigma p, whitened

    # ---- the scalar math (Sigma = mu I) ------------------------------------------
    def _momentum_scalar(self, mstate, p_raw):
        return p_raw / torch.sqrt(torch.clamp(mstate.mu, min=1e-12))

    def _precondition_scalar(self, mstate, v):
        return v * mstate.mu

    def _kinetic_scalar(self, mstate, p):
        p_flat = flatten_event(p, self.event_shape)
        return 0.5 * mstate.mu * (p_flat * p_flat).sum(-1)

    def make_propose_aux(self):
        if getattr(self, "_build_scalar", False):
            return self._build_propose_aux(self._momentum_scalar, self._precondition_scalar,
                                           self._kinetic_scalar, lambda mstate: 0.0)
        return self._build_propose_aux(self._momentum, self._precondition, self._kinetic,
                                       self._jitter_frac)


class DenseMALA(_DenseMetricMixin, Langevin):
    """MALA with the dense preconditioner ``Sigma``: drift ``-tau Sigma grad
    U``, noise ``sqrt(2 tau) chol(Sigma) xi``; see the module docstring."""

    multi_rank_chains = True
    # the iteration without the refresh: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[DenseLangevinKernel] = None,
                 params: Optional[DenseLangevinParameters] = None, device=None):
        if kernel is None:
            kernel = DenseLangevinKernel(event_size=event_size_of(event_shape))
        if params is None:
            params = DenseLangevinParameters()
        super(Langevin, self).__init__(event_shape, target, kernel, params, device=device)
        self.params.adjustment = True

    @property
    def name(self):
        return "DenseMALA"

    def _sigma_apply(self, mstate, v_flat):
        return (v_flat @ mstate.chol) @ mstate.chol.T  # rows (Sigma v)^T

    # Langevin's step binds these at build time: the scalar forms only when
    # the build was flagged scalar
    @property
    def _drift_noise(self):
        if getattr(self, "_build_scalar", False):
            return self._drift_noise_scalar
        return self._drift_noise_dense

    @property
    def _proposal_potential(self):
        if getattr(self, "_build_scalar", False):
            return self._proposal_potential_scalar
        return self._proposal_potential_dense

    def _drift_noise_dense(self, mstate, g_flat, noise_flat):
        tau = mstate.step_size
        colored = noise_flat @ mstate.chol.T  # (A xi)^T
        return -tau * self._sigma_apply(mstate, g_flat) + torch.sqrt(2.0 * tau) * colored

    def _drift_noise_scalar(self, mstate, g_flat, noise_flat):
        tau = mstate.step_size
        mu = torch.clamp(mstate.mu, min=1e-12)
        return -tau * mu * g_flat + torch.sqrt(2.0 * tau * mu) * noise_flat

    def _proposal_potential_dense(self, mstate, x_prime_flat, x_flat, grad_u_x_flat):
        tau = mstate.step_size
        term = x_prime_flat - x_flat + tau * self._sigma_apply(mstate, grad_u_x_flat)
        w = term @ mstate.chol_inv.T  # (A^{-1} r)^T
        return (w * w).sum(-1) / (4.0 * tau)  # ||r||^2_{Sigma^{-1}} / (4 tau)

    def _proposal_potential_scalar(self, mstate, x_prime_flat, x_flat, grad_u_x_flat):
        tau = mstate.step_size
        mu = torch.clamp(mstate.mu, min=1e-12)
        term = x_prime_flat - x_flat + tau * mu * grad_u_x_flat
        return (term * term).sum(-1) / (4.0 * tau * mu)

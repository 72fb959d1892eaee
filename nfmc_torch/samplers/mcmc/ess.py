"""Elliptical slice sampling (Murray, Adams & MacKay 2010), vectorised over
chains (counterpart of ``nfmc_tpu/samplers/mcmc/ess.py``).

* ellipse ``nu ~ N(0, cov)``, threshold ``log y = -nll(f) + log u``,
  bracket ``[theta - 2 pi, theta]`` and a fixed ``max_iterations = 5``
  shrink loop with first-accept-wins masks;
* the all-accept hack ``mask = ones`` of the reference (only a non-finite
  state is refused);
* the current state's nll rides in the carried state, saving the leading
  evaluation; the counters keep ``(max_iterations + 1) B`` target calls
  an iteration and no gradient call;
* ``sample`` discards ``x0`` and redraws it from the prior (the reference's
  quirk); ``sample_continue`` keeps it;
* the warmup-only ellipse adaptation (diagonal or dense) replaces the prior
  ``N(0, cov)`` by ``N(0, S)`` and folds the correction into the
  likelihood, so that the sampled law stays the same.

The whitening products run in full float32 (the JAX package asks for
``precision="highest"``); nothing in the port enables TF32.

The JAX package runs a chunk as one ``lax.scan`` of the step, its shrink
loop a ``lax.fori_loop`` of ``max_ess_step_iterations`` trips. Here the
loop is unrolled in the step, and on CUDA a chunk is replays of one
captured CUDA graph of it (:mod:`nfmc_torch.core.graphs`), the carried
``nll`` a tensor and the shrink uniforms hoisted with the chunk's draws.
The prior redraw of ``sample`` and the warmup's ellipse adaptation run
outside the chunks.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...core.driver import StepInfo
from ...core.output import MCMCOutput
from ...core.sampler import MCMCKernel, MCMCParameters
from ...utils import event_size_of, get_batch_shape
from .base import MCMCSampler


@dataclasses.dataclass
class ESSState:
    """The prior covariance's Cholesky factor on the device, or None."""

    chol: Optional[torch.Tensor]


@dataclass
class ESSKernel(MCMCKernel):
    event_shape: Tuple[int, ...] = ()
    cov: Optional[np.ndarray] = None

    def __post_init__(self):
        super().__post_init__()
        self.event_shape = tuple(self.event_shape)

    def make_state(self, device) -> ESSState:
        if self.cov is None:
            return ESSState(chol=None)
        return ESSState(chol=torch.linalg.cholesky(
            torch.as_tensor(np.asarray(self.cov), dtype=torch.float32, device=device)))

    def sync_from_state(self, state: ESSState) -> None:
        pass

    def __repr__(self):
        return "ESS kernel"


@dataclass
class ESSParameters(MCMCParameters):
    max_ess_step_iterations: int = 5
    # warmup-only ellipse adaptation (the reference's ESS has no warmup):
    # the ellipse covariance follows the warmup draws' variance, with a
    # prior correction folded into the likelihood
    tune_ellipse: bool = True
    min_ellipse_variance: float = 1e-6
    # the dense warmup covariance, shrunk toward its diagonal
    dense_ellipse: bool = False
    # the shrinkage weight toward diag(cov); None = clip(d / n, 0.05, 1)
    ellipse_shrinkage: Optional[float] = None


def ess_step_draws(generator: torch.Generator, prefix: Tuple[int, ...], n_chains: int,
                   event_shape: Tuple[int, ...], max_iterations: int, use_chol: bool):
    """One ESS step's randomness for ``prefix`` iterations: the ellipse's
    raw normals ``(*prefix, C, d)`` with a Cholesky factor, else ``(*prefix,
    C, *event)``; the threshold uniforms ``(*prefix, C)``; the bracket angle
    uniforms and the shrink uniforms ``(*prefix, C, 1...)`` and ``(*prefix,
    max_iterations, C, 1...)`` (the layout of ``ess_step_draws`` in
    ``nfmc_tpu``)."""
    dev = generator.device
    ones = (1,) * len(event_shape)
    shape_z = (*prefix, n_chains, event_size_of(event_shape)) if use_chol else (
        *prefix, n_chains, *event_shape)
    z = torch.randn(shape_z, generator=generator, device=dev)
    u = torch.rand((*prefix, n_chains), generator=generator, device=dev)
    theta0 = torch.rand((*prefix, n_chains, *ones), generator=generator, device=dev)
    shrink = torch.rand((*prefix, max_iterations, n_chains, *ones), generator=generator,
                        device=dev)
    return z, u, theta0, shrink


def elliptical_slice_sampling_step(f: torch.Tensor, negative_log_likelihood: Callable,
                                   event_shape: Tuple[int, ...], draws, chol=None,
                                   max_iterations: int = 5, nll_f=None):
    """One vectorised ESS step with the draws ``(z, u, theta0, shrink)``:
    once a chain accepts, its proposal is frozen while the bracket keeps
    shrinking for the others. ``nll_f`` carries the current state's nll.
    Returns ``(f', nll(f'), accepted)``."""
    batch_shape = get_batch_shape(f, event_shape)
    expand = (*batch_shape, *([1] * len(event_shape)))
    z, u, theta0, shrink = draws
    nu = z.reshape(f.shape) if chol is None else (z @ chol.T).reshape(f.shape)
    if nll_f is None:
        nll_f = negative_log_likelihood(f)
    log_y = -nll_f + torch.log(u)
    theta = theta0 * (2.0 * math.pi)
    theta_min = theta - 2.0 * math.pi
    theta_max = theta
    accepted = torch.zeros(batch_shape, dtype=torch.bool, device=f.device)
    f_proposed, nll_proposed = f, nll_f
    for i in range(max_iterations):
        f_prime = f * torch.cos(theta) + nu * torch.sin(theta)
        nll_prime = negative_log_likelihood(f_prime)
        newly = (-nll_prime > log_y) & ~accepted
        f_proposed = torch.where(newly.reshape(expand), f_prime, f_proposed)
        nll_proposed = torch.where(newly, nll_prime, nll_proposed)
        theta_neg = theta < 0
        theta_min = torch.where(theta_neg, theta, theta_min)
        theta_max = torch.where(theta_neg, theta_max, theta)
        theta = shrink[i] * (theta_max - theta_min) + theta_min
        accepted = accepted | newly
    return f_proposed, nll_proposed, accepted


class ESS(MCMCSampler):
    multi_rank_chains = True
    draw_chain_axes = (0, 0, 0, 1)  # the shrink uniforms hold the shrink steps first
    # chunks replay a CUDA graph of the step
    graph_capturable = True

    def __init__(self, event_shape, target, negative_log_likelihood,
                 kernel: Optional[ESSKernel] = None, params: Optional[ESSParameters] = None,
                 device=None):
        if kernel is None:
            kernel = ESSKernel(event_shape)
        if params is None:
            params = ESSParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        self.negative_log_likelihood = negative_log_likelihood
        # the user's decomposition; the ellipse adaptation rewrites
        # negative_log_likelihood / kernel.cov relative to these, so that a
        # repeated warmup stays exact
        self._base_nll = negative_log_likelihood
        self._base_cov = None if kernel.cov is None else np.asarray(kernel.cov, dtype=np.float64)

    @property
    def name(self):
        return "ESS"

    def _augment_state(self, mstate, x0):
        return (mstate, self.negative_log_likelihood(x0))

    def make_draws(self):
        event_shape = self.event_shape
        max_iterations = self.params.max_ess_step_iterations
        use_chol = self.kernel.cov is not None

        def draws(generator, prefix, n_chains):
            return ess_step_draws(generator, prefix, n_chains, event_shape, max_iterations,
                                  use_chol)

        return draws

    def _static_config(self, per_iter) -> tuple:
        # the step closes over the likelihood, which the warmup's ellipse
        # adaptation replaces: the config holds it, so that a new one builds
        # a new driver (and its graphs) and an old id is never reused
        return super()._static_config(per_iter) + (self.negative_log_likelihood,)

    def hoisted_elements_per_iter(self, x) -> int:
        # z (C d) + u (C) + theta0 (C) + shrink (max_iter C): for small d the
        # shrink uniforms dominate
        d = x.numel() // max(int(x.shape[0]), 1)
        return self._n_global(int(x.shape[0])) * (d + 2 + int(self.params.max_ess_step_iterations))

    def _make_step_aux(self, tuning: bool):
        """The carried-likelihood step: ``(x, (mstate, nll(x)), draws)``."""
        nll = self.negative_log_likelihood
        event_shape = self.event_shape
        max_iterations = self.params.max_ess_step_iterations

        def step(x, state, draws):
            mstate, nll_x = state
            n_chains = x.shape[0]
            x_prime, nll_prime, _accepted = elliptical_slice_sampling_step(
                x, nll, event_shape, draws, chol=mstate.chol, max_iterations=max_iterations,
                nll_f=nll_x)
            # the all-accept hack of the reference: every finite state moves
            finite = torch.isfinite(x_prime.reshape(n_chains, -1)).all(-1)
            x_new = torch.where(finite.reshape(finite.shape + (1,) * len(event_shape)), x_prime, x)
            nll_new = torch.where(finite, nll_prime, nll_x)
            info = StepInfo(n_accepted=finite.sum().to(torch.int32),
                            diverged=(~finite.all()).to(torch.int32))
            return x_new, (mstate, nll_new), info

        return step

    def calls_per_iter(self, n_chains: int) -> int:
        return (self.params.max_ess_step_iterations + 1) * n_chains

    def grads_per_iter(self, n_chains: int) -> int:
        return 0

    # ---- the prior redraw (sample's quirk, and the jump runner's hook) ----
    def resample_x0_draws(self, generator: torch.Generator, prefix: Tuple[int, ...],
                          n_chains: int) -> torch.Tensor:
        """Raw normals for ``prefix`` prior redraws of ``n_chains`` chains."""
        d = event_size_of(self.event_shape)
        shape = (*prefix, n_chains, d) if self.kernel.cov is not None else (
            *prefix, n_chains, *self.event_shape)
        return torch.randn(shape, generator=generator, device=generator.device)

    def _redraw_x0(self, generator: torch.Generator, x0: torch.Tensor) -> torch.Tensor:
        """A prior draw for the (global) chains, this rank's rows of it."""
        z = self.resample_x0_draws(generator, (), self._n_global(x0.shape[0]))
        return self.resample_x0_fn(self._chain_rows(z, 0), x0)

    def resample_x0_fn(self, z: torch.Tensor, x: torch.Tensor,
                       state: Optional[ESSState] = None) -> torch.Tensor:
        """A prior draw ``N(0, cov)`` from the raw normals ``z``, shaped as
        ``x``, with the Cholesky factor of the carried ``state`` (the jump
        runner's, which makes no tensor inside its step) or else of the
        kernel."""
        chol = (self.kernel.make_state(x.device) if state is None else state).chol
        if chol is None:
            return z.reshape(x.shape)
        return (z @ chol.T).reshape(x.shape)

    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """The reference's quirk: ``x0`` is redrawn from the prior (its
        shape and device are kept)."""
        generator = self._generator(generator, seed)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        x0 = self._redraw_x0(generator, x0)
        return super().sample(x0, show_progress=show_progress,
                              time_limit_seconds=time_limit_seconds, generator=generator)

    def sample_continue(self, x0, show_progress: bool = True, time_limit_seconds=None,
                        generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """Continue from ``x0`` itself; the prior redraw ``sample`` would make
        is drawn and dropped, so that a run cut into segments draws the same
        stream as ``sample``."""
        generator = self._generator(generator, seed)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        self.resample_x0_draws(generator, (), self._n_global(x0.shape[0]))
        return super().sample(x0, show_progress=show_progress,
                              time_limit_seconds=time_limit_seconds, generator=generator)

    # ---- the warmup's ellipse adaptation ------------------------------------
    def _apply_ellipse_adaptation(self, cov: np.ndarray) -> None:
        """Replace the prior ``N(0, cov_base)`` by ``N(0, S)`` and the
        likelihood by ``nll_base(x) + log N(x; 0, S) - log N(x; 0,
        cov_base)``, so that their product, the sampled law, is unchanged.
        ``cov`` is 1-d (variances) or 2-d (a dense covariance). Both Gaussian
        terms are taken in whitened coordinates, from inverse Cholesky
        factors computed in float64 on the host, with float32 products on
        the device."""
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim == 1:
            var = np.maximum(cov.reshape(-1), self.params.min_ellipse_variance)
            S = np.diag(var)
            chol_new64 = np.diag(np.sqrt(var))
            logdet_new = float(np.sum(np.log(var)))
        else:
            d = cov.shape[0]
            S = 0.5 * (cov + cov.T)
            S[np.diag_indices(d)] = np.maximum(np.diag(S), self.params.min_ellipse_variance)
            try:
                chol_new64 = np.linalg.cholesky(S)
            except np.linalg.LinAlgError:
                # degenerate warmup draws: the diagonal of the estimate
                S = np.diag(np.maximum(np.diag(S), self.params.min_ellipse_variance))
                chol_new64 = np.sqrt(S)
            logdet_new = 2.0 * float(np.sum(np.log(np.diag(chol_new64))))
        base_nll = self._base_nll
        dev = self.device
        white_new = torch.as_tensor(np.linalg.inv(chol_new64).T, dtype=torch.float32, device=dev)
        if self._base_cov is None:
            white_old, logdet0 = None, 0.0
        else:
            chol0 = np.linalg.cholesky(self._base_cov)
            white_old = torch.as_tensor(np.linalg.inv(chol0).T, dtype=torch.float32, device=dev)
            logdet0 = 2.0 * float(np.sum(np.log(np.diag(chol0))))

        def corrected_nll(x):
            xf = x.reshape(x.shape[0], -1)
            y = xf @ white_new
            lp_new = -0.5 * (y * y).sum(-1) - 0.5 * logdet_new
            if white_old is None:
                lp_old = -0.5 * (xf * xf).sum(-1)
            else:
                y0 = xf @ white_old
                lp_old = -0.5 * (y0 * y0).sum(-1) - 0.5 * logdet0
            return base_nll(x) + (lp_new - lp_old)

        self.negative_log_likelihood = corrected_nll
        self.kernel.cov = S.astype(np.float32)
        # the raw float64 input, for the resumable state: restoring replays
        # this adaptation on it and takes the same branch
        self._adapted_cov64 = cov.copy()

    def extra_resumable_state(self):
        """The adapted ellipse, outside the kernel state: restoring it
        re-derives the corrected likelihood exactly."""
        cov = getattr(self, "_adapted_cov64", None)
        return {} if cov is None else {"ellipse_cov": cov}

    def restore_extra_resumable_state(self, state) -> None:
        if "ellipse_cov" in state:
            self._apply_ellipse_adaptation(np.asarray(state["ellipse_cov"], dtype=np.float64))

    def _warmup_ellipse_covariance(self, out: MCMCOutput) -> Optional[np.ndarray]:
        """The adaptation's covariance: dense (shrunk toward its diagonal)
        from the stored warmup draws' second half when
        ``params.dense_ellipse``, else the streaming per-dimension
        variance. Sharded, every rank adapts to the draws of all the chains
        (gathered) and to the variance the flushes summed over the ranks."""
        if self.params.dense_ellipse:
            ok = out.samples is not None
            if ok:
                draws = out.samples
                if self.chain_shard is not None:
                    draws = self.chain_shard.gather(draws, axis=1)
                draws = np.asarray(draws.cpu(), dtype=np.float64)  # (K, C, *event)
                flat = draws.reshape(-1, int(np.prod(draws.shape[2:])))
                flat = flat[flat.shape[0] // 2:]
                n, d = flat.shape
                ok = n >= 8 and bool(np.all(np.isfinite(flat)))
            if ok:
                C = np.cov(flat.T).reshape(d, d)
                lam = self.params.ellipse_shrinkage
                if lam is None:
                    lam = float(np.clip(d / max(n, 1), 0.05, 1.0))
                return (1.0 - lam) * C + lam * np.diag(np.diag(C))
            print("Warning: dense_ellipse=True but warmup draws are unavailable/"
                  "too few/non-finite; falling back to diagonal variance adaptation")
        var = np.asarray(out.statistics.running_variance, dtype=np.float64).reshape(-1)
        if var.size and np.all(np.isfinite(var)) and np.any(var > 0):
            return var
        return None

    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None):
        """A warmup run (the draws ``(n_warmup, C, *event)``), then, with
        ``params.tune_ellipse``, the ellipse adaptation to its covariance."""
        out = super().warmup(x0, show_progress=show_progress,
                             time_limit_seconds=time_limit_seconds, generator=generator,
                             seed=seed)
        if self.params.tune_ellipse:
            cov = self._warmup_ellipse_covariance(out)
            if cov is not None:
                self._apply_ellipse_adaptation(cov)
        return out

"""Parallel tempering (replica exchange) with MALA, random-walk or HMC moves
within each rung (counterpart of ``nfmc_tpu/samplers/mcmc/pt.py``).

A ladder of ``n_temps`` inverse temperatures ``1 = beta_0 > ... >
beta_{T-1}`` moves against the tempered potentials ``beta_k U`` every
iteration, then swaps neighbouring rungs in a deterministic even/odd sweep,
accepting with ``log alpha = (beta_i - beta_j) (U(x_i) - U(x_j))``.

The whole ladder is one batch: positions ``(T, C, *event)`` move in one
``(T C)``-row target evaluation an iteration (PT-HMC: one a leapfrog, a
Python loop of ``n_leapfrog_steps`` fused gradient passes). The swap
partners are a fixed permutation for each parity, the two stacked and
indexed on the device by the parity of the iteration counter ``i``, a 0-d
int32 tensor carried as the JAX package's is; the ladder's ``kappa`` is
computed from it on the device too. The per-rung dual averaging, the
Vousden-style ladder adaptation (tuning only) and the swap counters are
tensors carried on the device; the swap counters and ``i`` reach the host
in ``sync_from_state``'s one copy. The run's chain state is the cold rung:
stored draws, moments and acceptance are those of ``beta = 1``.

The JAX package runs a chunk as one ``lax.scan`` of this step; on CUDA
with one rank a chunk here is replays of one captured CUDA graph of it
(:mod:`nfmc_torch.core.graphs`). Over several ranks every step sums the
swap counts over them (``collective_step``), and the run is the eager loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core.chains import chain_mean, chain_var
from ...core.driver import StepInfo
from ...core.output import MCMCOutput
from ...core.sampler import MCMCKernel, MCMCParameters
from ...core.statistics import PTStatistics
from ...core.tuning import DualAveragingParams, DualAveragingState, da_step
from ...utils import value_and_batched_grad
from .base import MCMCSampler


@dataclasses.dataclass
class PTState:
    """The ladder's state, tensors on the device."""

    betas: torch.Tensor  # (T,) descending, betas[0] = 1
    step_sizes: torch.Tensor  # (T,)
    da: DualAveragingState  # leaves of shape (T,)
    inv_mass_diag: torch.Tensor  # (event_size,)
    i: torch.Tensor  # i32 scalar: iterations run (the swap parity, the ladder's kappa)
    swap_accepts: torch.Tensor  # (T-1,) i32 accepted swaps an edge
    swap_attempts: torch.Tensor  # (T-1,) i32 attempted swaps an edge
    swap_rate_ema: torch.Tensor  # (T-1,) f32 acceptance EMA an edge


@dataclass
class PTKernel(MCMCKernel):
    """Tunable state of the ladder.

    ``betas`` (descending, first 1.0) wins over ``n_temps``/``beta_min``;
    by default the ladder is geometric from 1 to ``beta_min``.
    ``step_sizes`` are per rung, by default ``step_size * beta_k^(-1/2)``.
    In d dimensions healthy swap rates need about ``1 + log(1/beta_min)
    sqrt(d/2)`` rungs; the default 8 suits low-dimensional multimodal
    targets."""

    event_size: int = 0
    n_temps: int = 8
    beta_min: float = 0.02
    betas: Optional[np.ndarray] = None
    n_leapfrog_steps: int = 10  # PTHMC only
    step_size: Optional[float] = None
    step_sizes: Optional[np.ndarray] = None
    inv_mass_diag: Optional[np.ndarray] = None
    da_params: Optional[DualAveragingParams] = None
    # set by sync_from_state after a run
    swap_acceptance_rates: Optional[np.ndarray] = None
    n_accepted_swaps: int = 0
    n_attempted_swaps: int = 0

    def __post_init__(self):
        super().__post_init__()
        # the ladder and the steps in numpy, float64 then float32, as the JAX
        # package builds them: both packages start from the same bits
        if self.betas is None:
            self.betas = np.geomspace(1.0, self.beta_min, self.n_temps).astype(np.float32)
        else:
            self.betas = np.asarray(self.betas, dtype=np.float32)
            if self.betas.ndim != 1 or self.betas[0] != 1.0:
                raise ValueError("betas must be 1-D with betas[0] == 1.0")
            if np.any(np.diff(self.betas) >= 0):
                raise ValueError("betas must be strictly decreasing")
            self.n_temps = len(self.betas)
        if self.step_size is None:
            self.step_size = self.event_size ** (-1.0 / 3.0)
        if self.step_sizes is None:
            self.step_sizes = (self.step_size * self.betas ** (-0.5)).astype(np.float32)
        else:
            self.step_sizes = np.asarray(self.step_sizes, dtype=np.float32)
            if self.step_sizes.shape != self.betas.shape:
                raise ValueError("step_sizes must match betas")
        if self.inv_mass_diag is None:
            self.inv_mass_diag = np.ones(self.event_size, dtype=np.float32)
        else:
            self.inv_mass_diag = np.asarray(self.inv_mass_diag, dtype=np.float32)
        if self.da_params is None:
            self.da_params = DualAveragingParams()

    def make_state(self, device) -> PTState:
        T = self.n_temps
        steps = torch.as_tensor(self.step_sizes, dtype=torch.float32, device=device)
        da = getattr(self, "_resume_da", None)
        if da is None:
            da = DualAveragingState(
                t=torch.full((T,), float(self.da_params.t0), dtype=torch.float32, device=device),
                error_sum=torch.zeros((T,), dtype=torch.float32, device=device),
                log_step_averaged=torch.log(steps),
                mu=torch.log(10.0 * steps),
            )
        else:
            da = da.to(device)
        return PTState(
            betas=torch.as_tensor(self.betas, dtype=torch.float32, device=device),
            step_sizes=steps,
            da=da,
            inv_mass_diag=torch.as_tensor(self.inv_mass_diag, dtype=torch.float32, device=device),
            # the counter continues across runs, so the swap parity resumes
            i=torch.tensor(int(getattr(self, "_resume_i", 0)), dtype=torch.int32, device=device),
            swap_accepts=torch.zeros((T - 1,), dtype=torch.int32, device=device),
            swap_attempts=torch.zeros((T - 1,), dtype=torch.int32, device=device),
            swap_rate_ema=torch.zeros((T - 1,), dtype=torch.float32, device=device),
        )

    def sync_from_state(self, state: PTState) -> None:
        # one device-to-host copy for everything the kernel reads
        T, d = state.betas.shape[0], state.inv_mass_diag.shape[0]
        host = torch.cat([state.betas, state.step_sizes, state.inv_mass_diag,
                          state.swap_rate_ema]).to(torch.float64)
        counts = torch.stack([state.swap_accepts.sum(), state.swap_attempts.sum(),
                              state.i.to(torch.int64)])
        host = torch.cat([host, counts.to(torch.float64)]).cpu().numpy()
        self.betas = host[:T].astype(np.float32)
        self.step_sizes = host[T:2 * T].astype(np.float32)
        self.step_size = float(self.step_sizes[0])
        self.inv_mass_diag = host[2 * T:2 * T + d].astype(np.float32)
        self.swap_acceptance_rates = host[2 * T + d:-3].astype(np.float32)
        self.n_accepted_swaps = int(host[-3])
        self.n_attempted_swaps = int(host[-2])
        # each rung's dual averaging continues in a later run
        self._resume_da = state.da
        self._resume_i = int(host[-1])

    def __repr__(self):
        rates = self.swap_acceptance_rates
        swap = f", swap-rates {np.round(rates, 2)}" if rates is not None else ""
        return (f"T={self.n_temps}, beta_min={float(self.betas[-1]):.3g}, "
                f"cold step {float(self.step_sizes[0]):.3g}{swap}")


@dataclass
class PTParameters(MCMCParameters):
    tune_step_size: bool = True
    tune_inv_mass_diag: bool = True
    tune_ladder: bool = True
    imd_adjustment: float = 1e-3
    # Vousden et al. 2016 eq. (12): kappa(t) = kappa0 / (1 + t / t0_ladder)
    ladder_kappa0: float = 0.1
    ladder_t0: float = 100.0
    swap_ema_alpha: float = 0.05


def _partner_perm(n_temps: int, offset: int) -> np.ndarray:
    """The swap partners of the even (offset 0) or odd (offset 1) sweep;
    an unpaired rung maps to itself."""
    p = np.arange(n_temps)
    for k in range(offset, n_temps - 1, 2):
        p[k], p[k + 1] = k + 1, k
    return p


class ParallelTempering(MCMCSampler):
    """The shared ladder; the subclasses choose the move within a rung."""

    move: str = "mala"  # "mala" (PTMALA), "rwmh" (PTRWMH), "hmc" (PTHMC)
    draw_chain_axes = (1, 1, 1)  # the draws hold the rungs first
    collective_step = True  # the swap counts, summed over the ranks every step

    def __init__(self, event_shape, target, kernel: Optional[PTKernel] = None,
                 params: Optional[PTParameters] = None, device=None):
        if kernel is None:
            kernel = PTKernel(event_size=int(np.prod(event_shape)))
        if params is None:
            params = PTParameters()
        super().__init__(event_shape, target, kernel, params, device=device)

    @property
    def use_grad(self) -> bool:
        """Whether the move carries a gradient cache."""
        return self.move in ("mala", "hmc")

    @property
    def name(self):
        return f"PT-{self.move.upper()}"

    def _make_output(self) -> MCMCOutput:
        return MCMCOutput(self.event_shape, statistics=PTStatistics(self.event_shape),
                          store_samples=self.params.store_samples,
                          on_device=self.params.store_samples_on_device)

    def _post_run(self, out: MCMCOutput) -> None:
        out.statistics.update_counters(n_accepted_swaps=self.kernel.n_accepted_swaps,
                                       n_attempted_swaps=self.kernel.n_attempted_swaps)

    def hoisted_elements_per_iter(self, x: torch.Tensor) -> int:
        """The draws are ladder-wide: noise ``(T, C, *event)`` and two ``(T,
        C)`` uniform fields an iteration (over the global chains)."""
        T, n_chains = self.kernel.n_temps, self._n_global(x.shape[0])
        return T * n_chains * (self.event_size + 2)

    # ---- state -------------------------------------------------------------
    def _augment_state(self, ptstate: PTState, x0):
        T = self.kernel.n_temps
        xs = x0[None].expand(T, *x0.shape)  # every rung starts at x0
        hot = getattr(self, "_continue_hot", None)
        if getattr(self, "_use_continue_hot", False) and hot is not None:
            # the stash holds every chain's hot rungs: this rank's rows
            hot = self._chain_rows(torch.as_tensor(hot, dtype=torch.float32, device=x0.device), 1)
            if hot.shape != xs[1:].shape:
                raise ValueError(
                    f"PT continuation hot-rung state has shape {tuple(hot.shape)} "
                    f"but this run needs {tuple(xs[1:].shape)} — was the "
                    "ladder (n_temps) or chain count changed since the "
                    "checkpoint?"
                )
            # a continuation: the hot replicas resume where the last run
            # left them instead of collapsing onto the cold state
            xs = torch.cat([x0[None], hot], 0)
        xs = xs.contiguous()
        flat = xs.reshape(T * x0.shape[0], *self.event_shape)
        if self.use_grad:
            u, g = value_and_batched_grad(self.target)(flat)
            return (ptstate, xs[1:], u.reshape(T, -1), g.reshape(xs.shape))
        return (ptstate, xs[1:], self.target(flat).reshape(T, -1))

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (noise, log_u_move,
        log_u_swap)``: ``(*prefix, T, C, *event)`` and twice ``(*prefix, T,
        C)``."""
        T = self.kernel.n_temps
        event_shape = self.event_shape

        def draws(generator, prefix, n_chains):
            dev = generator.device
            noise = torch.randn((*prefix, T, n_chains, *event_shape), generator=generator,
                                device=dev)
            log_u_move = torch.log(torch.rand((*prefix, T, n_chains), generator=generator,
                                              device=dev))
            log_u_swap = torch.log(torch.rand((*prefix, T, n_chains), generator=generator,
                                              device=dev))
            return noise, log_u_move, log_u_swap

        return draws

    # ---- the fused ladder step ---------------------------------------------
    def _make_step_aux(self, tuning: bool):
        target = self.target
        event_shape = self.event_shape
        event_ndim = len(event_shape)
        d = self.event_size
        T = self.kernel.n_temps
        p = self.params
        move = self.move
        use_grad = self.use_grad
        n_leapfrog = self.kernel.n_leapfrog_steps
        da_params = self.kernel.da_params
        u_and_grad = value_and_batched_grad(target)
        device = self.device
        shard = self.chain_shard
        # the two parities' tables, stacked: the partners, the rung whose
        # swap draw a pair shares, the rungs that have a partner, the edges
        # swept and their attempts; the step picks a row by i % 2
        rungs = np.arange(T)
        partners = np.stack([_partner_perm(T, 0), _partner_perm(T, 1)])  # (2, T)
        active = partners[:, :-1] == rungs[1:]
        sweeps = {
            "partner": torch.as_tensor(partners, device=device),
            "draw_row": torch.as_tensor(np.minimum(rungs, partners), device=device),
            "paired": torch.as_tensor(partners != rungs, device=device)[:, :, None],
            "edge_active": torch.as_tensor(active, device=device),
            "attempts": torch.as_tensor(np.where(active, 1, 0), dtype=torch.int32, device=device),
        }
        kappa0 = torch.tensor(p.ladder_kappa0, dtype=torch.float32, device=device)
        ladder_t0 = torch.tensor(p.ladder_t0, dtype=torch.float32, device=device)

        def step(x_cold, state, draws):
            if use_grad:
                pts, xs_hot, u_all, g_all = state
            else:
                pts, xs_hot, u_all = state
                g_all = None
            noise, log_u_move, log_u_swap = draws
            C = x_cold.shape[0]
            n_all = self._n_global(C)
            X = torch.cat([x_cold[None], xs_hot], 0)  # (T, C, *event)
            beta, tau, m = pts.betas, pts.step_sizes, pts.inv_mass_diag
            Xf = X.reshape(T, C, d)
            nf = noise.reshape(T, C, d)
            t_b = tau[:, None, None]
            b_b = beta[:, None, None]
            if move == "hmc":
                # HMC on beta_k U: leapfrogs with per-rung steps over the
                # (T C) batch, one gradient a position (the carried gradient
                # gives the first kick); the kicks temper the gradient, the
                # accept is on beta_k U + 0.5 p^T M^{-1} p
                p0 = nf / torch.sqrt(m)[None, None]
                xq, pq, gq, u_p = Xf, p0, g_all.reshape(T, C, d), u_all
                for _ in range(n_leapfrog):
                    pq = pq - 0.5 * t_b * (b_b * gq)
                    xq = xq + t_b * (m[None, None] * pq)
                    u_p, gq = u_and_grad(xq.reshape(T * C, *event_shape))
                    u_p = u_p.reshape(T, C)
                    gq = gq.reshape(T, C, d)
                    pq = pq - 0.5 * t_b * (b_b * gq)
                xpf = xq
                Xp = xpf.reshape(X.shape)
                g_p = gq.reshape(X.shape)
                finite_prop = torch.isfinite(xpf).all(-1)
                ke0 = 0.5 * (m[None, None] * p0 * p0).sum(-1)
                ke1 = 0.5 * (m[None, None] * pq * pq).sum(-1)
                log_ratio = beta[:, None] * (u_all - u_p) + ke0 - ke1
            elif use_grad:
                # MALA on beta_k U: the drift takes the tempered gradient
                gf = g_all.reshape(T, C, d)
                xpf = (Xf - t_b / (m[None, None] ** 2) * (b_b * gf)
                       + torch.sqrt(2.0 * t_b) / m[None, None] * nf)
                Xp = xpf.reshape(X.shape)
                finite_prop = torch.isfinite(xpf).all(-1)
                u_p, g_p = u_and_grad(Xp.reshape(T * C, *event_shape))
                u_p = u_p.reshape(T, C)
                g_p = g_p.reshape(X.shape)
                gpf = g_p.reshape(T, C, d)
                a = (1.0 / m ** 2)[None, None]

                def qpot(to_f, from_f, grad_from_f):
                    term = to_f - from_f + t_b * a * (b_b * grad_from_f)
                    return (term * (1.0 / a) * term).sum(-1) / (4.0 * t_b[..., 0])

                # beta (u - u') + log q(x | x') - log q(x' | x)
                log_ratio = (beta[:, None] * (u_all - u_p) - qpot(Xf, xpf, gpf)
                             + qpot(xpf, Xf, gf))
            else:
                xpf = Xf + t_b * m[None, None] * nf
                Xp = xpf.reshape(X.shape)
                finite_prop = torch.isfinite(xpf).all(-1)
                u_p = target(Xp.reshape(T * C, *event_shape)).reshape(T, C)
                g_p = None
                log_ratio = beta[:, None] * (u_all - u_p)

            finite = finite_prop & torch.isfinite(u_p)
            mask_move = (log_u_move < log_ratio) & finite  # (T, C)
            diverged = (~finite.all()).to(torch.int32)
            bmask = mask_move.reshape(T, C, *(1,) * event_ndim)
            X = torch.where(bmask, Xp, X)
            u_all = torch.where(mask_move, u_p, u_all)
            if use_grad:
                g_all = torch.where(bmask, g_p, g_all)

            # ---- the replica-exchange sweep, its parity read on the device ----
            parity = (pts.i % 2).reshape(1).to(torch.int64)
            sw = {k: v.index_select(0, parity)[0] for k, v in sweeps.items()}
            partner = sw["partner"]
            delta = (beta - beta[partner])[:, None] * (u_all - u_all[partner])
            swap_mask = (log_u_swap[sw["draw_row"]] < delta) & sw["paired"]  # (T, C)
            sb = swap_mask.reshape(T, C, *(1,) * event_ndim)
            X = torch.where(sb, X[partner], X)
            u_all = torch.where(swap_mask, u_all[partner], u_all)
            if use_grad:
                g_all = torch.where(sb, g_all[partner], g_all)

            edge_active = sw["edge_active"]
            edge_accepts = torch.where(edge_active, swap_mask[:-1].sum(1),
                                       torch.zeros((), dtype=torch.int64, device=X.device)
                                       ).to(torch.int32)
            if shard is not None and shard.size > 1:
                # the ladder adapts on every chain's swaps
                edge_accepts = shard.sum(edge_accepts)
            swap_accepts = pts.swap_accepts + edge_accepts
            swap_attempts = pts.swap_attempts + sw["attempts"] * n_all
            inst_rate = edge_accepts.to(torch.float32) / n_all
            ema = torch.where(edge_active,
                              (1.0 - p.swap_ema_alpha) * pts.swap_rate_ema
                              + p.swap_ema_alpha * inst_rate,
                              pts.swap_rate_ema)

            # ---- adaptation (tuning only) ----
            betas_new, steps_new, da, imd = beta, tau, pts.da, m
            if tuning:
                if p.tune_step_size:
                    acc_rate = chain_mean(mask_move.to(torch.float32), shard, dim=1)  # (T,)
                    da = da_step(da, da_params.target_acceptance_rate - acc_rate, da_params)
                    steps_new = torch.exp(da.log_step_averaged)
                if p.tune_inv_mass_diag and n_all > 1:
                    var = chain_var(X[0].reshape(C, -1), shard)
                    imd = p.imd_adjustment * var + (1.0 - p.imd_adjustment) * imd
                if p.tune_ladder and T >= 3:
                    temps = 1.0 / beta  # ascending
                    s = temps[1:] - temps[:-1]
                    # float32, in the JAX package's order: i.astype(f32) / t0
                    kappa = kappa0 / (1.0 + pts.i.to(torch.float32) / ladder_t0)
                    adj = torch.cat([ema[:-1] - ema[1:], ema.new_zeros(1)])
                    s = s * torch.exp(kappa * adj)
                    s = s * (temps[-1] - temps[0]) / s.sum()  # anchor the endpoints
                    temps = temps[0] + torch.cat([s.new_zeros(1), torch.cumsum(s, 0)])
                    betas_new = 1.0 / temps

            pts_new = PTState(betas=betas_new, step_sizes=steps_new, da=da, inv_mass_diag=imd,
                              i=pts.i + 1, swap_accepts=swap_accepts, swap_attempts=swap_attempts,
                              swap_rate_ema=ema)
            info = StepInfo(n_accepted=mask_move[0].sum().to(torch.int32), diverged=diverged)
            state_new = (pts_new, X[1:], u_all, g_all) if use_grad else (pts_new, X[1:], u_all)
            return X[0], state_new, info

        return step

    # The counters, per rung: an eager implementation evaluates U at the
    # current state and the proposal of every rung (2 T C calls), MALA both
    # gradients too (2 T C); HMC follows the trajectory contract (2 L T C
    # calls and gradients, plus 2 T C calls for the accept). Swaps reuse the
    # cached potentials.
    def calls_per_iter(self, n_chains: int) -> int:
        TC = self.kernel.n_temps * n_chains
        if self.move == "hmc":
            return (2 * self.kernel.n_leapfrog_steps + 2) * TC
        return 2 * TC

    def grads_per_iter(self, n_chains: int) -> int:
        TC = self.kernel.n_temps * n_chains
        if self.move == "hmc":
            return 2 * self.kernel.n_leapfrog_steps * TC
        return 2 * TC if self.use_grad else 0

    # ---- continuation and checkpoint hooks -----------------------------------
    def _stash_final_carry(self, mstate) -> None:
        """Keeps only the hot rungs' positions (``mstate[1]``), all that a
        continuation reads; the whole carry would pin every rung's potential
        and gradient caches for the sampler's lifetime. Sharded chains keep
        every rank's (a continuation takes its rows again)."""
        hot = mstate[1]
        if self.chain_shard is not None:
            hot = self.chain_shard.gather(hot, axis=1)
        self._final_mstate = (None, hot)

    def sample_continue(self, x0, **kwargs):
        """A continuation: the hot replicas start from the last run's final
        state (``sample`` starts every rung at ``x0``)."""
        st = getattr(self, "_final_mstate", None)
        if st is not None:
            self._continue_hot = st[1]  # (T-1, C, *event)
        self._use_continue_hot = True
        try:
            return self.sample(x0, **kwargs)
        finally:
            self._use_continue_hot = False

    def extra_resumable_state(self):
        """The checkpoint's extra state: the hot rungs' positions."""
        st = getattr(self, "_final_mstate", None)
        hot = st[1] if st is not None else getattr(self, "_continue_hot", None)
        if hot is None:
            return {}
        hot = hot.detach().cpu().numpy() if isinstance(hot, torch.Tensor) else np.asarray(hot)
        return {"pt_hot_rungs": hot}

    def restore_extra_resumable_state(self, state) -> None:
        if "pt_hot_rungs" in state:
            self._continue_hot = np.asarray(state["pt_hot_rungs"])
            # a retry in the same process resumes from the restored rungs,
            # not from a newer carry
            self._final_mstate = None


class PTMALA(ParallelTempering):
    """Parallel tempering with MALA moves within each rung."""

    move = "mala"
    multi_rank_chains = True
    # on one rank, chunks replay a CUDA graph of the ladder step
    graph_capturable = True


class PTRWMH(ParallelTempering):
    """Parallel tempering with random-walk Metropolis moves within each rung
    (proposal scale ``step_k * inv_mass_diag``)."""

    move = "rwmh"
    multi_rank_chains = True
    # on one rank, chunks replay a CUDA graph of the ladder step
    graph_capturable = True


class PTHMC(ParallelTempering):
    """Parallel tempering with HMC moves within each rung:
    ``n_leapfrog_steps`` tempered leapfrogs an iteration, each one fused
    ``(T C)``-row gradient pass."""

    move = "hmc"
    multi_rank_chains = True
    # on one rank, chunks replay a CUDA graph of the ladder step
    graph_capturable = True

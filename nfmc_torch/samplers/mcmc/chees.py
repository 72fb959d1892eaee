"""ChEES-HMC: jittered HMC with a cross-chain adaptive trajectory length
(Hoffman, Radul & Sountsov, AISTATS 2021); counterpart of
``nfmc_tpu/samplers/mcmc/chees.py``.

Every chain runs the same jittered trajectory length ``t = u T`` (``u`` in
(0, 1], the van der Corput sequence over the carried iteration counter by
default, or a uniform draw), ``L = clip(ceil(u T / eps), 1,
max_leapfrog_steps)`` leapfrogs. The step size is dual-averaged toward 0.651
on the mean acceptance probability; ``log T`` follows Adam (lr 0.025) on the
ChEES gradient estimated across chains and weighted by the acceptance
probabilities, clipped to ``[log eps, log(eps max_leapfrog_steps)]``; the
inverse mass follows the variance EMA.

The leapfrog count is a device scalar. Without tuning the step size and
``T`` are fixed, so ``L`` depends only on the iteration counter or the
drawn ``u``: the chunk's whole vector of ``L`` is computed up front on the
device, in float32 exactly as the step would; a tuning step computes its
own. The eager loop reads ``L`` on the host, once an iteration when tuning
and once a chunk otherwise, and runs ``L`` leapfrogs. A captured iteration
reads nothing: its leapfrogs are a loop on the device
(:func:`nfmc_torch.core.graphs.loop`, a WHILE node, the JAX package's
``lax.while_loop``), each next one while fewer than ``L`` ran. Both run
the same leapfrogs on the same numbers.

One gradient pass a position (L + 1 an iteration), each one autograd pass
that also gives U there, so the Hamiltonian's two ends cost no extra call.
The counters keep the reference contract through the dynamic channel:
``2 L C + 2 C`` target calls and ``2 L C`` gradient calls an iteration.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core import graphs
from ...core.chains import chain_mean
from ...core.driver import StepInfo
from ...core.sampler import MCMCKernel, MCMCParameters
from ...core.tuning import (
    DualAveragingParams,
    DualAveragingState,
    da_init,
    da_update_step_size,
    ema_inv_mass_diag,
)
from ...utils import flatten_event, sum_except_batch, value_and_batched_grad
from .base import MCMCSampler


def _van_der_corput(n: torch.Tensor, bits: int = 24) -> torch.Tensor:
    """Base-2 radical inverse of the int32 counters ``n`` (any shape): u in
    (0, 1), in float32."""
    ks = torch.arange(bits, dtype=torch.int32, device=n.device)
    n = n.to(torch.int32).unsqueeze(-1)
    rev = (((n >> ks) & 1) << (bits - 1 - ks)).sum(-1, dtype=torch.int32)
    return (rev.to(torch.float32) + 0.5) / float(1 << bits)


def leapfrog_count(u: torch.Tensor, log_t: torch.Tensor, step_size: torch.Tensor,
                   max_steps: int) -> torch.Tensor:
    """``clip(ceil(u exp(log_t) / eps), 1, max_steps)`` in float32, as int64
    (a count that is not finite is 1)."""
    steps = torch.ceil((u * torch.exp(log_t)) / step_size)
    steps = torch.where(torch.isnan(steps), torch.ones_like(steps), steps)
    return torch.clamp(steps, 1, max_steps).to(torch.int64)


@dataclasses.dataclass
class CheesState:
    """The numeric state a run carries on the device."""

    step_size: torch.Tensor  # f32 scalar
    inv_mass_diag: torch.Tensor  # (event_size,)
    da: DualAveragingState
    log_t: torch.Tensor  # f32 scalar: log trajectory length
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor  # f32 Adam step counter
    iter_idx: torch.Tensor  # int32 iteration counter (the jitter's index)


@dataclass
class CheesHMCKernel(MCMCKernel):
    """Tunable state: step size, diagonal inverse mass, trajectory length."""

    event_size: int = 0
    step_size: float = 0.1
    inv_mass_diag: Optional[np.ndarray] = None
    # total integration time; None starts at one leapfrog step
    trajectory_length: Optional[float] = None
    max_leapfrog_steps: int = 256
    adam_lr: float = 0.025
    # the jitter u: "halton" (van der Corput over the iteration counter) or
    # "uniform" (a draw an iteration)
    jitter: str = "halton"
    da_params: Optional[DualAveragingParams] = None

    def __post_init__(self):
        super().__post_init__()
        if self.inv_mass_diag is None:
            self.inv_mass_diag = np.ones(self.event_size, dtype=np.float32)
        else:
            self.inv_mass_diag = np.asarray(self.inv_mass_diag, dtype=np.float32)
        if self.trajectory_length is None:
            self.trajectory_length = float(self.step_size)
        if self.da_params is None:
            self.da_params = DualAveragingParams()
        if self.jitter not in ("halton", "uniform"):
            raise ValueError(f"jitter must be 'halton' or 'uniform', got {self.jitter!r}")

    def make_state(self, device) -> CheesState:
        def scalar(v, dtype=torch.float32):
            return torch.as_tensor(v, dtype=dtype, device=device).clone()

        resumed = getattr(self, "_resume_opt", None)
        if resumed is not None:
            da, adam_m, adam_v, adam_t, iter_idx = resumed
            da = da.to(device)
        else:
            da = da_init(self.step_size, self.da_params, device)
            adam_m = adam_v = adam_t = 0.0
            iter_idx = 0
        return CheesState(
            step_size=scalar(self.step_size),
            inv_mass_diag=torch.as_tensor(self.inv_mass_diag, dtype=torch.float32, device=device),
            da=da, log_t=scalar(math.log(self.trajectory_length)), adam_m=scalar(adam_m),
            adam_v=scalar(adam_v), adam_t=scalar(adam_t), iter_idx=scalar(iter_idx, torch.int32))

    def sync_from_state(self, state: CheesState) -> None:
        host = torch.cat([state.step_size.reshape(1), state.log_t.reshape(1),
                          state.inv_mass_diag.reshape(-1)]).cpu().numpy()
        self.step_size = float(host[0])
        self.trajectory_length = float(np.exp(host[1]))
        self.inv_mass_diag = host[2:]
        # the optimisers' states and the jitter's index carry over, so a
        # later run continues the adaptation instead of restarting it
        self._resume_opt = (state.da, state.adam_m, state.adam_v, state.adam_t, state.iter_idx)

    def __repr__(self):
        return (f"log step: {math.log(self.step_size):.2f}, "
                f"trajectory: {self.trajectory_length:.2f}, "
                f"mass norm: {float(np.max(np.abs(self.inv_mass_diag))):.2f}")


@dataclass
class CheesHMCParameters(MCMCParameters):
    # ChEES is always Metropolis-adjusted: both adaptations read the
    # per-chain acceptance probabilities
    tune_step_size: bool = True
    tune_trajectory: bool = True
    tune_inv_mass_diag: bool = True
    imd_adjustment: float = 1e-3


class CheesHMC(MCMCSampler):
    """HMC with a jittered, ChEES-adapted trajectory length (best with many
    chains: the ChEES gradient is a cross-chain estimate, over every rank's
    chains when they are sharded)."""

    multi_rank_chains = True
    draw_chain_axes = (0, 0, None)  # the jitter is one draw an iteration
    # the trajectory's leapfrogs are a loop on a device predicate
    # (``graphs.loop``): chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel: Optional[CheesHMCKernel] = None,
                 params: Optional[CheesHMCParameters] = None, device=None):
        if kernel is None:
            kernel = CheesHMCKernel(event_size=int(np.prod(event_shape)))
        if params is None:
            params = CheesHMCParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        # the leapfrog counts of every step taken, summed on the device by
        # the steps in place (a replay adds where the capture found it)
        self._leapfrogs = torch.zeros((), dtype=torch.int64, device=self.device)

    @property
    def leapfrog_total(self) -> int:
        """The leapfrogs of every step this sampler took (one host read)."""
        return int(self._leapfrogs)

    @property
    def name(self):
        return "ChEES-HMC"

    def make_draws(self):
        """``(generator, prefix, n_chains) -> (p_raw, log_u, u_jit)``: the
        momenta's raw normals ``(*prefix, C, event_size)``, the accept
        log-uniforms ``(*prefix, C)`` and the jitter ``u`` in (0, 1]
        ``prefix`` (unused with the halton jitter; drawn all the same)."""
        event_size = self.kernel.event_size

        def draws(generator, prefix, n_chains):
            dev = generator.device
            p_raw = torch.randn((*prefix, n_chains, event_size), generator=generator, device=dev)
            log_u = torch.log(torch.rand((*prefix, n_chains), generator=generator, device=dev))
            u_jit = 1.0 - torch.rand(prefix, generator=generator, device=dev)
            return p_raw, log_u, u_jit

        return draws

    def _jitter(self, cs: CheesState, u_jit: torch.Tensor, offset=None) -> torch.Tensor:
        """The jitter of the iteration(s) at ``iter_idx (+ offset)``."""
        if self.kernel.jitter != "halton":
            return u_jit
        # 1-based, as the paper: vdc(0) ~ 3e-8 would make a near-zero trajectory
        n = cs.iter_idx + 1 if offset is None else cs.iter_idx + 1 + offset
        return _van_der_corput(n)

    def _make_precompute(self, tuning: bool, graphed: bool = False):
        """Without tuning: the leapfrog counts of the chunk's iterations, in
        the order they run, with the draws' leading dims: on the device
        where the run replays graphs (a graph input), else copied to the
        host (one device-to-host copy a chunk)."""
        if tuning:
            return None
        max_steps = self.kernel.max_leapfrog_steps

        def precompute(x, state, draws):
            cs = self._extract_mstate(state)
            u_jit = draws[2]
            prefix = tuple(u_jit.shape)
            offset = torch.arange(u_jit.numel(), dtype=torch.int32, device=u_jit.device)
            u = self._jitter(cs, u_jit.reshape(-1), offset)
            counts = leapfrog_count(u, cs.log_t, cs.step_size, max_steps).reshape(prefix)
            return (counts,) if graphed else (counts.cpu(),)

        return precompute

    def _make_step_precomputed(self, tuning: bool):
        step = self._make_step(tuning)
        return lambda x, state, draws, aux: step(x, state, draws, aux[0])

    def _make_step_aux(self, tuning: bool):
        step = self._make_step(tuning)
        return lambda x, state, draws: step(x, state, draws, None)

    def _make_step(self, tuning: bool):
        """``step(x, state, draws, n_leapfrog)``: ``n_leapfrog`` None takes
        the count from the state on the device. Eagerly the count is read on
        the host (one synchronisation where it lies on the device); in a
        graph's body the leapfrogs are a loop that tests it on the
        device."""
        target = self.target
        event_shape = self.event_shape
        u_and_grad = value_and_batched_grad(target)
        p, kern = self.params, self.kernel
        max_steps, adam_lr, da_params = kern.max_leapfrog_steps, kern.adam_lr, kern.da_params
        tune_step = tuning and p.tune_step_size
        tune_traj = tuning and p.tune_trajectory
        tune_imd = tuning and p.tune_inv_mass_diag
        imd_adjustment = p.imd_adjustment
        shard = self.chain_shard
        split = shard is not None and shard.size > 1

        def chain_sum(v):
            return shard.sum(v.sum()) if split else v.sum()

        lf_total = self._leapfrogs

        def step(x, cs: CheesState, draws, n_leapfrog):
            p_raw, log_u, u_jit = draws
            u_jit = self._jitter(cs, u_jit)
            n_chains = self._n_global(x.shape[0])
            inv_mass, eps = cs.inv_mass_diag, cs.step_size
            if n_leapfrog is None:
                n_leapfrog = leapfrog_count(u_jit, cs.log_t, eps, max_steps)
            scoped = graphs.in_body()
            if not scoped:
                n_leapfrog = int(n_leapfrog)

            def precondition(v):
                return (flatten_event(v, event_shape) * inv_mass[None]).reshape(v.shape)

            p0 = (p_raw / torch.sqrt(inv_mass)[None]).reshape(x.shape)
            u_x, g = u_and_grad(x)
            h_start = u_x + 0.5 * sum_except_batch(precondition(p0) * p0, event_shape)
            # the trajectory in tensors made before the loop, which writes
            # them in place
            xq, pq, u_end = x.clone(), p0, u_x

            def leapfrog(_t):
                pq.sub_(0.5 * eps * g)
                xq.add_(eps * precondition(pq))
                u_new, g_new = u_and_grad(xq)
                u_end.copy_(u_new)
                g.copy_(g_new)
                pq.sub_(0.5 * eps * g)

            # L >= 1 leapfrogs: in a graph's body up to the longest, each
            # after the first while fewer than L ran; eagerly L, untested
            graphs.loop(max_steps if scoped else n_leapfrog, lambda t: t < n_leapfrog, leapfrog,
                        x.device, every=1 if scoped else n_leapfrog)

            finite_prop = torch.isfinite(flatten_event(xq, event_shape)).all(-1)
            h_end = u_end + 0.5 * sum_except_batch(precondition(pq) * pq, event_shape)
            log_alpha = h_start - h_end
            finite = finite_prop & torch.isfinite(h_end)
            mask = (log_u < log_alpha) & finite
            x_new = torch.where(mask.reshape(mask.shape + (1,) * len(event_shape)), xq, x)

            if tuning:
                # the acceptance probability, 0 where the trajectory or the
                # current state's Hamiltonian is not finite
                alpha = torch.where(finite & torch.isfinite(log_alpha),
                                    torch.exp(torch.clamp(log_alpha, max=0.0)),
                                    torch.zeros_like(log_alpha))
                da, step_size = cs.da, cs.step_size
                if tune_step:
                    da, step_size = da_update_step_size(da, chain_mean(alpha, shard), da_params)
                log_t, m, v, t_adam = cs.log_t, cs.adam_m, cs.adam_v, cs.adam_t
                if tune_traj:
                    # d ChEES / d log T across chains: diverged proposals
                    # fall back to the current state for the centre
                    xf = flatten_event(x, event_shape)
                    xpf = torch.where(finite[:, None], flatten_event(xq, event_shape), xf)
                    ctr = xpf - chain_mean(xpf, shard)[None]
                    ctr0 = xf - chain_mean(xf, shard)[None]
                    dsq = (ctr * ctr).sum(-1) - (ctr0 * ctr0).sum(-1)
                    v_end = flatten_event(precondition(pq), event_shape)
                    v_end = torch.where(finite[:, None], v_end, torch.zeros_like(v_end))
                    per_chain = dsq * (ctr * v_end).sum(-1)
                    w_sum = torch.clamp(chain_sum(alpha), min=1e-6)
                    grad = (chain_sum(alpha * per_chain) / w_sum) * u_jit * torch.exp(log_t)
                    t_adam = t_adam + 1.0
                    m = 0.9 * m + 0.1 * grad
                    v = 0.999 * v + 0.001 * grad * grad
                    m_hat = m / (1.0 - 0.9 ** t_adam)
                    v_hat = v / (1.0 - 0.999 ** t_adam)
                    log_t = log_t + adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
                    # T stays realisable: one to max_steps leapfrogs at the
                    # new step size
                    log_t = torch.minimum(torch.maximum(log_t, torch.log(step_size)),
                                          torch.log(step_size * max_steps))
                inv_mass_new = cs.inv_mass_diag
                if tune_imd and n_chains > 1:
                    inv_mass_new = ema_inv_mass_diag(cs.inv_mass_diag,
                                                     flatten_event(x_new, event_shape),
                                                     imd_adjustment, shard)
                cs = CheesState(step_size=step_size, inv_mass_diag=inv_mass_new, da=da,
                                log_t=log_t, adam_m=m, adam_v=v, adam_t=t_adam,
                                iter_idx=cs.iter_idx)
            cs = dataclasses.replace(cs, iter_idx=cs.iter_idx + 1)
            info = StepInfo(n_accepted=mask.sum().to(torch.int32),
                            diverged=(~finite.all()).to(torch.int32),
                            n_calls=2 * n_leapfrog * n_chains + 2 * n_chains,
                            n_grads=2 * n_leapfrog * n_chains)
            lf_total.add_(n_leapfrog)
            return x_new, cs, info

        return step

    def _graph_mode(self, tuning: bool) -> tuple:
        """A captured trajectory bakes in its longest length and the
        kernel's fixed settings."""
        kern = self.kernel
        return (kern.max_leapfrog_steps, kern.jitter, kern.adam_lr)

    # the counts ride StepInfo; nothing is static per iteration
    def calls_per_iter(self, n_chains: int) -> int:
        return 0

    def grads_per_iter(self, n_chains: int) -> int:
        return 0

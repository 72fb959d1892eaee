"""Jump NFMC: inner MCMC trajectories interleaved with flow jump proposals.

Per outer iteration the inner sampler takes ``inner.n_iterations`` steps,
then the chains make a Metropolis-adjusted jump to a flow proposal
(unadjusted jumps accept every finite proposal). Output law:
``(n_iterations * (inner_n + 1), C, *event)``.

A chunk of outer iterations is run as ``draws = make_chunk_draws(generator,
chunk, n_chains)`` (all of the chunk's randomness, drawn on the device up
front) followed by ``run_chunk(state, draws)``. With a frozen flow
(``fit_nf=False``) the proposals do not depend on the chain state, so the
chunk makes every proposal in ONE batched coupling inverse and then loops
over the iterations with no host synchronisation; for the declared classes
(MALA, ULA, HMC, UHMC, MH, ESS and AIES inside) on CUDA the loop is
``chunk`` replays of one captured outer iteration
(:mod:`nfmc_torch.core.graphs`), the counterpart of the JAX package's
compiled ``lax.scan`` over the outer iterations; ESS's prior redraw at the
start of each outer iteration is inside it, from hoisted draws. An inner
step that calls a collective every iteration (AIES's) runs the eager loop
over several ranks. With ``fit_nf=True`` and
fixed-effort ``flow_fit_kwargs`` each outer iteration from
``n_jumps_before_training`` on refits the flow on its inner draws
(``make_scan_fit``, its permutations hoisted from the fit's generator for
the refitting iterations) inside the chunk, and the proposals are made per
iteration from the refitted weights; for the declared classes on CUDA, on
one rank, that outer iteration is one captured graph too, the refit under
its gate row (an IF node, the JAX package's ``lax.cond``). Any other
``flow_fit_kwargs`` run the outer loop on the host (``_sample_host``),
calling ``inner_sampler.sample`` and ``Flow.fit`` each iteration.

``warmup`` tunes the inner sampler, then fits the flow by maximum
likelihood on the tuning draws (70/30 train/val split), rolling the weights
back if the fit raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core import graphs
from ...core.chains import all_rows
from ...core.driver import (
    RNG_HOIST_ELEMENT_LIMIT,
    StatsAccum,
    _compensated_add,
    flow_proposal_footprint_per_draw,
    hoist_cap,
    hoisted_flow_proposals,
    plan_chunks,
    run_chunk_loop,
    synchronize,
)
from ...core.output import JumpNFMCOutput, MCMCOutput
from ...core.sampler import NFMCKernel, NFMCParameters, Sampler
from ...core.tuning import train_val_split
from ...flows.train import fixed_effort_fit_config, make_scan_fit
from ...utils import Progress, metropolis_acceptance_log_ratio, unevaluable_current_mask
from ..mcmc.chees import CheesHMC
from ..mcmc.ensemble import AIES
from ..mcmc.ess import ESS
from ..mcmc.hmc import HMC, UHMC
from ..mcmc.langevin import MALA, ULA
from ..mcmc.mh import MH
from ..mcmc.nuts import NUTS


@dataclass
class JumpNFMCParameters(NFMCParameters):
    adjusted_jumps: bool = True
    fit_nf: bool = False
    warmup_fit_kwargs: Optional[dict] = None
    n_jumps_before_training: int = 10
    # the JAX package's lax.scan unroll factors of the fused outer loop, a
    # scheduling hint there; accepted, with no effect on the eager port
    fused_unroll_inner: int = 1
    fused_unroll_outer: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.warmup_fit_kwargs is None:
            self.warmup_fit_kwargs = {
                "early_stopping": True,
                "early_stopping_threshold": 50,
                "keep_best_weights": True,
                "n_epochs": 500,
                "lr": 0.005,  # the reference's 0.05 diverges
            }


@dataclasses.dataclass
class _JumpAccum:
    """Jump accept count and compensated post-jump moment sums."""

    n_accepted: torch.Tensor
    sum_x: torch.Tensor
    sum_x2: torch.Tensor
    c_x: torch.Tensor
    c_x2: torch.Tensor

    @staticmethod
    def zeros(event_shape, device):
        def z():
            return torch.zeros(event_shape, dtype=torch.float32, device=device)

        return _JumpAccum(n_accepted=torch.zeros((), dtype=torch.int32, device=device),
                          sum_x=z(), sum_x2=z(), c_x=z(), c_x2=z())

    def add_jump(self, mask, x):
        xf = x.to(torch.float32)
        sum_x, c_x = _compensated_add(self.sum_x, self.c_x, xf.sum(0))
        sum_x2, c_x2 = _compensated_add(self.sum_x2, self.c_x2, (xf * xf).sum(0))
        return _JumpAccum(n_accepted=self.n_accepted + mask.sum().to(torch.int32),
                          sum_x=sum_x, sum_x2=sum_x2, c_x=c_x, c_x2=c_x2)

    def moment_sums(self):
        return self.sum_x + self.c_x, self.sum_x2 + self.c_x2


@dataclasses.dataclass
class ChunkState:
    """What a run carries from one chunk to the next, all on the device."""

    x: torch.Tensor
    inner_state: object
    acc: StatsAccum
    jump_acc: _JumpAccum
    flow_params: list


class JumpNFMC(Sampler):
    """Needs a flow with an efficient inverse (sampling) and, for adjusted
    jumps, an efficient forward (scoring the current state)."""

    def __init__(self, event_shape, target, inner_sampler: Sampler,
                 kernel: Optional[NFMCKernel] = None,
                 params: Optional[JumpNFMCParameters] = None, device=None):
        if kernel is None:
            kernel = NFMCKernel(event_shape)
        if params is None:
            params = JumpNFMCParameters()
        super().__init__(event_shape, target, kernel, params, device=device)
        if inner_sampler.device != self.device:
            raise ValueError(f"inner sampler on {inner_sampler.device}, jump sampler on {self.device}")
        self.inner_sampler = inner_sampler
        self.kernel.flow.to(self.device)

    @property
    def name(self):
        return "Jump MCMC"

    # ------------------------------------------------------------------ warmup
    def warmup(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        """Tune the inner sampler on 70% of the time budget, then fit the flow
        on its draws. As in the JAX package, the fit takes
        ``params.flow_fit_kwargs`` (not ``warmup_fit_kwargs``)."""
        seed_inner, seed_fit = self._sub_seeds(self._generator(generator, seed), 2)
        inner_time_limit = 0.7 * time_limit_seconds if time_limit_seconds is not None else None
        t0 = time.time()
        self.inner_sampler.params.store_samples = True
        warmup_output = self.inner_sampler.warmup(
            x0, show_progress=show_progress, time_limit_seconds=inner_time_limit, seed=seed_inner)
        shard = self.chain_shard
        pooled = warmup_output.samples
        if shard is not None and pooled is not None:
            # every rank fits on the global pool, data-parallel over the mesh
            pooled = shard.gather(pooled, axis=1)
        x_train, x_val = train_val_split(
            pooled, train_pct=self.params.train_pct,
            max_train_size=self.params.max_train_size, max_val_size=self.params.max_val_size,
            seed=seed_fit)
        flow_params = self.kernel.flow.state_dict()
        elapsed = time.time() - t0
        fit_limit = (time_limit_seconds - elapsed) if time_limit_seconds is not None else None
        try:
            self.kernel.flow.fit(x_train, x_val=x_val,
                                 **{**self.params.flow_fit_kwargs,
                                    **dict(show_progress=show_progress, time_limit_seconds=fit_limit)},
                                 seed=seed_fit, mesh=None if shard is None else shard.mesh)
        except ValueError:
            self.kernel.flow.load_state_dict(flow_params)
        # the caller prefers MCMC warmup draws as x0 (flow draws can be outliers)
        return warmup_output

    # ---------------------------------------------------------------- jump step
    def _make_jump_accept_core(self):
        """``(params, x, x', log q(x'), U(x'), log_u) -> (x_new, mask)``;
        ``U(x')`` is unused when ``adjusted_jumps`` is off."""
        flow = self.kernel.flow
        target = self.target
        adjusted = self.params.adjusted_jumps
        event_ndim = len(self.event_shape)

        def accept_core(params, x, x_prime, f_x_prime, u_x_prime, log_u):
            n_chains = x.shape[0]
            finite = torch.isfinite(x_prime.reshape(n_chains, -1)).all(-1)
            if adjusted:
                u_x = target(x)
                f_x = flow.log_prob_fn(params, x)
                log_alpha = metropolis_acceptance_log_ratio(
                    log_prob_target_curr=-u_x,
                    log_prob_target_prime=-u_x_prime,
                    log_prob_proposal_curr=f_x,
                    log_prob_proposal_prime=f_x_prime,
                )
                # finiteness is checked on the proposal side only: U(x) = +inf
                # gives log_alpha = +inf, a certain accept, and an unevaluable
                # current side (NaN U, log q = -inf) forces the move
                finite = finite & torch.isfinite(u_x_prime) & torch.isfinite(f_x_prime)
                mask = ((log_u < log_alpha) | unevaluable_current_mask(u_x, f_x)) & finite
            else:
                mask = finite
            x_new = torch.where(mask.reshape(mask.shape + (1,) * event_ndim), x_prime, x)
            return x_new, mask

        return accept_core

    def _jump_calls_per_iter(self, n_chains: int) -> int:
        return 2 * n_chains if self.params.adjusted_jumps else 0

    # ------------------------------------------------------------- chunk runner
    def init_chunk_state(self, x0: torch.Tensor) -> ChunkState:
        inner = self.inner_sampler
        return ChunkState(
            x=x0,
            inner_state=inner._augment_state(inner.kernel.make_state(self.device), x0),
            acc=StatsAccum.zeros(self.event_shape, self.device, self.chain_shard),
            jump_acc=_JumpAccum.zeros(self.event_shape, self.device),
            flow_params=self.kernel.flow.params,
        )

    def make_chunk_draws(self, generator: torch.Generator, chunk: int, n_chains: int) -> dict:
        """All of a chunk's randomness: the inner steps' draws (the tuple the
        inner sampler's ``make_draws`` gives, e.g. MALA's ``(noise, log_u)``)
        with leading dims ``(chunk, inner_n)``, the proposals' base draws
        ``z`` ``(chunk, C, *event)`` and the jumps' ``log_u`` ``(chunk, C)``;
        then, drawn last so that the other draws keep their stream, the
        prior redraws ``x0`` ``(chunk, ...)`` of an inner sampler that starts
        each outer iteration from its prior (ESS's ``resample_x0_fn``)."""
        inner_sampler = self.inner_sampler
        inner_n = inner_sampler.params.n_iterations
        inner = inner_sampler.make_draws()(generator, (chunk, inner_n), n_chains)
        z = self.kernel.flow.sample_base_fn(generator, chunk * n_chains)
        if self.params.adjusted_jumps:
            jump_log_u = torch.log(torch.rand((chunk, n_chains), generator=generator,
                                              device=generator.device))
        else:
            jump_log_u = torch.zeros((chunk, n_chains), device=generator.device)
        draws = {"inner": tuple(inner), "z": z.reshape(chunk, n_chains, *z.shape[1:]),
                 "jump_log_u": jump_log_u}
        if getattr(inner_sampler, "resample_x0_fn", None) is not None:
            draws["x0"] = inner_sampler.resample_x0_draws(generator, (chunk,), n_chains)
        return draws

    def _make_outer_steps(self, precomputed: bool):
        """``(sweep, jump)``, the two halves of an outer iteration.

        * ``sweep(x, ks, acc, inner_i, aux_i, x0_i) -> (x, ks, acc, states,
          infos)``: the inner steps from the iteration's inner draws
          ``inner_i`` (leading dim ``inner_n``) and precompute output
          ``aux_i`` (None without one), after the prior redraw ``x0_i`` of an
          inner sampler that takes one;
        * ``jump(params, x, ks, jacc, prop, log_u) -> (x, ks, jacc)``: the
          jump to the proposal ``prop = (x', log q(x'), U(x'))``."""
        inner = self.inner_sampler
        inner_n = inner.params.n_iterations
        inner_step = (inner._make_step_precomputed(False) if precomputed
                      else inner._make_step_aux(False))
        accept_core = self._make_jump_accept_core()
        resample = getattr(inner, "resample_x0_fn", None)

        def sweep(x, ks, acc, inner_i, aux_i, x0_i):
            if resample is not None:
                # each outer iteration starts from a prior redraw (the
                # reference's ESS quirk); the carried nll is stale then
                mstate = inner._extract_mstate(ks)
                x = resample(x0_i, x, mstate)
                ks = inner._augment_state(mstate, x)
            states, infos = [], []
            for s in range(inner_n):
                d_s = tuple(d[s] for d in inner_i)
                if aux_i is None:
                    x, ks, info = inner_step(x, ks, d_s)
                else:
                    x, ks, info = inner_step(x, ks, d_s, tuple(a[s] for a in aux_i))
                acc = acc.add(info, x)
                states.append(x)
                infos.append(info)
            return x, ks, acc, states, infos

        def jump(params, x, ks, jacc, prop, log_u):
            x, jmask = accept_core(params, x, *prop, log_u)
            # the carried U / grad U are stale for chains that jumped
            ks = inner._augment_state(inner._extract_mstate(ks), x)
            return x, ks, jacc.add_jump(jmask, x)

        return sweep, jump

    def run_chunk(self, state: ChunkState, draws: dict, refit=None, length=None):
        """Run ``chunk`` outer iterations from ``state`` with ``draws``.
        Returns ``(state, ys)``; ``ys`` is the chunk's emitted draws
        ``(chunk * (inner_n + 1), C, *event)``, or None when
        ``params.store_samples`` is off.

        ``refit = (scan_fit, gate, rows)``: outer iteration i refits the
        flow on its inner draws with ``scan_fit`` (``rows``' row i its
        hoisted permutations, ``scan_fit.draws``) when ``gate[i]`` is set
        and then jumps with the refitted params, so its proposal is made
        after the refit.

        A declared class on CUDA (on one rank where a refit gathers the
        chains) runs the outer iterations as replays of one captured
        iteration (:mod:`~nfmc_torch.core.graphs`) whose static buffers hold
        ``length`` iterations (the chunk's own length when None)."""
        collect = self.params.store_samples
        inner = self.inner_sampler
        flow = self.kernel.flow
        params = state.flow_params
        target = self.target if self.params.adjusted_jumps else None
        inner_draws = draws["inner"]
        chunk, inner_n = inner_draws[0].shape[:2]
        x, ks, acc, jacc = state.x, state.inner_state, state.acc, state.jump_acc
        graphed = (graphs.declared(self, (flow,))
                   and graphs.captures(x.device, self.chain_shard,
                                       collective=inner.collective_step or refit is not None))
        # work of the inner steps that does not depend on the chain state
        # (ChEES's leapfrog counts) for the whole chunk, in one pass
        precompute = inner._make_precompute(False, graphed)
        inner_aux = precompute(x, ks, inner_draws) if precompute is not None else None
        sweep, jump = self._make_outer_steps(inner_aux is not None)
        with torch.no_grad():
            prop = None
            if refit is None:
                prop = hoisted_flow_proposals(flow, params, draws["z"], target=target)
            if graphed:
                return self._run_chunk_graph(state, draws, inner_aux, prop, length or chunk,
                                             refit)
            ys = None
            if collect:
                ys = torch.empty((chunk * (inner_n + 1), *x.shape), dtype=x.dtype,
                                 device=x.device)
            if refit is not None:
                scan_fit, gate, rows = refit
                refit_step = self._make_refit(scan_fit)
            row = 0
            for i in range(chunk):
                x, ks, acc, states, _infos = sweep(
                    x, ks, acc, tuple(d[i] for d in inner_draws),
                    None if inner_aux is None else tuple(a[i] for a in inner_aux),
                    draws["x0"][i] if "x0" in draws else None)
                if collect:
                    for x_s in states:
                        ys[row].copy_(x_s)
                        row += 1
                if refit is None:
                    p_i = tuple(t[i] for t in prop)
                else:
                    params = graphs.cond(bool(gate[i]),
                                         lambda p: refit_step(p, states, [r[i] for r in rows]),
                                         params)
                    p_i = self._proposal(params, draws["z"][i])
                x, ks, jacc = jump(params, x, ks, jacc, p_i, draws["jump_log_u"][i])
                if collect:
                    ys[row].copy_(x)
                    row += 1
        return ChunkState(x=x, inner_state=ks, acc=acc, jump_acc=jacc, flow_params=params), ys

    def _make_refit(self, scan_fit):
        """``refit(params, states, rows) -> params'``: ``scan_fit`` on an
        outer iteration's inner states (every rank's chains of them),
        ``rows`` its hoisted permutations."""
        shard = self.chain_shard
        event_shape = self.event_shape

        def refit(params, states, rows):
            data = all_rows(torch.stack(states), shard, axis=1)
            return scan_fit(params, data.reshape(-1, *event_shape), rows=rows)

        return refit

    def _proposal(self, params, z):
        """One outer iteration's flow proposal ``(x', log q(x'), U(x'))``
        from its base draws ``z`` ``(C, *event)``: one coupling inverse at
        B = C with the current weights."""
        target = self.target if self.params.adjusted_jumps else None
        return tuple(t[0] for t in hoisted_flow_proposals(self.kernel.flow, params, z[None],
                                                          target=target))

    def _graph_config(self) -> tuple:
        """What the captured outer iteration bakes in: the inner sampler's
        configuration, the flow's structure, the target and the jumps'
        adjustment (the weights ride in the carried state)."""
        inner = self.inner_sampler
        flow = self.kernel.flow
        return (inner._static_config(None), inner._graph_mode(False), id(flow),
                id(flow.bijection), id(self.target), self.params.adjusted_jumps)

    def _run_chunk_graph(self, state: ChunkState, draws: dict, inner_aux, prop, length: int,
                         refit=None):
        """:meth:`run_chunk` as replays of one captured outer iteration: its
        inner draws, precompute output, proposal (with a refit: its base
        draws and gate, and the refit's rows), jump uniform and prior
        redraw at the counter; it emits the iteration's ``inner_n + 1``
        states (and, on several ranks, its steps' divergence flags)."""
        collect = self.params.store_samples
        inner_draws = draws["inner"]
        chunk, inner_n = inner_draws[0].shape[:2]
        shard = self.chain_shard
        flags = shard is not None and shard.size > 1
        n_inner, n_aux = len(inner_draws), len(inner_aux or ())
        if refit is None:
            head, fit_rows, fit_config = list(prop), [], None
        else:
            scan_fit, gate, fit_rows = refit
            head = [draws["z"], torch.as_tensor(np.asarray(gate, dtype=bool),
                                                device=state.x.device)]
            fit_config = scan_fit.config
        n_head, n_rows = len(head), len(fit_rows)
        inputs = [*inner_draws, *(inner_aux or ()), *head, draws["jump_log_u"], *fit_rows]
        has_x0 = "x0" in draws
        if has_x0:
            inputs.append(draws["x0"])
        acc = state.acc
        leaves, spec = graphs.flatten((state.x, state.inner_state,
                                       dataclasses.replace(acc, div_flags=None), state.jump_acc,
                                       state.flow_params))
        key = ("outer", self._graph_config(), collect, flags, n_aux, fit_config, spec,
               graphs.signature(leaves), graphs.signature(t[0] for t in inputs), length)

        def make():
            sweep, jump = self._make_outer_steps(n_aux > 0)
            refit_step = None if refit is None else self._make_refit(refit[0])

            def body(state_leaves, rows):
                x, ks, acc_, jacc, params = graphs.unflatten(spec, state_leaves)
                k = n_inner + n_aux
                x, ks, acc_, states, infos = sweep(x, ks, acc_, rows[:n_inner],
                                                   rows[n_inner:k] if n_aux else None,
                                                   rows[-1] if has_x0 else None)
                for info in infos:
                    graphs.check_host_counts(info)
                head_i, log_u = rows[k:k + n_head], rows[k + n_head]
                if refit_step is None:
                    p_i = head_i
                else:
                    z, gate_i = head_i
                    rows_i = rows[k + n_head + 1:k + n_head + 1 + n_rows]
                    params = graphs.cond(gate_i, lambda p: refit_step(p, states, rows_i), params)
                    p_i = self._proposal(params, z)
                x, ks, jacc = jump(params, x, ks, jacc, p_i, log_u)
                new_leaves, new_spec = graphs.flatten((x, ks, acc_, jacc, params))
                if new_spec != spec:
                    raise RuntimeError("a captured outer iteration changed the structure of "
                                       "its state")
                outs = [torch.stack([*states, x])] if collect else []
                if flags:
                    outs.append(torch.stack([info.diverged for info in infos]))
                return new_leaves, outs

            x = state.x
            outputs = ([((length, inner_n + 1, *x.shape), x.dtype)] if collect else []) + (
                [((length, inner_n), torch.int32)] if flags else [])
            graph = graphs.IterationGraph(body, leaves, [((length, *t.shape[1:]), t.dtype)
                                                         for t in inputs], outputs, x.device)
            # the refit's closure, whose config the key holds
            graph.constants = () if refit is None else (refit[0],)
            return graph

        graph = graphs.CACHE.get(self, key, make)
        graph.load(leaves, inputs)
        graph.run(chunk)
        x, ks, new_acc, jacc, params = graphs.unflatten(spec, graph.state)
        if flags:
            acc.div_flags.append(graph.outputs[-1][:chunk].reshape(-1).clone())
        ys = None
        if collect:
            ys = graph.outputs[0][:chunk].reshape(chunk * (inner_n + 1), *x.shape).clone()
        return ChunkState(x=x, inner_state=ks,
                          acc=dataclasses.replace(new_acc, div_flags=acc.div_flags),
                          jump_acc=jacc, flow_params=params), ys

    # ------------------------------------------------------------------- sample
    def sample(self, x0, show_progress: bool = True, time_limit_seconds=None,
               generator: Optional[torch.Generator] = None, seed: Optional[int] = None) -> MCMCOutput:
        if not self.inner_sampler.params.store_samples:
            raise ValueError("Inner sampler in jump NFMC must store samples")
        generator = self._generator(generator, seed)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device).clone()
        self.kernel.flow.to(self.device)
        out = JumpNFMCOutput(event_shape=self.event_shape, store_samples=self.params.store_samples,
                             on_device=self.params.store_samples_on_device)
        fit_cfg = fixed_effort_fit_config(self.params.flow_fit_kwargs) if self.params.fit_nf else None
        if self.params.fit_nf and fit_cfg is None:
            self._sample_host(x0, out, generator, time_limit_seconds, show_progress)
        else:
            self._sample_chunked(x0, out, generator, time_limit_seconds, show_progress, fit_cfg)
        out.kernel = self.kernel
        return out

    def _shard_chunk_draws(self, draws: dict) -> dict:
        """This rank's rows of a chunk's draws made for the global chains
        (the inner draws' chain axes as the inner sampler declares them,
        ``draw_chain_axes``; None keeps a draw whole)."""
        if self.chain_shard is None:
            return draws
        rows = self._chain_rows
        axes = self.inner_sampler.draw_chain_axes or (0,) * len(draws["inner"])
        out = {"inner": tuple(d if a is None else rows(d, 2 + a)
                              for d, a in zip(draws["inner"], axes)),
               "z": rows(draws["z"], 1), "jump_log_u": rows(draws["jump_log_u"], 1)}
        if "x0" in draws:
            out["x0"] = rows(draws["x0"], 1)
        return out

    def _sample_chunked(self, x0, out, generator, time_limit_seconds, show_progress, fit_cfg):
        # the run's global chain count: draws, refits and caps are the
        # unsharded run's
        n_chains = self._n_global(x0.shape[0])
        inner_n = self.inner_sampler.params.n_iterations
        store = self.params.store_samples
        event_elems = int(np.prod(self.event_shape)) if self.event_shape else 1
        pipelined = time_limit_seconds is None and not show_progress
        # a pipelined run keeps its draws on the device and stores them after
        # the one end-of-run synchronisation
        defer_store = (store and pipelined and self.params.n_iterations * (inner_n + 1)
                       * n_chains * event_elems <= RNG_HOIST_ELEMENT_LIMIT)
        deferred = []
        st = {"state": graphs.contiguous(self.init_chunk_state(x0))}
        if fit_cfg is not None:
            n_epochs, lr, batch_size, keep_best, shuffle = fit_cfg
            scan_fit = make_scan_fit(
                self.kernel.flow, inner_n * n_chains, n_epochs=n_epochs, lr=lr,
                batch_size=batch_size, shuffle=shuffle, keep_best_weights=keep_best,
                train_pct=self.params.train_pct, max_train_size=self.params.max_train_size,
                max_val_size=self.params.max_val_size)
            fit_generator = torch.Generator(device=self.device)
            fit_generator.manual_seed(self._sub_seeds(generator, 1)[0])
        # refits make their proposals per iteration: their base draws and the
        # refits' rows are hoisted
        per_proposal = event_elems if fit_cfg is not None else flow_proposal_footprint_per_draw(
            self.kernel.flow, event_elems)
        cap = hoist_cap(n_chains, event_elems, inner_n, per_proposal, store,
                        self.inner_sampler.hoisted_elements_per_iter(x0),
                        fit_elems=0 if fit_cfg is None else scan_fit.row_elems)
        # a captured iteration's static buffers hold the run's longest chunk
        length = max(plan_chunks(self.params.n_iterations, pipelined, 256, cap), default=1)

        def dispatch(chunk, iters_done):
            draws = self._shard_chunk_draws(self.make_chunk_draws(generator, chunk, n_chains))
            refit = None
            if fit_cfg is not None:
                # gated by the absolute outer index; rows drawn for the
                # refitting iterations, in the order their eager calls would
                gate = [iters_done + i >= self.params.n_jumps_before_training for i in range(chunk)]
                refit = (scan_fit, gate, scan_fit.draws(fit_generator, gate))
            st["state"], ys = self.run_chunk(st["state"], draws, refit, length)
            if store:
                if defer_store:
                    deferred.append(ys)
                else:
                    out.running_samples.add(ys)

        def flush(iters):
            s = st["state"]
            self._account_outer_iters(out, iters, n_chains, inner_n, s.acc, s.jump_acc)
            s.acc = StatsAccum.zeros(self.event_shape, self.device, self.chain_shard)
            s.jump_acc = _JumpAccum.zeros(self.event_shape, self.device)

        iters_done = run_chunk_loop(
            self.params.n_iterations,
            dispatch=dispatch,
            sync=lambda: synchronize(self.device),
            stats=out.statistics,
            flush=flush,
            time_limit_seconds=time_limit_seconds,
            show_progress=show_progress,
            desc=self.name,
            sync_max_chunk=256,
            single_chunk_cap=cap,
            shard=self.chain_shard,
        )
        for blk in deferred:
            out.running_samples.add(blk)
        # a captured iteration's state lies in static buffers that a later
        # run reuses
        leaves, spec = graphs.flatten((st["state"].x, st["state"].inner_state))
        x, inner_state = graphs.unflatten(spec, [t.clone() for t in leaves])
        if not store and iters_done > 0:
            out.running_samples.add(x)
        if fit_cfg is not None:
            self.kernel.flow.params = st["state"].flow_params
        self.inner_sampler._finish_run()
        self.inner_sampler.kernel.sync_from_state(self.inner_sampler._extract_mstate(inner_state))

    def _sample_host(self, x0, out, generator, time_limit_seconds, show_progress):
        """The outer loop on the host, for refits that are not fixed-effort:
        per outer iteration a standalone inner run, then (from
        ``n_jumps_before_training`` on) ``Flow.fit`` on its draws with
        rollback, then one jump."""
        flow = self.kernel.flow
        inner = self.inner_sampler
        accept_core = self._make_jump_accept_core()
        adjusted = self.params.adjusted_jumps
        shard = self.chain_shard
        n_chains = self._n_global(x0.shape[0])
        x = x0
        stats = out.statistics
        bar = Progress(total=self.params.n_iterations, desc=self.name, disable=not show_progress)
        for i in range(self.params.n_iterations):
            if time_limit_seconds is not None:
                over = stats.elapsed_time_seconds >= time_limit_seconds
                if shard.any(over) if shard is not None else over:
                    break
            seed_inner, seed_fit = self._sub_seeds(generator, 2)
            mcmc_output = inner.sample(x0=x, show_progress=False, seed=seed_inner)
            ist = mcmc_output.statistics
            stats.update_counters(
                n_accepted_trajectories=ist.n_accepted_trajectories,
                n_attempted_trajectories=ist.n_attempted_trajectories,
                n_divergences=ist.n_divergences,
                n_target_calls=ist.n_target_calls,
                n_target_gradient_calls=ist.n_target_gradient_calls,
            )
            stats.update_elapsed_time(ist.elapsed_time_seconds)
            draws = mcmc_output.samples.to(self.device)
            self._add_draws(out, draws)

            t0 = time.time()
            if self.params.fit_nf and i >= self.params.n_jumps_before_training:
                x_train, x_val = train_val_split(
                    draws if shard is None else shard.gather(draws, axis=1),
                    train_pct=self.params.train_pct,
                    max_train_size=self.params.max_train_size,
                    max_val_size=self.params.max_val_size, seed=seed_fit)
                snapshot = flow.state_dict()
                try:
                    flow.fit(x_train, x_val=x_val, **self.params.flow_fit_kwargs, seed=seed_fit,
                             mesh=None if shard is None else shard.mesh)
                except ValueError:
                    flow.load_state_dict(snapshot)

            x = mcmc_output.running_samples.last_sample.to(self.device)
            with torch.no_grad():
                z = self._chain_rows(flow.sample_base_fn(generator, n_chains), 0)
                prop = hoisted_flow_proposals(flow, flow.params, z[None],
                                              target=self.target if adjusted else None)
                log_u = (torch.log(torch.rand(n_chains, generator=generator, device=self.device))
                         if adjusted else torch.zeros(n_chains, device=self.device))
                x, jmask = accept_core(flow.params, x, *(t[0] for t in prop),
                                       self._chain_rows(log_u, 0))
            n_jumped = jmask.sum()
            stats.update_counters(n_target_calls=self._jump_calls_per_iter(n_chains),
                                  n_attempted_jumps=n_chains,
                                  n_accepted_jumps=int(n_jumped if shard is None
                                                       else shard.sum(n_jumped)))
            stats.update_elapsed_time(time.time() - t0)
            self._add_draws(out, x[None])
            bar.update(1)
            if show_progress:
                bar.set_postfix_str(f"{stats}")
        bar.close()

    def _add_draws(self, out, block):
        """Store a ``(k, C, *event)`` block and fold it into the moments
        (summed over the ranks when the chains are sharded)."""
        xf = block.to(torch.float64)
        n = block.shape[0] * self._n_global(block.shape[1])
        sums = torch.stack([xf.sum((0, 1)), (xf * xf).sum((0, 1))])
        if self.chain_shard is not None:
            sums = self.chain_shard.sum(sums)
        out.statistics.update_moments_from_sums(sums[0], sums[1], n)
        out.running_samples.add(block)

    def _account_outer_iters(self, out, n_outer, n_chains, inner_n, acc, jump_acc):
        """Fold the device accumulators into the host statistics with ONE
        device-to-host copy."""
        a_x, a_x2 = acc.moment_sums()
        j_x, j_x2 = jump_acc.moment_sums()
        host = torch.cat([acc.host_counts(), jump_acc.n_accepted.to(torch.float64).reshape(1),
                          (a_x + j_x).reshape(-1).to(torch.float64),
                          (a_x2 + j_x2).reshape(-1).to(torch.float64)])
        host = acc.reduced(host, self.chain_shard).cpu().numpy()
        n_acc, n_div, n_jump = int(host[0]), int(host[1]), int(host[6])
        dyn_calls, dyn_grads = acc.dynamic_counts(host)
        sum_x, sum_x2 = np.split(host[7:], 2)
        inner = self.inner_sampler
        # the static per-iteration contract plus the dynamic channel that
        # trajectory-dependent inner samplers (NUTS, ChEES) report through
        out.statistics.update_counters(
            n_accepted_trajectories=n_acc,
            n_attempted_trajectories=n_outer * inner_n * n_chains,
            n_divergences=n_div,
            n_target_calls=n_outer * (inner_n * inner.calls_per_iter(n_chains)
                                      + self._jump_calls_per_iter(n_chains)) + dyn_calls,
            n_target_gradient_calls=n_outer * inner_n * inner.grads_per_iter(n_chains) + dyn_grads,
            n_accepted_jumps=n_jump,
            n_attempted_jumps=n_outer * n_chains,
        )
        out.statistics.update_moments_from_sums(
            sum_x.reshape(self.event_shape), sum_x2.reshape(self.event_shape),
            n_outer * (inner_n + 1) * n_chains)


class JumpMALA(JumpNFMC):
    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: chunks replay a
    # CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         MALA(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpULA(JumpNFMC):
    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: chunks replay a
    # CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         ULA(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpHMC(JumpNFMC):
    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: chunks replay a
    # CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         HMC(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpUHMC(JumpNFMC):
    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: chunks replay a
    # CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         UHMC(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpMH(JumpNFMC):
    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: chunks replay a
    # CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         MH(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpESS(JumpNFMC):
    """Flow jumps interleaved with elliptical slice sampling; every outer
    iteration starts from a prior redraw (the reference's ESS quirk)."""

    multi_rank_chains = True
    # the outer iteration, the redraw and the gated refit included: chunks
    # replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, negative_log_likelihood, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         ESS(event_shape, target, negative_log_likelihood, inner_kernel,
                             inner_params, device=device),
                         kernel, params, device=device)


class JumpNUTS(JumpNFMC):
    """Flow jumps interleaved with NUTS; the inner trajectories' leapfrogs
    are counted through the dynamic channel."""

    multi_rank_chains = True
    # the outer iteration, its inner trajectories in scopes on device
    # predicates, with or without its gated refit: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         NUTS(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpChEES(JumpNFMC):
    """Flow jumps interleaved with ChEES-HMC: the trajectory length and the
    step size adapt in the warmup's inner tuning and stay fixed (jittered)
    in the outer loop; the leapfrog counts are counted dynamically."""

    multi_rank_chains = True
    # the outer iteration, its inner trajectories in scopes on device
    # predicates, with or without its gated refit: chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         CheesHMC(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)


class JumpAIES(JumpNFMC):
    """Flow jumps interleaved with the affine-invariant ensemble's stretch
    moves (gradient-free); a jump leaves the carried U(x) stale, and the
    runner's state refresh after each jump recomputes it."""

    multi_rank_chains = True
    # the outer iteration, with or without its gated refit: on one rank,
    # chunks replay a CUDA graph
    graph_capturable = True

    def __init__(self, event_shape, target, kernel=None, params=None,
                 inner_kernel=None, inner_params=None, device=None):
        super().__init__(event_shape, target,
                         AIES(event_shape, target, inner_kernel, inner_params, device=device),
                         kernel, params, device=device)

"""The chunked chain driver: accumulators, hoisted flow proposals, the
chunk-loop policy and the standalone MCMC runner (``ChunkedScanDriver``).

The JAX package compiles each chunk of iterations into one ``lax.scan``.
Here a chunk has the same structure: the chunk's randomness and its flow
proposals are computed up front in batched passes, and the counters and
moment sums stay on the device, so a run synchronises with the host once, at
its end (or per chunk when a time limit or a progress bar needs the wall
clock). For a sampler that declares its step capturable, on CUDA, the
iterations of a chunk are replays of one captured CUDA graph of an iteration
(:mod:`nfmc_torch.core.graphs`); otherwise, and under
:func:`~nfmc_torch.core.graphs.disable_graphs`, they are an eager loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import Progress
from . import graphs

# Footprint cap (f32 elements across a chunk) for hoisted draws and
# proposals, ~512 MB.
RNG_HOIST_ELEMENT_LIMIT = 1 << 27

# Largest run the pipelined single-chunk fast path takes as one chunk.
SINGLE_CHUNK_ITER_LIMIT = 4096


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flow_proposal_footprint_per_draw(flow, event_size: int) -> int:
    """Peak f32 elements one hoisted flow proposal holds: the position, the
    base draw and the log-prob/target scalars (~3 events) plus the widest
    conditioner activation."""
    hidden = getattr(flow.bijection, "hidden", None)
    if isinstance(hidden, (list, tuple)):
        hidden = max(hidden) if hidden else 0
    return 3 * event_size + int(hidden or event_size)


def hoisted_flow_proposals(flow, params, z, target=None):
    """Flow proposals for a whole chunk from base draws ``z`` shaped
    ``(chunk, n_chains, *event)``: ONE batched coupling inverse over
    ``chunk * n_chains`` rows, the proposals' log-prob and, when ``target``
    is given, their potential. Returns ``(x', log q(x'), U(x'))`` with
    leading ``(chunk, n_chains)``; ``U`` is zeros without a target."""
    chunk, n_chains = z.shape[:2]
    zf = z.reshape(chunk * n_chains, *z.shape[2:])
    xf, flp = flow.push_base_fn(params, zf)
    if target is None:
        u = torch.zeros((chunk, n_chains), dtype=torch.float32, device=z.device)
    else:
        u = target(xf).reshape(chunk, n_chains)
    return xf.reshape(z.shape), flp.reshape(chunk, n_chains), u


class StepInfo(NamedTuple):
    """Per-iteration outputs of a kernel step, on the device.

    ``n_calls``/``n_grads`` carry the work of kernels whose cost depends on
    the trajectory (NUTS, ChEES); static-cost kernels leave them the plain
    int 0 and the host counts ``iters * calls_per_iter`` instead."""

    n_accepted: torch.Tensor  # int32 scalar: chains accepted this iteration
    diverged: torch.Tensor  # int32 scalar: 1 if this iteration diverged
    n_calls: "torch.Tensor | int" = 0
    n_grads: "torch.Tensor | int" = 0


def _compensated_add(s, c, v):
    """Neumaier compensated add: ``s' + c'`` tracks the exact ``s + c + v``,
    so float32 sums flushed once per run do not drift."""
    t = s + v
    comp = torch.where(s.abs() >= v.abs(), (s - t) + v, (v - t) + s)
    return t, c + comp


def _add_dynamic(s, c, host, v):
    """Fold a step's dynamic count into the accumulators: a count the host
    already has (a Python int: ChEES's leapfrogs, or a static kernel's 0)
    into the host total, a device count (NUTS's) into the compensated
    float32 pair. Returns ``(s, c, host)``."""
    if isinstance(v, int):
        return s, c, host + v
    return (*_compensated_add(s, c, v.to(torch.float32)), host)


@dataclasses.dataclass
class StatsAccum:
    """Device accumulators carried through a run: accept and divergence
    counts, the dynamic call and gradient counts and compensated moment
    sums. Counters that are static per iteration are computed on the host
    instead.

    A dynamic count the host already has (ChEES's) adds to a host integer;
    a device count (NUTS's) to a compensated float32 pair, not an int32:
    1024 chains and 256 leapfrogs add ~5e5 an iteration, past 2^31 within a
    few thousand iterations. Each addend is below 2^24, so the float32 add
    is exact and the compensation keeps the total exact.

    ``div_flags``, kept when the chains are sharded over several ranks,
    holds each iteration's divergence flag, so that a flush counts an
    iteration once where some rank diverged (:meth:`reduced`)."""

    n_accepted: torch.Tensor
    n_divergences: torch.Tensor
    n_calls_dyn: torch.Tensor
    c_calls_dyn: torch.Tensor
    n_grads_dyn: torch.Tensor
    c_grads_dyn: torch.Tensor
    sum_x: torch.Tensor
    sum_x2: torch.Tensor
    c_x: torch.Tensor
    c_x2: torch.Tensor
    # dynamic counts that the steps reported as host integers
    host_calls: int = 0
    host_grads: int = 0
    div_flags: Optional[list] = None

    @staticmethod
    def zeros(event_shape: Tuple[int, ...], device, shard=None) -> "StatsAccum":
        """Zeroed accumulators; with a ``shard`` of several ranks they keep
        the per-iteration divergence flags."""
        def z():
            return torch.zeros(event_shape, dtype=torch.float32, device=device)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=device)

        return StatsAccum(n_accepted=scalar(torch.int32), n_divergences=scalar(torch.int32),
                          n_calls_dyn=scalar(torch.float32), c_calls_dyn=scalar(torch.float32),
                          n_grads_dyn=scalar(torch.float32), c_grads_dyn=scalar(torch.float32),
                          sum_x=z(), sum_x2=z(), c_x=z(), c_x2=z(),
                          div_flags=[] if shard is not None and shard.size > 1 else None)

    def add(self, info: StepInfo, x: torch.Tensor) -> "StatsAccum":
        xf = x.to(torch.float32)
        sum_x, c_x = _compensated_add(self.sum_x, self.c_x, xf.sum(0))
        sum_x2, c_x2 = _compensated_add(self.sum_x2, self.c_x2, (xf * xf).sum(0))
        calls, c_calls, h_calls = _add_dynamic(self.n_calls_dyn, self.c_calls_dyn,
                                               self.host_calls, info.n_calls)
        grads, c_grads, h_grads = _add_dynamic(self.n_grads_dyn, self.c_grads_dyn,
                                               self.host_grads, info.n_grads)
        if self.div_flags is not None:
            self.div_flags.append(info.diverged)  # the list passes to the new accumulators
        return StatsAccum(n_accepted=self.n_accepted + info.n_accepted,
                          n_divergences=self.n_divergences + info.diverged,
                          n_calls_dyn=calls, c_calls_dyn=c_calls, n_grads_dyn=grads,
                          c_grads_dyn=c_grads, sum_x=sum_x, sum_x2=sum_x2, c_x=c_x, c_x2=c_x2,
                          host_calls=h_calls, host_grads=h_grads, div_flags=self.div_flags)

    def moment_sums(self):
        return self.sum_x + self.c_x, self.sum_x2 + self.c_x2

    def host_counts(self) -> torch.Tensor:
        """The accept, divergence and dynamic counts as one float64 vector
        on the device, for the flush's one device-to-host copy:
        ``[n_accepted, n_divergences, calls, calls' compensation, grads,
        grads' compensation]``."""
        return torch.stack([self.n_accepted.to(torch.float64), self.n_divergences.to(torch.float64),
                            self.n_calls_dyn.to(torch.float64), self.c_calls_dyn.to(torch.float64),
                            self.n_grads_dyn.to(torch.float64), self.c_grads_dyn.to(torch.float64)])

    def reduced(self, host: torch.Tensor, shard) -> torch.Tensor:
        """A flush's vector (``host_counts`` first, then any sums) summed
        over the ranks of ``shard`` (as it is without one), its divergence
        count made the iterations in which some rank diverged."""
        if shard is None:
            return host
        host = shard.sum(host)
        if self.div_flags:
            flags = torch.cat([f.reshape(-1) for f in self.div_flags])
            host[1] = shard.max(flags).sum()
        return host

    def dynamic_counts(self, host=None) -> Tuple[int, int]:
        """The dynamic ``(calls, grads)``: the host totals plus the device
        pairs, read from ``host``, the flushed ``host_counts`` vector (or
        fetched here when None)."""
        if host is None:
            host = self.host_counts().cpu().numpy()
        return (self.host_calls + int(round(float(host[2]) + float(host[3]))),
                self.host_grads + int(round(float(host[4]) + float(host[5]))))


def chunk_schedule(n_iterations: int, max_chunk: int = 64):
    """Chunk sizes growing 1, 4, 16, ... capped at the largest power of 4
    <= ``max_chunk``, the tail decomposed into sizes already seen."""
    sizes = [1]
    while sizes[-1] * 4 <= max_chunk:
        sizes.append(sizes[-1] * 4)
    remaining = n_iterations
    i = 0
    while remaining > 0:
        if i < len(sizes) and sizes[i] <= remaining:
            size = sizes[i]
            i += 1
        else:
            size = max((s for s in sizes[: max(i, 1)] if s <= remaining), default=1)
            size = min(size, remaining)
        yield size
        remaining -= size


def plan_chunks(n_iterations: int, pipelined: bool, sync_max_chunk: int = 64,
                single_chunk_cap: Optional[int] = None) -> list:
    """The chunk lengths of a run (see :func:`run_chunk_loop`)."""
    max_chunk = 1024 if pipelined else sync_max_chunk
    if single_chunk_cap is not None:
        max_chunk = min(max_chunk, single_chunk_cap)
    if (pipelined and 0 < n_iterations <= SINGLE_CHUNK_ITER_LIMIT
            and (single_chunk_cap is None or n_iterations <= single_chunk_cap)):
        return [n_iterations]
    return list(chunk_schedule(n_iterations, max_chunk=max_chunk))


def run_chunk_loop(
    n_iterations: int,
    *,
    dispatch: Callable[[int, int], None],
    sync: Callable[[], None],
    stats,
    flush: Callable[[int], None],
    time_limit_seconds: Optional[float] = None,
    show_progress: bool = False,
    desc: str = "MCMC",
    sync_max_chunk: int = 64,
    single_chunk_cap: Optional[int] = None,
    shard=None,
) -> int:
    """The chunk-loop policy. ``dispatch(chunk_len, iters_done)`` enqueues one
    chunk; ``flush(unflushed_iters)`` folds the device accumulators into
    ``stats`` and resets them.

    Without a time limit or a live bar the run is pipelined: chunks are
    enqueued without waiting and the host synchronises once at the end; a
    run of at most ``SINGLE_CHUNK_ITER_LIMIT`` iterations that fits
    ``single_chunk_cap`` (the largest chunk the hoisted draws may span) is
    one chunk. Otherwise every chunk is waited for, so elapsed time and the
    limit see real work. Chunks never exceed ``single_chunk_cap``. Returns
    the iterations completed (a time limit may stop the run early). With a
    chain ``shard`` the ranks stop together, when one rank's clock reaches
    the limit.
    """
    pipelined = time_limit_seconds is None and not show_progress
    schedule = plan_chunks(n_iterations, pipelined, sync_max_chunk, single_chunk_cap)
    iters_done = 0
    unflushed = 0
    run_t0 = time.time()
    bar = Progress(total=n_iterations, desc=desc, disable=not show_progress)
    for chunk in schedule:
        if time_limit_seconds is not None:
            over = stats.elapsed_time_seconds >= time_limit_seconds
            if shard.any(over) if shard is not None else over:
                break
        t0 = time.time()
        dispatch(chunk, iters_done)
        if not pipelined:
            sync()
            stats.update_elapsed_time(time.time() - t0)
        iters_done += chunk
        unflushed += chunk
        bar.update(chunk)
        if show_progress:
            flush(unflushed)
            unflushed = 0
            bar.set_postfix_str(f"{stats}")
    bar.close()
    if pipelined and iters_done:
        sync()
        stats.update_elapsed_time(time.time() - run_t0)
    if unflushed:
        flush(unflushed)
    return iters_done


class ChunkedScanDriver:
    """Runs a sampler's step for N iterations in chunks (the counterpart of
    ``nfmc_tpu/core/driver.py::ChunkedScanDriver``). A sampler keeps one
    across its runs (``Sampler._cached_driver``), with its graphs.

    ``make_step(tuning)`` gives ``step(x, kstate, draws) -> (x', kstate',
    StepInfo)`` and ``make_draws(generator, prefix, n_chains)`` a chunk's
    per-iteration randomness with leading dims ``prefix``. A chunk draws its
    randomness up front, then runs the step ``chunk`` times; the
    accumulators stay on the device.

    Work that does not depend on the chain state can be hoisted out of the
    loop: ``make_precompute(tuning, graphed)`` gives ``precompute(x,
    kstate, draws) -> aux`` (tensors with leading dim ``chunk``, or None to
    decline, e.g. above a footprint cap; ``graphed`` says whether the run
    replays graphs, whose inputs the aux tensors then are, or runs the
    eager loop) and the iterations then run ``make_step_aux
    (tuning)``'s ``step(x, kstate, draws_i, aux_i)``; a chunk whose
    precompute declines runs ``make_step``'s step. ``hoist_per_iter(x)``,
    one iteration's hoisted f32 elements (its draws, and its precompute's
    output), caps the chunk so that the default footprint limit admits it.
    ``data_transform`` maps each new state before it enters the moment sums
    (the stored draws stay as they are).

    ``capturable`` is the sampler's declaration (:func:`graphs.declared`):
    its runs on CUDA replay one captured iteration ``chunk`` times
    (:func:`graphs.captures` decides before the run; a ``collective`` step
    on several ranks runs eagerly). The graph reads the
    carried state, the chunk's draws and precompute output and writes the
    emitted draws at a device counter; the tensors a step closes over (the
    target's, a flow's weights) are read where they lie, so a run that
    changes them passes them as ``constants``, and a new set of tensors
    captures anew.

    A step that refits a flow (DLMC's, TESS's fused warmup) takes its
    refit's rows as a second hoisted draw source (``run(fit_rows=...)``),
    drawn a chunk at a time from the fit's own generator; such a step
    gathers the chains, so it is ``collective`` on several ranks.

    A run may pause for eager work on the carried kernel state at
    iterations the host knows before the run (``pause``: the dense
    metric's refresh, the JAX package's ``lax.cond`` in the scan step): the
    chunk ends its replays there, runs the work and goes on replaying from
    the next row, and the eager loop runs the same work at the same
    iterations.

    With a chain ``shard`` (:mod:`nfmc_torch.core.chains`) ``x0`` holds this
    rank's chains: a chunk's draws are made for the global chains and cut to
    this rank's rows (each draw's chain axis follows the chunk's leading
    axis, or sits ``draw_chain_axes[i]`` axes later; None keeps the draw
    whole, for a step that indexes it by global chain), the chunk schedule
    is the global run's, and each flush sums the counts and moments over
    the ranks.
    """

    def __init__(self, event_shape: Tuple[int, ...], make_step: Callable[[bool], Callable],
                 make_draws: Callable, make_precompute: Optional[Callable] = None,
                 make_step_aux: Optional[Callable] = None,
                 hoist_per_iter: Optional[Callable[[torch.Tensor], int]] = None,
                 data_transform: Optional[Callable] = None,
                 draw_chain_axes: Optional[Tuple[int, ...]] = None, capturable: bool = False,
                 collective: bool = False):
        self.event_shape = tuple(event_shape)
        self.make_step = make_step
        self.make_draws = make_draws
        self.make_precompute = make_precompute
        self.make_step_aux = make_step_aux
        self.hoist_per_iter = hoist_per_iter
        self.data_transform = data_transform or (lambda v: v)
        self.draw_chain_axes = draw_chain_axes
        self.capturable = capturable
        self.collective = collective

    def _graph(self, tuning, mode, collect, n_draws, flags, spec, leaves, inputs, length,
               constants):
        """The graph of one iteration for this mode and these shapes (made
        and cached on first use); ``inputs`` holds the chunk's ``n_draws``
        draws, then its precompute output, if any."""
        use_aux = len(inputs) > n_draws
        key = (tuning, mode, collect, n_draws, flags, spec, graphs.signature(leaves),
               graphs.signature(t[0] for t in inputs), length, tuple(id(c) for c in constants))
        data_transform = self.data_transform

        def make():
            step = self.make_step_aux(tuning) if use_aux else self.make_step(tuning)

            def body(state, rows):
                x, ks, acc = graphs.unflatten(spec, state)
                draws_i = tuple(rows[:n_draws])
                if use_aux:
                    x, ks, info = step(x, ks, draws_i, tuple(rows[n_draws:]))
                else:
                    x, ks, info = step(x, ks, draws_i)
                graphs.check_host_counts(info)
                acc = acc.add(info, data_transform(x))
                new_leaves, new_spec = graphs.flatten((x, ks, acc))
                if new_spec != spec:
                    raise RuntimeError("a captured step changed the structure of its state")
                return new_leaves, ([x] if collect else []) + ([info.diverged] if flags else [])

            x = leaves[0]
            outputs = ([((length, *x.shape), x.dtype)] if collect else []) + (
                [((length,), torch.int32)] if flags else [])
            graph = graphs.IterationGraph(body, leaves, [((length, *t.shape[1:]), t.dtype)
                                                         for t in inputs], outputs, x.device)
            graph.constants = tuple(constants)  # keeps the ids of the key valid
            return graph

        return graphs.CACHE.get(self, key, make)

    def run(self, x0: torch.Tensor, kstate, generator: torch.Generator, n_iterations: int, *,
            stats, samples=None, calls_per_iter: int = 0, grads_per_iter: int = 0,
            tuning: bool = False, collect: bool = True,
            time_limit_seconds: Optional[float] = None, show_progress: bool = False,
            desc: str = "MCMC", shard=None, constants=(), pause=None, mode=(), fit_rows=None):
        """Run the chain; updates ``stats``/``samples``; returns ``(x, kstate)``.
        ``calls_per_iter`` and ``grads_per_iter`` count the global chains.
        ``pause = (due, work)``: after the run's k-th iteration (from 1)
        where ``due(k)``, the carried kernel state becomes ``work(kstate)``,
        run eagerly. ``mode`` is what ``make_step(tuning)`` bakes in besides
        the tuning flag (part of a graph's key). ``fit_rows(chunk)``, the
        second hoisted draw source of a step that refits a flow: the
        chunk's refit rows from the fit's own generator (``make_scan_fit``'s
        ``draws``), kept whole on every rank and given to the step after
        its draws, on both paths."""
        step = self.make_step(tuning)
        data_transform = self.data_transform
        device = x0.device
        graphed = self.capturable and graphs.captures(device, shard, tuning, self.collective)
        precompute = self.make_precompute(tuning, graphed) if self.make_precompute else None
        step_aux = self.make_step_aux(tuning) if self.make_step_aux else None
        st = {"x": x0.clone(memory_format=torch.contiguous_format),
              "kstate": graphs.contiguous(kstate),
              "acc": StatsAccum.zeros(self.event_shape, device, shard)}
        n_chains = x0.shape[0] if shard is None else shard.n_global(x0.shape[0])
        event_elems = int(np.prod(self.event_shape)) if self.event_shape else 1
        collect = collect and samples is not None
        pipelined = time_limit_seconds is None and not show_progress
        # a pipelined run keeps its draws on the device and stores them after
        # the one end-of-run synchronisation
        defer_store = (collect and pipelined
                       and n_iterations * n_chains * event_elems <= RNG_HOIST_ELEMENT_LIMIT)
        deferred = []
        flags = shard is not None and shard.size > 1

        # the chunk's hoisted draws and its emitted-draw buffer are each
        # about (chunk, C, *event)
        cap = max(1, RNG_HOIST_ELEMENT_LIMIT // max(1, n_chains * event_elems))
        if self.hoist_per_iter is not None:
            # the default limit, not a sampler's own: forcing the in-loop
            # step must not change the chunk schedule
            cap = min(cap, max(1, RNG_HOIST_ELEMENT_LIMIT // max(1, int(self.hoist_per_iter(x0)))))
        # a graph's static buffers hold the run's longest chunk
        length = max(plan_chunks(n_iterations, pipelined, 64, cap), default=1)

        def draw(chunk):
            draws = self.make_draws(generator, (chunk,), n_chains)
            if shard is not None:
                axes = self.draw_chain_axes or (0,) * len(draws)
                draws = tuple(d if a is None else shard.rows(d, 1 + a)
                              for d, a in zip(draws, axes))
            if fit_rows is not None:
                draws = (*draws, *fit_rows(chunk))
            return draws

        def stops(chunk, iters_done):
            """The chunk's iterations (from 1) after which the run pauses."""
            if pause is None:
                return []
            return [i for i in range(1, chunk + 1) if pause[0](iters_done + i)]

        def store(ys):
            if defer_store:
                deferred.append(ys)
            else:
                samples.add(ys)

        def dispatch_eager(chunk, iters_done):
            draws = draw(chunk)
            x, ks, acc = st["x"], st["kstate"], st["acc"]
            ys = torch.empty((chunk, *x.shape), dtype=x.dtype, device=device) if collect else None
            paused = stops(chunk, iters_done)
            with torch.no_grad():
                aux = precompute(x, ks, draws) if precompute is not None else None
                for i in range(chunk):
                    draws_i = tuple(d[i] for d in draws)
                    if aux is None:
                        x, ks, info = step(x, ks, draws_i)
                    else:
                        x, ks, info = step_aux(x, ks, draws_i, tuple(a[i] for a in aux))
                    acc = acc.add(info, data_transform(x))
                    if collect:
                        ys[i].copy_(x)
                    if i + 1 in paused:
                        ks = graphs.contiguous(pause[1](ks))
            st.update(x=x, kstate=ks, acc=acc)
            if collect:
                store(ys)

        def dispatch_graph(chunk, iters_done):
            draws = draw(chunk)
            x, ks, acc = st["x"], st["kstate"], st["acc"]
            with torch.no_grad():
                aux = precompute(x, ks, draws) if precompute is not None else None
            inputs = list(draws) + (list(aux) if aux is not None else [])
            leaves, spec = graphs.flatten((x, ks, dataclasses.replace(acc, div_flags=None)))
            graph = self._graph(tuning, mode, collect, len(draws), flags, spec, leaves, inputs,
                                length, constants)
            graph.load(leaves, inputs)
            paused, done = stops(chunk, iters_done), 0
            with torch.no_grad():
                for stop in sorted({*paused, chunk}):
                    graph.run(stop - done)
                    done = stop
                    if stop in paused:
                        x, ks, a = graphs.unflatten(spec, graph.state)
                        new_leaves, new_spec = graphs.flatten((x, pause[1](ks), a))
                        if new_spec != spec:
                            raise RuntimeError("a pause changed the structure of the state")
                        graph.set_state(new_leaves)
            x, ks, new_acc = graphs.unflatten(spec, graph.state)
            if flags:
                acc.div_flags.append(graph.outputs[-1][:chunk].clone())
            st.update(x=x, kstate=ks, acc=dataclasses.replace(new_acc, div_flags=acc.div_flags))
            if collect:
                store(graph.outputs[0][:chunk].clone())

        def flush(iters):
            acc = st["acc"]
            sum_x, sum_x2 = acc.moment_sums()
            host = torch.cat([acc.host_counts(), sum_x.reshape(-1).to(torch.float64),
                              sum_x2.reshape(-1).to(torch.float64)])
            host = acc.reduced(host, shard).cpu().numpy()
            dyn_calls, dyn_grads = acc.dynamic_counts(host)
            stats.update_counters(
                n_accepted_trajectories=int(host[0]),
                n_attempted_trajectories=iters * n_chains,
                n_divergences=int(host[1]),
                n_target_calls=iters * calls_per_iter + dyn_calls,
                n_target_gradient_calls=iters * grads_per_iter + dyn_grads,
            )
            s_x, s_x2 = np.split(host[6:], 2)
            stats.update_moments_from_sums(s_x.reshape(self.event_shape),
                                           s_x2.reshape(self.event_shape), iters * n_chains)
            st["acc"] = StatsAccum.zeros(self.event_shape, device, shard)

        iters_done = run_chunk_loop(
            n_iterations, dispatch=dispatch_graph if graphed else dispatch_eager,
            sync=lambda: synchronize(device), stats=stats, flush=flush,
            time_limit_seconds=time_limit_seconds, show_progress=show_progress, desc=desc,
            sync_max_chunk=64, single_chunk_cap=cap, shard=shard,
        )
        if graphed:
            # the static buffers belong to the graph, which a later run reuses
            leaves, spec = graphs.flatten((st["x"], st["kstate"]))
            st["x"], st["kstate"] = graphs.unflatten(spec, [t.clone() for t in leaves])
        if deferred:
            samples.add(deferred[0] if len(deferred) == 1 else torch.cat(deferred, 0))
        if samples is not None and not collect and iters_done > 0:
            samples.add(st["x"])
        return st["x"], st["kstate"]


def hoist_cap(n_chains: int, event_elems: int, inner_n: int, per_proposal: int,
              store_samples: bool, inner_per_iter: Optional[int] = None,
              fit_elems: int = 0) -> int:
    """Largest chunk whose hoisted inner draws, flow proposals (or their
    base draws), refit rows and emitted draw buffer each stay under
    ``RNG_HOIST_ELEMENT_LIMIT``; ``inner_per_iter`` is an inner iteration's
    hoisted elements where they exceed the chains' state (NUTS's leaf
    uniforms), ``fit_elems`` an outer iteration's refit rows
    (``make_scan_fit``'s ``row_elems``)."""
    per_inner = max(n_chains * event_elems, int(inner_per_iter or 0))
    caps = [
        RNG_HOIST_ELEMENT_LIMIT // max(1, inner_n * per_inner),
        RNG_HOIST_ELEMENT_LIMIT // max(1, n_chains * per_proposal),
        RNG_HOIST_ELEMENT_LIMIT // max(1, fit_elems),
    ]
    if store_samples:
        caps.append(RNG_HOIST_ELEMENT_LIMIT // max(1, (inner_n + 1) * n_chains * event_elems))
    return max(1, int(np.min(caps)))

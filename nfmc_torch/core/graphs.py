"""The capture layer: a chunk of a sampler's iterations, a block of a flow
fit's epochs or steps, or a transport loop's levels, passes or
iterations, as replays of one captured CUDA graph, the counterpart of the
JAX package's compiled ``lax.scan`` chunk
(``nfmc_tpu/core/driver.py::ChunkedScanDriver``), jitted training block
(``nfmc_tpu/flows/train.py``) and jitted transport loops
(``nfmc_tpu/transport/``, ``nfmc_tpu/flow_training/fab.py``). It owns every
graph of the package; nothing else calls ``torch.cuda.CUDAGraph``.

* A graph holds ONE iteration's body. The body reads its inputs (the
  chunk's draws and hoisted proposals) at a device-side counter, writes
  what it emits there and advances the counter itself, so a chunk of n
  iterations is n replays with no host work between them.
* Every tensor the graph touches keeps its address across replays: the
  carried state, the chunk's inputs and the emitted rows live in static
  buffers (:class:`IterationGraph`), filled with ``copy_`` once a chunk.
* The first iteration of a new graph runs the body eagerly. It is a real
  iteration of the chain: it builds the kernels, loads lazily loaded CUDA
  modules and sets up the autograd and cuBLAS state. Capture starts from
  the next iteration.
* Which runs are captured is declared, not tried: a sampler class whose
  step has static shapes and reads nothing on the host sets
  ``graph_capturable = True`` (read from the class's own ``__dict__``, so a
  subclass declares again), and on a CUDA device its chunks are replays. A
  flow's fits, and the transport layer's loops and FAB's iterations, are
  captured where the bijections they call declare the same
  (:func:`fit_captures`, :func:`transport_captures`). A capture or a
  replay that fails raises; nothing falls back to the eager loop.
* :func:`replays` and :func:`iterations` run any loop of a step
  ``step(carry, consts, rows) -> (carry, outs)`` over the carried tensors,
  the loop's constant tensors and each iteration's inputs: eagerly, or as
  replays of one cached graph, with the inputs made before each block in
  the eager loop's order.
* A kernel wrapper counts its launches on the host
  (:func:`nfmc_torch.ops.build.count_launch`). A replay runs no Python, so
  the launches that the capture recorded are counted once per replay.
* :func:`disable_graphs` runs the eager loop instead, the counterpart of
  ``jax.disable_jit()``: the oracle a replay is held against bit for bit.
* Graphs live on their owner (a sampler's driver, a flow for its fits, a
  ``make_scan_fit`` closure), keyed by what the body bakes in (shapes,
  dtypes, modes and the closure constants), and :data:`CACHE` bounds them
  all, least recently used first.
* While an iteration's body runs (eagerly first, then under capture), code
  that caches tensors across calls holds nothing it was given
  (:func:`in_body`): the static buffers change under replays, which bump no
  version counter.
* A body whose work depends on the data runs it in scopes on device
  predicates, the counterparts of ``lax.cond`` and ``lax.while_loop``:
  :func:`when` and :func:`loop`, conditional IF and WHILE nodes under a
  capture (``csrc/graph_cond.cu`` makes them: PyTorch 2.11 has no Python
  API for them), a host read of the predicate otherwise. A scope's
  launches count once for each run of its body (a device tally).
  :func:`cond` is ``lax.cond`` over a tree of tensors, its branch's result
  written into them in place: a refitting chunk's gated refit, whose
  epochs are a :func:`loop` inside it under the capture. In the graph's
  eager first iteration (:func:`warming`) the refit replays the fit's own
  graph instead, and counts the loop's scope (:func:`eager_scope`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import threading
import time
import weakref
from typing import Callable, List, Sequence, Tuple

import torch

from ..ops import build

_local = threading.local()


@contextlib.contextmanager
def disable_graphs():
    """For the ``with`` block, every chunk runs as the eager loop of the
    step, in this thread (the counterpart of ``jax.disable_jit()``)."""
    before = getattr(_local, "disabled", 0)
    _local.disabled = before + 1
    try:
        yield
    finally:
        _local.disabled = before


@contextlib.contextmanager
def without_capture():
    """For the ``with`` block, a declared sampler takes the graph path on
    any device, with each replay a Python call of the captured body and no
    capture: the static-buffer and counter protocol as the CPU tests run
    it."""
    before = getattr(_local, "uncaptured", 0)
    _local.uncaptured = before + 1
    try:
        yield
    finally:
        _local.uncaptured = before


def in_body() -> bool:
    """Whether an :class:`IterationGraph`'s body is running in this thread
    (its first, eager iteration or its capture)."""
    return bool(getattr(_local, "body", 0))


def warming() -> bool:
    """Whether an :class:`IterationGraph`'s first, eager iteration is
    running in this thread (the capture comes next)."""
    return bool(getattr(_local, "warming", 0))


def declared(sampler, flows=()) -> bool:
    """Whether ``sampler``'s own class declares its step capturable, and
    so does the bijection of each flow in ``flows`` that the step calls
    (RealNVP and the coupling splines do)."""
    return all(bool(type(obj).__dict__.get("graph_capturable", False))
               for obj in (sampler, *(f.bijection for f in flows)))


def captures(device: torch.device, shard=None, tuning: bool = False,
             collective: bool = False) -> bool:
    """Whether a run of a declared sampler on ``device`` goes through
    graphs, decided before the run: on CUDA (or anywhere under
    :func:`without_capture`), outside :func:`disable_graphs`. A tuning step
    on several ranks reduces over them inside the step, and so does every
    step of a sampler whose step is ``collective`` (its class's
    ``collective_step``: PT's swap counts, AIES's partner halves): such a
    run on several ranks runs eagerly."""
    if getattr(_local, "disabled", 0):
        return False
    if (tuning or collective) and shard is not None and shard.size > 1:
        return False
    return device.type == "cuda" or bool(getattr(_local, "uncaptured", 0))


def fit_captures(flow, device: torch.device, shard=None) -> bool:
    """Whether a fit of ``flow`` on ``device`` replays graphs, decided
    before the fit: its bijection declares ``graph_capturable`` and
    :func:`captures` holds as for a tuning step (a fit on several ranks
    reduces its gradient over them every step, so it runs eagerly)."""
    return transport_captures([flow.bijection], device, shard)


def transport_captures(bijections, device: torch.device, shard=None) -> bool:
    """Whether a transport run (AIS, AFT, CRAFT, PMC) or a FAB run on
    ``device`` replays graphs, decided before the run: each of the
    ``bijections`` its steps call declares ``graph_capturable`` (AIS calls
    none) and :func:`captures` holds as for a tuning step (a run over
    several ranks reduces over them inside its steps, so it runs
    eagerly). A captured run on one rank runs its steps unsharded."""
    return (all(bool(type(b).__dict__.get("graph_capturable", False)) for b in bijections)
            and captures(device, shard, tuning=True))


# ---- carried state as a flat list of tensors --------------------------------------------

def flatten(tree) -> Tuple[List[torch.Tensor], object]:
    """``(leaves, spec)``: the tensors of a tree of tuples, lists, dicts and
    dataclasses in a fixed order, and its structure with every other value
    kept as a constant."""
    leaves = []

    def go(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return None
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return (type(node), tuple((f.name, go(getattr(node, f.name)))
                                      for f in dataclasses.fields(node)))
        if isinstance(node, (list, tuple)):
            return (type(node), tuple(go(c) for c in node))
        if isinstance(node, dict):
            return (dict, tuple((k, go(v)) for k, v in node.items()))
        return ("const", node)

    return leaves, go(tree)


def unflatten(spec, leaves: Sequence[torch.Tensor]):
    """The tree of ``spec`` holding ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build_(s):
        if s is None:
            return next(it)
        kind, body = s
        if kind == "const":
            return body
        if kind is dict:
            return {k: build_(v) for k, v in body}
        if dataclasses.is_dataclass(kind):
            return kind(**{name: build_(v) for name, v in body})
        children = [build_(c) for c in body]
        if kind in (list, tuple):
            return kind(children)
        return kind(*children)  # a NamedTuple

    return build_(spec)


def contiguous(tree):
    """``tree`` with each tensor leaf in row-major layout, as the static
    buffers hold it. A run starts (and resumes after a pause) from it on
    either path: a matrix product reads another layout in another order
    (a Cholesky factor comes column-major), and the eager loop would part
    from the replays in the last bits."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [t.contiguous() for t in leaves])


# ---- scopes on device predicates: a conditional and a loop --------------------------------

def when(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body()`` where the 0-d bool tensor ``pred`` holds: the
    counterpart of the JAX package's ``lax.cond`` (a branch that does
    nothing), e.g. one of NUTS's doublings, which runs while a chain runs.

    * Under a CUDA capture ``body`` is captured into a conditional IF node
      on ``pred``: a replay reads ``pred`` on the device and runs or skips
      the body there. Its launches are counted for the replays that take
      the scope (:class:`nfmc_torch.ops.build.Scope`).
    * Otherwise (the eager loop, a graph's first, eager iteration and the
      protocol without capture) ``pred`` is read on the host once and
      ``body()`` runs or not, as a replay would decide.

    A skipped body writes nothing: state that crosses the scope lives in
    tensors made before it, and the body writes them in place (a tensor
    the body makes holds no value after a skipped replay)."""
    if _capturing(pred.device):
        _check_pred(pred)
        _capture_scope(pred.device, pred, lambda: (body(), None)[1], loop=False)
    else:
        eager_scope(pred.device)
        if _decide(pred):
            body()


def cond(pred, fn: Callable, operands):
    """``fn(operands)`` where ``pred`` holds, else ``operands``: the JAX
    package's ``lax.cond(pred, fn, lambda a: a, operands)`` over a tree of
    tensors (a refitting chunk's gated refit). Returns the tree.

    * ``pred`` a host value (a gate the host knows, as the eager loop has
      it): ``fn`` runs or not, with no read of the device.
    * ``pred`` a 0-d bool tensor inside a graph's body (a gate row at the
      counter): :func:`when` on it, ``fn``'s result written into the
      operands in place, so that a skipped body leaves them as they were.
      The operands are tensors made before the scope (the carried state,
      or the iteration's own); under a capture the scope is an IF node and
      no replay computes a branch only to discard it.
    * ``pred`` a tensor elsewhere: read on the host once."""
    if not isinstance(pred, torch.Tensor) or not in_body():
        return fn(operands) if bool(pred) else operands
    leaves, spec = flatten(operands)

    def body():
        new, new_spec = flatten(fn(operands))
        if new_spec != spec:
            raise RuntimeError("a conditional branch changed the structure of its operands")
        for t, v in zip(leaves, new):
            if v is not t:
                t.copy_(v)

    when(pred, body)
    return operands


def loop(n: int, pred: Callable[[torch.Tensor], torch.Tensor],
         body: Callable[[torch.Tensor], None], device: torch.device, every: int = 1) -> None:
    """``body(t)`` for ``t = 0, 1, ...``: the first run always, each next
    while ``t < n`` and ``pred(t)`` (a 0-d bool tensor) holds after the
    run before. ``t`` is an int where the host runs the loop, and a 0-d
    int64 tensor on ``device``, which the loop advances after each run,
    where the runs are decided as on the device (a capture, and the
    protocol without capture). The counterpart of the JAX package's
    ``lax.while_loop`` (NUTS's leaves, ChEES's leapfrogs).

    * Under a CUDA capture the runs are a conditional WHILE node: ``body``
      and ``pred`` are captured once into its body graph, and a replay
      runs it as often as ``pred`` decides on the device. Its launches are
      counted once for each run.
    * Eagerly ``pred(t)`` is read on the host before the runs ``every``,
      ``2 every``, ... (the runs between are not tested: they must leave
      the state as it is where ``pred`` would have stopped the loop, as
      masked updates do). The protocol without capture tests it before
      every run, as a replay does.

    The body writes the state it carries in place, as in :func:`when`."""
    if n < 1:
        return
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _capturing(device):
        t = torch.zeros((), dtype=torch.int64, device=device)

        def run():
            body(t)
            t.add_(1)
            nxt = (t < n) & pred(t)
            _check_pred(nxt)
            return nxt

        _capture_scope(device, None, run, loop=True)
        return
    eager_scope(device)
    t = None
    if in_body() and getattr(_local, "uncaptured", 0):
        # as a replay: tested before every run, at a counter on the device
        t, every = torch.zeros((), dtype=torch.int64, device=device), 1
    for k in range(n):
        at = k if t is None else t
        if k > 0 and k % every == 0 and not _decide(pred(at)):
            break
        body(at)
        if t is not None:
            t.add_(1)


def _capturing(device: torch.device) -> bool:
    """Whether a scope on ``device`` is captured (a CUDA stream capture is
    under way on the current stream)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _check_pred(pred: torch.Tensor) -> None:
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"a scope's predicate is a 0-d bool tensor, not {pred.dtype} "
                         f"{tuple(pred.shape)}")


def _decide(pred: torch.Tensor) -> bool:
    """The one host read of a scope's predicate (outside a capture)."""
    return bool(pred)


def _capture_scope(device: torch.device, pred, run: Callable, loop: bool) -> None:
    """Capture what ``run()`` enqueues into a conditional node of the graph
    being captured (:func:`_node`): an IF node on ``pred``, or a WHILE node
    (``loop``) whose first run is unconditional and whose next runs hold
    where the tensor ``run()`` returns does. The body counts its launches
    for the runs of the node: a device tally of them, made where the body
    launches something counted."""
    with _node(device, pred, loop) as node, build.scope() as sc:
        node.next = run()
        if sc is not None and sc.counts_own():
            sc.tally = _tally(device)
            sc.tally.add_(1)


def _tally(device: torch.device) -> torch.Tensor:
    """A scope's tally: a slot of the capture's tally buffer, made before
    the capture (a tensor made in it could share memory with the
    temporaries the capture frees, which each replay writes again); a
    tensor of its own for a stand-in node outside a real capture."""
    cap = getattr(_local, "capture", None)
    if cap is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    if cap.tallies is None or cap.n_tallies == cap.tallies.numel():
        raise RuntimeError(f"the capture opened more scopes that count launches than the "
                           f"{0 if cap.tallies is None else cap.tallies.numel()} tallies sized "
                           f"from the {cap.eager_scopes} scopes of its eager iteration")
    cap.n_tallies += 1
    return cap.tallies[cap.n_tallies - 1]


class _Node:
    """A conditional node being captured: ``next`` is a WHILE body's test
    for its next run (None for an IF node)."""

    next = None


@contextlib.contextmanager
def _node(device: torch.device, pred, loop: bool):
    """For the ``with`` block, the current stream captures into the body of
    a new conditional node (``csrc/graph_cond.cu``): a stream of its own,
    its allocations in the capture's scope pool (a body's capture is not
    the graph's, whose pool takes none of them). Raises where the node is
    refused: nothing falls back to a host read."""
    cap = getattr(_local, "capture", None)
    streams = _scope_streams.get(str(device))
    if cap is None or streams is None:
        raise RuntimeError("a scope is captured only inside an IterationGraph's capture, after "
                           "the graph's first, eager iteration")
    depth = cap.scope_depth
    if depth >= len(streams):
        raise RuntimeError(f"more than {len(streams)} scopes open at once in a capture")
    lib = build.library("graph_cond")
    child = streams[depth]
    handle = ctypes.c_ulonglong(0)
    err = lib.nfmc_cond_begin(torch.cuda.current_stream(device).cuda_stream,
                              None if pred is None else pred.data_ptr(), child.cuda_stream,
                              int(loop), ctypes.byref(handle))
    if err:
        status = [lib.nfmc_cond_status(st.cuda_stream) for st in streams]
        raise RuntimeError(f"CUDA refused a graph conditional node (cudaError "
                           f"{err % 10000} at step {err // 10000} of nfmc_cond_begin, at scope "
                           f"depth {depth}, the scope streams' capture status {status}): NUTS's "
                           "and ChEES's trajectories cannot be captured")
    index = device.index
    if depth == 0:
        if cap.scope_pool is None:
            cap.scope_pool = torch.cuda.graph_pool_handle()
        torch._C._cuda_beginAllocateToPool(index, cap.scope_pool)
    cap.scope_depth += 1
    node = _Node()
    try:
        with torch.cuda.stream(child):
            yield node
    finally:
        cap.scope_depth -= 1
        err = lib.nfmc_cond_end(child.cuda_stream, handle,
                                None if node.next is None else node.next.data_ptr())
        if depth == 0:
            torch._C._cuda_endAllocateToPool(index, cap.scope_pool)
            if cap.holds_pool:
                torch._C._cuda_releasePool(index, cap.scope_pool)
            else:
                # the first scope's reference to the pool is the graph's,
                # given back when the graph goes (before, the allocator could
                # free blocks that the graph's bodies use)
                cap.holds_pool = True
                weakref.finalize(cap, torch._C._cuda_releasePool, index,
                                 cap.scope_pool).atexit = False
    if err:
        raise RuntimeError(f"a conditional node's body did not capture (cudaError "
                           f"{err % 10000} at step {err // 10000} of nfmc_cond_end)")


def eager_scope(device: torch.device) -> None:
    """A scope decided on the host, or one that a graph's capture opens
    where its first, eager iteration does the same work without one (a
    refit's epochs, there replayed from the fit's own graph). In a graph's
    first, eager iteration on CUDA (its capture comes next): count it (the
    capture's tallies are sized from the count), and, once a process, load
    the conditional nodes' library and kernel and make the device's body
    streams. A no-op elsewhere."""
    key = str(device)
    if device.type != "cuda" or not in_body():
        return
    _local.eager_scopes = getattr(_local, "eager_scopes", 0) + 1
    if key in _scope_streams:
        return
    lib = build.library("graph_cond")
    err = lib.nfmc_cond_warm()
    if err:
        raise RuntimeError(f"the conditional nodes' kernel does not load (cudaError {err})")
    streams = [lib.nfmc_cond_stream() for _ in range(MAX_SCOPE_DEPTH)]
    if not all(streams):
        raise RuntimeError("no stream could be made for the conditional nodes' bodies")
    _scope_streams[key] = [torch.cuda.ExternalStream(s, device=device) for s in streams]


def check_host_counts(info) -> None:
    """Raise where a captured step reports a count on the host
    (``StepInfo.n_calls`` / ``n_grads`` as a Python int other than 0): a
    replay would not report it."""
    for name in ("n_calls", "n_grads"):
        v = getattr(info, name)
        if not isinstance(v, torch.Tensor) and v != 0:
            raise RuntimeError(f"a captured step reported {name}={v} on the host; a graph replay "
                               "cannot count it (declare the class without graph_capturable)")


# ---- one captured iteration ---------------------------------------------------------------

# the most scopes (:func:`when`, :func:`loop`) open at once in a capture (a
# doubling of a NUTS step and its leaves in it; a gated refit and its
# epochs)
MAX_SCOPE_DEPTH = 4
# the streams that capture the scopes' bodies, one for each depth of open
# scopes, by device (made by :func:`eager_scope`)
_scope_streams: dict = {}


class _CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on a stream of its own, and for
    a graph with conditional scopes, the pool their allocations come from,
    which lives as long as the graph, and their tallies."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.pool_bytes = 0
        # made by the first scope: a pool id and no MemPool object (a
        # MemPool's destructor empties the cache, which the allocator
        # refuses while any capture is under way, or was left open by a
        # capture that failed)
        self.scope_pool = None
        self.holds_pool = False
        self.scope_depth = 0
        # the scopes that the graph's eager iteration entered (set by
        # IterationGraph.run), and the tallies made from them
        self.eager_scopes = 0
        self.tallies = None
        self.n_tallies = 0

    @contextlib.contextmanager
    def side_stream(self):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], None]) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.eager_scopes:
            # a tally for each scope the capture may open: a skipped IF body
            # hid the scopes nested in it from the eager iteration (NUTS's
            # doubling holds one loop), so twice those it entered, and 16 more
            self.tallies = torch.zeros(2 * self.eager_scopes + 16, dtype=torch.int64,
                                       device=self.device)
        before = torch.cuda.memory_reserved(self.device)
        # a collection inside the capture may free another graph, whose
        # destruction is not permitted while a stream captures
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self.side_stream():
                # thread_local: the NCCL watchdog and the autograd engine's
                # threads may query events while this thread captures
                graph.capture_begin(capture_error_mode="thread_local")
                _local.capture = self
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already; raise its cause
                    raise
                graph.capture_end()
        finally:
            _local.capture = None
            if collecting:
                gc.enable()
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before

    def replay(self) -> None:
        self.graph.replay()


class _Uncaptured:
    """The protocol without capture: "capturing" keeps the body, and a
    replay calls it (its launches then count themselves)."""

    pool_bytes = 0

    def __init__(self, device):
        self.fn = None

    @contextlib.contextmanager
    def side_stream(self):
        yield

    def capture(self, fn: Callable[[], None]) -> None:
        self.fn = fn

    def replay(self) -> None:
        self.fn()


class IterationGraph:
    """One iteration's ``body(state, rows) -> (state', outs)`` over static
    buffers: ``state`` the carried tensors, ``rows`` each input's row at the
    counter, ``outs`` the rows written at the counter into each output.
    ``state`` gives the carried tensors' shapes; ``inputs`` and ``outputs``
    are ``(shape, dtype)`` of whole buffers, their first axis the chunk's.
    """

    def __init__(self, body: Callable, state: Sequence[torch.Tensor], inputs, outputs,
                 device: torch.device, backend=None):
        self.body = body
        self.device = device
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.state = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in state]
        self.inputs = [torch.empty(s, dtype=d, device=device) for s, d in inputs]
        self.outputs = [torch.empty(s, dtype=d, device=device) for s, d in outputs]
        # the most iterations a chunk may run from the counter's 0
        self.length = min([t.shape[0] for t in self.inputs + self.outputs], default=None)
        if backend is None:
            backend = _Uncaptured if getattr(_local, "uncaptured", 0) else _CudaGraph
        self.backend = backend(device)
        self.captured = False
        self.capture_seconds = 0.0  # the capture's wall, on the host
        self.warm = False
        self.events: list = []
        self.replays = 0

    @property
    def nbytes(self) -> int:
        """The static buffers' bytes and the memory the capture took."""
        bufs = [self.counter, *self.state, *self.inputs, *self.outputs]
        return sum(t.numel() * t.element_size() for t in bufs) + self.backend.pool_bytes

    def _iteration(self) -> None:
        idx = self.counter.view(1)
        rows = [b.index_select(0, idx)[0] for b in self.inputs]
        _local.body = getattr(_local, "body", 0) + 1
        try:
            new_state, outs = self.body(self.state, rows)
        finally:
            _local.body -= 1
        for b, o in zip(self.outputs, outs, strict=True):
            b.index_copy_(0, idx, o.unsqueeze(0))
        for s, n in zip(self.state, new_state, strict=True):
            if n is not s:
                s.copy_(n)
        self.counter.add_(1)

    def set_state(self, state: Sequence[torch.Tensor]) -> None:
        """Copy carried state in (where it is not the static buffer itself),
        leaving the counter where it is: a chunk paused for eager work on
        its state goes on at the next row."""
        for s, t in zip(self.state, state, strict=True):
            if t is not s:
                s.copy_(t)

    def load(self, state: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor]) -> None:
        """Copy a chunk's carried state and inputs in, and set the counter
        to 0."""
        self.set_state(state)
        for b, t in zip(self.inputs, inputs, strict=True):
            b[: t.shape[0]].copy_(t)
        self.counter.zero_()

    def run(self, n: int) -> None:
        """``n`` iterations from the counter: the first of a new graph
        eagerly, then replays (the capture made before the first)."""
        if self.length is not None and n > self.length:
            raise ValueError(f"a chunk of {n} iterations exceeds the static buffers' {self.length}")
        done = 0
        if not self.warm and n > 0:
            seen = getattr(_local, "eager_scopes", 0)
            _local.warming = getattr(_local, "warming", 0) + 1
            try:
                with self.backend.side_stream():
                    self._iteration()
            finally:
                _local.warming -= 1
            self.backend.eager_scopes = getattr(_local, "eager_scopes", 0) - seen
            self.warm, done = True, 1
        if done < n and not self.captured:
            t0 = time.perf_counter()
            with build.recording() as events:
                self.backend.capture(self._iteration)
            build.arm(events)
            self.events, self.captured = events, True
            self.capture_seconds = time.perf_counter() - t0
        for _ in range(n - done):
            self.backend.replay()
        self.replays += n - done
        build.count_replays(self.events, n - done)


# ---- the cache ------------------------------------------------------------------------------

class GraphCache:
    """Bounds the graphs of every owner, least recently used first: at most
    ``max_graphs`` graphs and ``max_bytes`` of static buffers and capture
    memory. An owner (a driver, a flow, a fit's closure) keeps its graphs
    in ``owner._graphs``; the cache holds the owners weakly, so an owner's
    graphs go with it."""

    def __init__(self, max_graphs: int = 32, max_bytes: int = 8 << 30):
        self.max_graphs, self.max_bytes = max_graphs, max_bytes
        # (id(owner), key) -> (weak owner, weak graph): nothing here keeps
        # an owner or a graph alive
        self._order = collections.OrderedDict()

    def get(self, owner, key, make: Callable[[], IterationGraph]) -> IterationGraph:
        self._drop_gone()
        graphs = owner.__dict__.setdefault("_graphs", {})
        slot = (id(owner), key)
        if key in graphs:
            self._order.move_to_end(slot)
            return graphs[key]
        graph = graphs[key] = make()
        self._order[slot] = (weakref.ref(owner), weakref.ref(graph))
        while len(self._order) > 1 and (len(self._order) > self.max_graphs
                                        or self.nbytes() > self.max_bytes):
            (_owner, old_key), (old_ref, _g) = self._order.popitem(last=False)
            old_owner = old_ref()
            if old_owner is not None:
                old_owner.__dict__.get("_graphs", {}).pop(old_key, None)
        return graph

    def _drop_gone(self) -> None:
        # the slots of owners that are gone, dropped here and not from a
        # weakref callback: a callback runs inside whatever allocation
        # collects its owner, even one made while the order is iterated
        # (a key's hash may allocate), and would mutate it there
        for slot in [s for s, (ref, _g) in self._order.items() if ref() is None]:
            del self._order[slot]

    def nbytes(self) -> int:
        self._drop_gone()
        graphs = [w() for _r, w in self._order.values()]
        return sum(g.nbytes for g in graphs if g is not None)

    def __len__(self) -> int:
        self._drop_gone()
        return len(self._order)

    def describe(self) -> str:
        return f"{len(self)} graphs, {self.nbytes() / 2 ** 20:.1f} MiB"

    def clear(self) -> None:
        for (_owner, key), (ref, _g) in list(self._order.items()):
            owner = ref()
            if owner is not None:
                owner.__dict__.get("_graphs", {}).pop(key, None)
        self._order.clear()


CACHE = GraphCache()


def signature(tensors) -> tuple:
    """Shapes and dtypes of ``tensors``, for a cache key."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


# ---- a loop of a step, eager or replayed ----------------------------------------------------

def replays(owner, config: tuple, step: Callable, outs, length: int, keep=()):
    """``graph_of(carry, consts, inputs)`` for :func:`iterations`: the graph
    of one iteration of ``step(carry, consts, rows) -> (carry, outs)``,
    cached on ``owner`` (made on first use). ``carry`` holds the carried
    tensors, ``consts`` the loop's constant ones, ``inputs`` the
    iterations' inputs, stacked; ``outs`` gives the ``(shape, dtype)`` of
    an iteration's outputs, ``length`` the iterations the static buffers
    hold. The key holds ``config`` (what the body bakes in: the step's
    closure is that of the call that made the graph), the shapes and the
    ids of ``keep``, which the graph keeps alive."""

    def graph_of(carry, consts, inputs):
        state = [*carry, *consts]
        n_carry = len(carry)
        key = (config, str(state[0].device), n_carry, signature(state),
               signature(t[0] for t in inputs), length, tuple(id(k) for k in keep))

        def make():
            @functools.wraps(step)  # a body names the step it runs
            def body(st, rows):
                fixed = list(st[n_carry:])
                new, outs_ = step(list(st[:n_carry]), fixed, rows)
                return list(new) + fixed, outs_

            graph = IterationGraph(
                body, state, [((length, *t.shape[1:]), t.dtype) for t in inputs],
                [((length, *shape), dtype) for shape, dtype in outs], state[0].device)
            graph.constants = keep  # keeps the ids of the key valid
            return graph

        return CACHE.get(owner, key, make)

    return graph_of


def iterations(step: Callable, carry: list, consts: list, draw: Callable, n: int,
               graph_of=None, length: int = 1):
    """``n`` iterations of ``step(carry, consts, rows) -> (carry, outs)``,
    ``rows`` each iteration's inputs: ``draw(k)`` makes k iterations'
    inputs, stacked, in the eager loop's order. Eager when ``graph_of`` is
    None; else ``graph_of(carry, consts, inputs)`` (:func:`replays`) gives
    the graph, which replays ``length`` iterations at a time, its inputs
    made before each run. Returns ``(carry, consts, outs)``, each output
    stacked over the iterations, on the device (an empty list when n is
    0). The carried tensors returned may be the graph's static buffers,
    which its next run overwrites."""
    parts = []
    if graph_of is None:
        for _ in range(n):
            carry, outs = step(carry, consts, [t[0] for t in draw(1)])
            parts.append([o.unsqueeze(0) for o in outs])
    else:
        done = 0
        while done < n:
            k = min(length, n - done)
            inputs = draw(k)
            graph = graph_of(carry, consts, inputs)
            graph.load(carry + consts, inputs)
            graph.run(k)
            carry, consts = list(graph.state[:len(carry)]), list(graph.state[len(carry):])
            parts.append([o[:k].clone() for o in graph.outputs])
            done += k
    return list(carry), consts, [torch.cat(col) for col in zip(*parts)]


def sliced(inputs: Sequence[torch.Tensor]) -> Callable:
    """``draw(k)`` for :func:`iterations` over inputs made beforehand (each
    stacked over the iterations): the next k rows of each."""
    at = [0]

    def draw(k):
        out = [t[at[0]:at[0] + k] for t in inputs]
        at[0] += k
        return out

    return draw


def hoist_length(block: int, row_elems: int) -> int:
    """The iterations a graph's static buffers hold: a block, capped so
    that its hoisted inputs stay under the driver's footprint limit."""
    from .driver import RNG_HOIST_ELEMENT_LIMIT

    return max(1, min(block, RNG_HOIST_ELEMENT_LIMIT // max(1, row_elems)))


__all__ = ["CACHE", "GraphCache", "IterationGraph", "captures", "check_host_counts", "cond",
           "contiguous", "declared", "disable_graphs", "eager_scope", "fit_captures", "flatten",
           "hoist_length", "in_body", "iterations", "loop", "replays", "signature", "sliced",
           "transport_captures", "unflatten", "warming", "when", "without_capture"]

"""The samplers whose trajectories have a data-dependent length, NUTS and
ChEES-HMC with their jump and NeuTra forms, as graph replays: their loops
are scopes on device predicates (``graphs.when`` and ``graphs.loop``, CUDA
graph conditional IF and WHILE nodes under a capture). On the CPU through
the capture layer's protocol
(``graphs.without_capture``), at d=4 with 8 chains, NUTS at depth 4 and
ChEES at 16 leapfrogs at most:

* each path, warmup and sampling, gives the eager loop's run
  (``graphs.disable_graphs``) bit for bit: draws, counters, moments, the
  final kernel state, ``tree_depths()`` and ``leapfrog_total``;
* no body reads a tensor on the host but a scope's predicate in
  ``graphs._decide`` (which a capture leaves to the device);
* ``when``'s and ``loop``'s contracts: a skipped body writes nothing, a
  loop runs while its predicate holds, and a capture counts a scope's
  launches once for each run a replay made of it (its tally);
* a NUTS chunk and a ChEES chunk through the protocol against the JAX
  package's steps with the same injected draws, to 1e-5 a step;
* on the card (marker ``cuda``, skipped here): an IF node, NUTS and ChEES
  captured for real. Run them there with ``python -m pytest --noconftest
  -m cuda tests/test_torch_dynamic_graph.py``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.core import graphs
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.ops import build
from nfmc_torch.potentials import DiagonalGaussian
from nfmc_torch.samplers.mcmc import nuts_impl
from nfmc_torch.utils import tree_leaves
from tests.test_torch_sampler_graph import graph_runs, no_host_reads  # noqa: F401 (fixtures)

D, C, WARM, ITERS, OUTER = 4, 8, 10, 16, 4
TARGET = DiagonalGaussian(np.linspace(-0.5, 0.5, D).astype(np.float32),
                          np.linspace(0.5, 2.0, D).astype(np.float32))
NUTS_KW = {"max_tree_depth": 4}
CHEES_KW = {"max_leapfrog_steps": 16, "step_size": 0.15, "trajectory_length": 2.0}
PATHS = {
    "nuts": dict(kernel_kwargs=NUTS_KW),
    "chees_hmc": dict(kernel_kwargs=CHEES_KW),
    "jump_nuts": dict(inner_kernel_kwargs=NUTS_KW),
    "jump_chees": dict(inner_kernel_kwargs=CHEES_KW),
    "neutra_chees": dict(inner_kernel_kwargs=CHEES_KW,
                         param_kwargs={"warmup_fit_kwargs": {"n_epochs": 0}}),
}


@pytest.fixture(autouse=True)
def _one_thread_short_checks(monkeypatch):
    """One torch thread; the eager loop checks for a running NUTS chain
    every 2 leaves, so that these short subtrees stop early eagerly, while
    the protocol checks every leaf, as a replay does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(nuts_impl, "NUTS_SYNC_LEAVES", 2)
    yield
    torch.set_num_threads(threads)


def _x0(n=C, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32))


def _numbers(v) -> list:
    """Every number of a kernel's host state, in a fixed order."""
    if isinstance(v, torch.Tensor):
        return [v.detach().cpu().numpy()]
    if isinstance(v, np.ndarray):
        return [v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return [n for f in dataclasses.fields(v) for n in _numbers(getattr(v, f.name))]
    if isinstance(v, (list, tuple)):
        return [n for c in v for n in _numbers(c)]
    if isinstance(v, (bool, int, float, str, type(None))):
        return [v]
    return []


def _run(strategy, ctx, time_limit=None):
    kw = {k: dict(v) for k, v in PATHS[strategy].items()}
    jump = strategy.startswith("jump")
    params = {"n_iterations": OUTER if jump else ITERS, "n_warmup_iterations": WARM,
              **kw.pop("param_kwargs", {})}
    if jump:
        kw["inner_param_kwargs"] = {"n_iterations": 2, "n_warmup_iterations": WARM}
        params["flow_fit_kwargs"] = {"n_epochs": 2, "batch_size": 16}
    flow = (Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=0)
            if jump or strategy.startswith("neutra") else None)
    s = nfmc_torch.create_sampler(TARGET, event_shape=(D,), flow=flow, strategy=strategy,
                                  param_kwargs=params, device="cpu", **kw)
    x0 = _x0()
    with ctx:
        s.warmup(x0, show_progress=False, seed=1, time_limit_seconds=time_limit)
        out = s.sample(x0, show_progress=False, seed=2, time_limit_seconds=time_limit)
    inner = getattr(s, "inner_sampler", s)
    state = {k: _numbers(v) for k, v in vars(inner.kernel).items() if k != "da_params"}
    if hasattr(inner, "tree_depths"):
        state["tree_depths"] = list(inner.tree_depths())
    if hasattr(inner, "leapfrog_total"):
        state["leapfrog_total"] = [inner.leapfrog_total]
    if flow is not None:
        state["flow"] = [t.detach().numpy() for t in tree_leaves(s.kernel.flow.params)]
    return out, state


def _assert_same(a, b):
    (ea, ka), (eb, kb) = a, b
    assert torch.equal(ea.samples, eb.samples)
    np.testing.assert_array_equal(ea.mean, eb.mean)
    np.testing.assert_array_equal(ea.variance, eb.variance)
    assert {k: v for k, v in vars(ea.statistics).items() if isinstance(v, int)} == {
        k: v for k, v in vars(eb.statistics).items() if isinstance(v, int)}
    assert ka.keys() == kb.keys()
    for k in ka:
        assert len(ka[k]) == len(kb[k]), k
        for x, y in zip(ka[k], kb[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


@pytest.mark.parametrize("strategy,time_limit", [
    ("nuts", None), ("nuts", 1e9), ("chees_hmc", None), ("chees_hmc", 1e9),
    ("jump_nuts", None), ("jump_chees", None), ("neutra_chees", None)])
def test_protocol_matches_eager_loop(strategy, time_limit, graph_runs, no_host_reads):  # noqa: F811
    """Warmup and sampling through the body the layer captures, its static
    buffers and counter (chunks 1, 4, 16, ... under the time limit), give
    the eager loop's run bit for bit, and a body reads nothing on the host
    but its scopes' predicates."""
    eager = _run(strategy, graphs.disable_graphs(), time_limit)
    assert graph_runs == []
    graphed = _run(strategy, graphs.without_capture(), time_limit)
    assert graph_runs and (time_limit is None or len(graph_runs) >= 4)
    _assert_same(eager, graphed)
    state = graphed[1]
    if "nuts" in strategy:
        assert state["tree_depths"][1] >= 3
    else:
        # some trajectory looped past its first leapfrog
        steps = WARM + (2 * OUTER if strategy.startswith("jump") else ITERS)
        assert state["leapfrog_total"][0] > steps


def test_when_skips_and_runs_as_its_predicate_says(no_host_reads):  # noqa: F811
    """A skipped body writes nothing and a taken one runs, eagerly and in a
    body without capture."""
    buf = torch.arange(3.0)
    graphs.when(torch.tensor(False), lambda: buf.add_(1))
    assert torch.equal(buf, torch.arange(3.0))
    graphs.when(torch.tensor(True), lambda: buf.add_(1))
    assert torch.equal(buf, torch.arange(3.0) + 1)

    def body(state, rows):
        (b,) = state
        graphs.when(rows[0][0], lambda: b.mul_(2))
        graphs.when(rows[0][1], lambda: b.add_(10))
        return [b], []

    flags = torch.tensor([[True, False], [False, False], [False, True]])
    with graphs.without_capture():
        g = graphs.IterationGraph(body, [buf], [((3, 2), torch.bool)], [], torch.device("cpu"))
    g.load([buf], [flags])
    g.run(3)  # eager, then two "replays"
    assert torch.equal(g.state[0], (torch.arange(3.0) + 1) * 2 + 10)


def test_loop_runs_while_its_predicate_holds(no_host_reads):  # noqa: F811
    """``loop``'s first run is unconditional and the count bounds it;
    eagerly the predicate is read every ``every`` runs, in a body without
    capture before every run, as a replay tests it; the body sees the
    counter."""
    seen = []
    stop = torch.tensor(5)

    def run(every):
        seen.clear()
        graphs.loop(8, lambda t: t < stop, lambda t: seen.append(int(t)), torch.device("cpu"),
                    every=every)
        return list(seen)

    assert run(1) == [0, 1, 2, 3, 4]
    assert run(3) == [0, 1, 2, 3, 4, 5]  # tested before runs 3 and 6
    stop.fill_(0)
    assert run(1) == [0]
    stop.fill_(100)
    assert run(1) == list(range(8))

    def body(state, rows):
        (b,) = state
        graphs.loop(6, lambda t: t < rows[0], lambda t: b.add_(1), b.device, every=4)
        return [b], []

    with graphs.without_capture():
        g = graphs.IterationGraph(body, [torch.zeros(())], [((3,), torch.int64)], [],
                                  torch.device("cpu"))
        g.load([torch.zeros(())], [torch.tensor([2, 0, 5])])
        g.run(3)
    assert float(g.state[0]) == 2 + 1 + 5


def test_loop_index_is_a_host_int_eagerly_and_a_device_counter_as_a_replay(
        no_host_reads):  # noqa: F811
    """Where the host runs a loop, its body gets the run's index as an int
    (NUTS's leaf then indexes its stack on the host); in a body without
    capture, as a replay, a 0-d int64 tensor that the loop advances."""
    kinds = []
    graphs.loop(3, lambda t: torch.tensor(True), kinds.append, torch.device("cpu"), every=8)
    assert kinds == [0, 1, 2] and all(type(k) is int for k in kinds)

    def body(state, rows):
        (b,) = state

        def run(t):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int64 and t.dim() == 0
            b.add_(t)

        graphs.loop(4, lambda t: t < rows[0], run, b.device)
        return [b], []

    zero = torch.zeros((), dtype=torch.int64)
    with graphs.without_capture():
        g = graphs.IterationGraph(body, [zero], [((2,), torch.int64)], [], torch.device("cpu"))
        g.load([zero], [torch.tensor([3, 4])])
        g.run(2)  # eager, then a "replay": both decided as on the device
    assert int(g.state[0]) == (0 + 1 + 2) + (0 + 1 + 2 + 3)


def test_scope_tallies_count_the_scopes_taken(monkeypatch):
    """Under a capture every scope's body is recorded once, each scope that
    counts launches of its own gets a device tally, and the replays count
    a scope's launches as often as its tally says it was taken (the
    conditional nodes' work, done here by hand), nested scopes by their
    own tallies, a loop's once for each run; the tallies read 0 after
    each count."""
    class Wrapper:
        launches = 0

    captured = []

    @contextlib.contextmanager
    def node(device, pred, loop):
        captured.append((pred, loop))
        yield graphs._Node()

    monkeypatch.setattr(graphs, "_capturing", lambda pred: True)
    monkeypatch.setattr(graphs, "_node", node)
    p = torch.zeros(2, dtype=torch.bool)

    def iteration():
        build.count_launch(Wrapper, ("top",))
        graphs.when(p[0], lambda: build.count_launch(Wrapper, ("a",)))

        def outer():
            graphs.when(p[0], lambda: build.count_launch(Wrapper, ("nested",), 1))
        graphs.when(p[1], outer)
        graphs.loop(4, lambda t: t < 3, lambda t: build.count_launch(Wrapper, ("loop",)),
                    torch.device("cpu"))

    with build.recording() as events:
        iteration()
    build.arm(events)
    assert [loop for _p, loop in captured] == [False, False, False, True]
    top, a, outer_sc, looped = events
    assert looped.tally is not None  # its body ran once, at the capture
    assert isinstance(a, build.Scope) and a.tally is not None and int(a.tally) == 0
    assert isinstance(outer_sc, build.Scope) and outer_sc.tally is None  # counts nothing itself
    (nested,) = outer_sc.events
    assert nested.tally is not None

    # four replays: p = (T, F), (T, T), (F, T), (F, F); the device adds one
    # to a scope's tally where the replay takes it, and one to the loop's
    # each time its body runs (3 runs a replay)
    for taken0, taken1 in ((True, False), (True, True), (False, True), (False, False)):
        if taken0:
            a.tally.add_(1)
        if taken1 and taken0:
            nested.tally.add_(1)
        looped.tally.add_(3)
    build.count_replays(events, 4)
    assert Wrapper.launches == 4 + 2 + 1 + 12
    assert int(a.tally) == 0 and int(nested.tally) == 0 and int(looped.tally) == 0
    build.count_replays(events, 2)  # two replays that took no scope and ran no loop
    assert Wrapper.launches == 19 + 2


def _nuts_jax_pair():
    import jax
    from nfmc_tpu.samplers.mcmc.nuts import NUTS as JNUTS
    from nfmc_tpu.samplers.mcmc.nuts import NUTSKernel as JNUTSKernel
    from nfmc_torch.samplers.mcmc import NUTS, NUTSKernel
    from tests.test_torch_nuts import _diag

    jax_u, torch_u = _diag(0.5 + np.arange(D) / D)
    js = JNUTS((D,), jax_u, JNUTSKernel(event_size=D, max_tree_depth=4, step_size=0.3))
    ts = NUTS((D,), torch_u, NUTSKernel(event_size=D, max_tree_depth=4, step_size=0.3),
              device="cpu")
    js.params.imd_adjustment = ts.params.imd_adjustment = 0.2
    return jax, js, ts


def _driver_run(ts, draws, n, tuning, x0):
    """``n`` iterations of ``ts`` from ``x0`` with the injected ``draws``
    through the driver's protocol: (each iteration's states, the final
    kernel state, the statistics)."""
    from nfmc_torch.core.driver import ChunkedScanDriver
    from nfmc_torch.core.samples import MCMCSamples
    from nfmc_torch.core.statistics import MCMCStatistics

    d = x0.shape[1]
    driver = ChunkedScanDriver((d,), ts._make_chunk_step, lambda g, prefix, k: draws,
                               make_precompute=ts._make_precompute,
                               make_step_aux=ts._make_step_precomputed, capturable=True)
    samples = MCMCSamples((d,))
    stats = MCMCStatistics((d,))
    with graphs.without_capture():
        x, state = driver.run(torch.from_numpy(x0), ts.kernel.make_state("cpu"), torch.Generator(),
                              n, stats=stats, samples=samples, tuning=tuning)
    return samples.as_tensor(), state, stats


def test_nuts_chunk_protocol_matches_jax_steps(graph_runs):  # noqa: F811
    """Five tuning iterations of NUTS through the driver's protocol, its
    trajectories in scopes, against the JAX package's steps with the same
    numbers (rebuilt from its keys): each step's states to 1e-5, the
    dual-averaged step size and the counters."""
    from tests.test_torch_nuts import TOL, chain_draws

    jax, js, ts = _nuts_jax_pair()
    import jax.numpy as jnp

    n = 5
    x0 = np.random.default_rng(5).standard_normal((C, D)).astype(np.float32)
    jstep = jax.jit(js._make_step(True))
    jx, jm = jnp.asarray(x0), js.kernel.make_state()
    want, calls, draws = [], 0, []
    for it in range(n):
        key = jax.random.key(10 + it)
        jx, jm, jinfo = jstep(jx, jm, key)
        want.append(np.asarray(jx))
        calls += int(jinfo.n_calls)
        draws.append(chain_draws(jax.random.split(key, C), D, 4))
    stacked = tuple(torch.stack(col) for col in zip(*draws))
    ys, state, stats = _driver_run(ts, stacked, n, True, x0)
    assert graph_runs == [n]
    for it in range(n):
        assert float(np.max(np.abs(ys[it].numpy() - want[it]))) <= TOL * max(
            1.0, float(np.abs(want[it]).max())), it
    np.testing.assert_allclose(float(state.step_size), float(jm.step_size), rtol=TOL)
    assert stats.n_target_calls == stats.n_target_gradient_calls == calls
    assert ts.tree_depths()[1] >= 3


@pytest.mark.parametrize("tuning", [False, True])
def test_chees_chunk_protocol_matches_jax_steps(tuning, graph_runs):  # noqa: F811
    """Six ChEES iterations through the driver's protocol (sampling: the
    chunk's counts precomputed; tuning: each step's own), the leapfrogs in
    scopes, against the JAX package's steps with the same draws: each
    step's states to 1e-5, the adapted state and the 2 L C + 2 C / 2 L C
    counters."""
    import jax
    import jax.numpy as jnp
    from tests.test_torch_chees import C as CC
    from tests.test_torch_chees import D as CD
    from tests.test_torch_chees import SIGMA, TOL, _compare_state, _pair

    js, ts = _pair("halton", max_leapfrog_steps=16)
    n = 6
    rng = np.random.default_rng(7)
    x0 = (SIGMA * rng.standard_normal((CC, CD))).astype(np.float32)
    draws = [(rng.standard_normal((CC, CD)).astype(np.float32),
              np.log(rng.random(CC)).astype(np.float32), np.float32(1.0 - rng.random()))
             for _ in range(n)]
    jstep = jax.jit(js._make_step_aux(tuning))
    jx, jst = jnp.asarray(x0), js.kernel.make_state()
    want, grads = [], 0
    for d in draws:
        jx, jst, jinfo = jstep(jx, jst, None, tuple(jnp.asarray(a) for a in d))
        want.append(np.asarray(jx))
        grads += int(jinfo.n_grads)
    stacked = tuple(torch.from_numpy(np.stack(col)) for col in zip(*draws))
    ys, state, stats = _driver_run(ts, stacked, n, tuning, x0)
    assert graph_runs == [n]
    for it in range(n):
        assert float(np.max(np.abs(ys[it].numpy() - want[it]))) <= TOL * max(
            1.0, float(np.abs(want[it]).max())), it
    _compare_state(state, jst)
    assert stats.n_target_gradient_calls == grads == 2 * ts.leapfrog_total * CC
    assert stats.n_target_calls == grads + 2 * CC * n


# ---- on the card ------------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: conditional nodes are captured on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_if_node_on_the_card():
    """An IF node taken and skipped across replays, nested in another, with
    a counted launch inside: the counters, the state and the launch count
    equal the eager loop's (``chip_smoke.run_conditional_probe``)."""
    import chip_smoke

    chip_smoke.run_conditional_probe(_card())


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["nuts", "chees_hmc", "jump_nuts", "neutra_chees"])
def test_dynamic_paths_capture_on_the_card(strategy):
    """NUTS and ChEES (and a jump and a NeuTra form) captured for real, each
    iteration one replay, bit for bit against the eager loop."""
    dev = _card()
    runs = []
    orig = graphs.IterationGraph.run

    def run(ctx):
        kw = {k: dict(v) for k, v in PATHS[strategy].items()}
        if strategy.startswith("jump"):
            kw["inner_param_kwargs"] = {"n_iterations": 2}
        flow = (Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=0)
                if "jump" in strategy or "neutra" in strategy else None)
        with ctx:
            out = nfmc_torch.sample(TARGET, strategy=strategy, flow=flow, n_chains=C,
                                    n_iterations=ITERS, n_warmup_iterations=WARM,
                                    warmup=not strategy.startswith("jump"), seed=0,
                                    show_progress=False, device=dev, **kw)
        torch.cuda.synchronize()
        return out

    graphs.IterationGraph.run = lambda self, n: (runs.append(self), orig(self, n))[1]
    try:
        eager = run(graphs.disable_graphs())
        assert runs == []
        graphed = run(contextlib.nullcontext())
    finally:
        graphs.IterationGraph.run = orig
    assert runs and all(isinstance(g.backend, graphs._CudaGraph) and g.captured for g in runs)
    assert torch.equal(eager.samples, graphed.samples)
    np.testing.assert_array_equal(eager.mean, graphed.mean)
    assert eager.statistics.n_target_calls == graphed.statistics.n_target_calls

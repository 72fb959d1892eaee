"""ChunkedScanDriver and the capture layer (nfmc_torch.core.graphs) on the CPU.

* the JAX package's ChunkedScanDriver and the port's run the same
  deterministic steps to the same stored rows, counters and moments, with
  thinning and max_samples;
* each captured path's body, run through the layer's static-buffer and
  counter protocol without capture (``graphs.without_capture``), gives the
  eager loop's run (``graphs.disable_graphs``) bit for bit, pipelined and
  under a time limit that never stops it (chunks of 1, 4, 16, ...);
* with stand-in counters and stand-in graphs: a replay counts the launches
  its capture recorded, the cache keeps its bound, and a declared step that
  reports a count on the host raises.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.core import graphs
from nfmc_torch.core.driver import ChunkedScanDriver, StepInfo
from nfmc_torch.core.samples import MCMCSamples
from nfmc_torch.core.statistics import MCMCStatistics
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.ops import build
from nfmc_torch.potentials import DiagonalGaussian
from nfmc_tpu.core.driver import ChunkedScanDriver as JChunkedScanDriver
from nfmc_tpu.core.driver import StepInfo as JStepInfo
from nfmc_tpu.core.samples import MCMCSamples as JMCMCSamples
from nfmc_tpu.core.statistics import MCMCStatistics as JMCMCStatistics

D, C, N = 2, 4, 300


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- (a) the JAX driver and the port's -----------------------------------------------------

def _jax_run(accepts, thinning, max_samples):
    def make_step(tuning):
        def step(x, kstate, key):
            x2 = x + 1.0  # row i is x0 + (i + 1)
            n_acc = (jnp.mod(x2[:, 0] + jnp.arange(C), 3.0) == 0).sum() if accepts else 0
            return x2, kstate, JStepInfo(n_accepted=jnp.asarray(n_acc, jnp.int32),
                                         diverged=jnp.zeros((), jnp.int32))
        return step

    samples = JMCMCSamples((D,), thinning=thinning, max_samples=max_samples)
    stats = JMCMCStatistics((D,))
    JChunkedScanDriver((D,), make_step).run(jnp.zeros((C, D)), None, jax.random.key(0), N,
                                            stats=stats, samples=samples, calls_per_iter=C)
    return samples, stats


def _port_run(accepts, thinning, max_samples, capturable=False, ctx=None):
    def make_step(tuning):
        def step(x, kstate, draws):
            x2 = x + 1.0
            n_acc = ((torch.fmod(x2[:, 0] + torch.arange(C), 3.0) == 0).sum() if accepts
                     else torch.zeros((), dtype=torch.int64))
            return x2, kstate, StepInfo(n_accepted=n_acc.to(torch.int32),
                                        diverged=torch.zeros((), dtype=torch.int32))
        return step

    samples = MCMCSamples((D,), thinning=thinning, max_samples=max_samples)
    stats = MCMCStatistics((D,))
    driver = ChunkedScanDriver((D,), make_step, lambda g, prefix, n: (), capturable=capturable)
    with ctx or graphs.disable_graphs():
        driver.run(torch.zeros((C, D)), None, torch.Generator().manual_seed(0), N, stats=stats,
                   samples=samples, calls_per_iter=C)
    return samples, stats


def _rows(samples):
    return np.stack([np.asarray(samples[i]) for i in range(samples.n_samples)])


@pytest.mark.parametrize("accepts", [False, True], ids=["x+1", "accepts"])
@pytest.mark.parametrize("thinning,max_samples", [(3, None), (1, 100), (7, 50)])
@pytest.mark.parametrize("mode", ["eager", "protocol"])
def test_driver_matches_jax(accepts, thinning, max_samples, mode):
    """The same stored rows, last sample, counters and moments as the JAX
    package's driver, eager and through the graph protocol."""
    js, jst = _jax_run(accepts, thinning, max_samples)
    ps, pst = _port_run(accepts, thinning, max_samples, capturable=mode == "protocol",
                        ctx=graphs.without_capture() if mode == "protocol" else None)
    assert ps.n_samples == js.n_samples
    np.testing.assert_array_equal(_rows(ps), _rows(js))
    np.testing.assert_array_equal(np.asarray(ps.last_sample), np.asarray(js.last_sample))
    for k in ("n_accepted_trajectories", "n_attempted_trajectories", "n_divergences",
              "n_target_calls", "n_target_gradient_calls"):
        assert getattr(pst, k) == getattr(jst, k), k
    if accepts:
        assert pst.n_accepted_trajectories > 0
    np.testing.assert_allclose(pst.running_first_moment, np.asarray(jst.running_first_moment),
                               rtol=1e-6)
    np.testing.assert_allclose(pst.running_second_moment,
                               np.asarray(jst.running_second_moment), rtol=1e-6)


# ---- (b) each captured path: the protocol against the eager loop ---------------------------

TARGET = DiagonalGaussian(np.linspace(-0.5, 0.5, 4).astype(np.float32),
                          np.linspace(0.5, 2.0, 4).astype(np.float32))
PATHS = {
    "jump_mala": dict(inner_param_kwargs={"n_iterations": 2}),
    "mala": dict(warmup=True, n_warmup_iterations=12),
    "hmc": dict(warmup=True, n_warmup_iterations=12, kernel_kwargs={"n_leapfrog_steps": 4}),
    "mh": dict(warmup=True, n_warmup_iterations=12),
    "imh": {},
    "tess": dict(negative_log_likelihood=TARGET),
    "neutra_hmc": dict(inner_kernel_kwargs={"n_leapfrog_steps": 4}),
}


def _sample(strategy, time_limit, ctx):
    kw = dict(PATHS[strategy])
    if time_limit:
        kw["sampling_time_limit_seconds"] = 1e9  # synced chunks 1, 4, 16, ..., never stopped
    with ctx:
        return nfmc_torch.sample(TARGET, strategy=strategy,
                                 flow=Flow(RealNVP((4,), n_layers=2, hidden_size=8), seed=0),
                                 n_chains=8, n_iterations=24, seed=0, show_progress=False,
                                 device="cpu", **kw)


@pytest.mark.parametrize("time_limit", [False, True], ids=["pipelined", "time-limited"])
@pytest.mark.parametrize("strategy", list(PATHS))
def test_captured_body_matches_eager_loop(strategy, time_limit, monkeypatch):
    """The body the layer captures, run on the CPU through its static
    buffers and counter, gives the eager loop's draws, counters, moments and
    final kernel state bit for bit."""
    replayed = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (replayed.append(n), run(self, n))[1])
    eager = _sample(strategy, time_limit, graphs.disable_graphs())
    assert replayed == []
    graphed = _sample(strategy, time_limit, graphs.without_capture())
    assert sum(replayed) >= 24 and (not time_limit or len(replayed) >= 3)
    assert torch.equal(eager.samples, graphed.samples)
    np.testing.assert_array_equal(eager.mean, graphed.mean)
    np.testing.assert_array_equal(eager.variance, graphed.variance)
    np.testing.assert_array_equal(eager.running_samples.last_sample,
                                  graphed.running_samples.last_sample)
    se, sg = eager.statistics, graphed.statistics
    assert {k: v for k, v in vars(se).items() if isinstance(v, int)} == {
        k: v for k, v in vars(sg).items() if isinstance(v, int)}
    for k in ("step_size", "inv_mass_diag"):
        if hasattr(eager.kernel, k):
            np.testing.assert_array_equal(np.asarray(getattr(eager.kernel, k)),
                                          np.asarray(getattr(graphed.kernel, k)))


def test_driver_memoised_across_calls():
    """A sampler keeps its driver, and with it its graphs, across calls with
    the same configuration; a change of configuration builds another."""
    s = nfmc_torch.create_sampler(TARGET, strategy="mala", device="cpu")
    x0 = torch.zeros((8, 4))
    with graphs.without_capture():
        s.sample(x0, show_progress=False, seed=0)
        driver = s._driver_cache_val
        graphs_before = dict(driver._graphs)
        s.sample(x0, show_progress=False, seed=1)
        assert s._driver_cache_val is driver and driver._graphs == graphs_before
        s.params.adjustment = False
        s.sample(x0, show_progress=False, seed=1)
        assert s._driver_cache_val is not driver


def test_undeclared_and_refitting_paths_stay_eager(monkeypatch):
    """A subclass of NUTS that does not declare itself (a user's) and a flow
    without a declaration run the eager loop even under
    ``without_capture``, a jump chunk with refits of such a flow too:
    chosen by declaration. A jump chunk with refits of a declared flow is
    replays of one captured outer iteration, its refits inline in the
    body (no fit graph of their own), the gated refit a scope."""
    runs = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append((self, n)), run(self, n))[1])
    gates = []
    when = graphs.when
    monkeypatch.setattr(graphs, "when", lambda pred, body: (gates.append(pred), when(pred, body)))
    user_nuts = type("UserNUTS", (nfmc_torch.NUTS,), {})
    refits = {"fit_nf": True, "n_jumps_before_training": 1, "flow_fit_kwargs": {"n_epochs": 1}}
    with graphs.without_capture():
        s = user_nuts((4,), TARGET, device="cpu")
        s.params.n_iterations = 3
        s.sample(torch.zeros(4, 4), show_progress=False, seed=0)
        for params in ({}, refits):
            nfmc_torch.sample(TARGET, strategy="jump_mala", flow="nice", n_chains=4,
                              n_iterations=3, inner_param_kwargs={"n_iterations": 2}, seed=0,
                              param_kwargs=params, show_progress=False, device="cpu")
        assert runs == []
        gates.clear()  # NUTS's doublings are scopes in its eager loop too
        nfmc_torch.sample(TARGET, strategy="jump_mala",
                          flow=Flow(RealNVP((4,), n_layers=2, hidden_size=8), seed=0),
                          n_chains=4, n_iterations=3, inner_param_kwargs={"n_iterations": 2},
                          param_kwargs=refits, seed=0, show_progress=False, device="cpu")
    assert [n for _, n in runs] == [3]
    assert all(g.body.__module__ != "nfmc_torch.flows.train" for g, _ in runs)
    # one gate an outer iteration, a row of the graph's input
    assert len(gates) == 3 and all(isinstance(p, torch.Tensor) and p.dim() == 0 for p in gates)
    assert not graphs.declared(user_nuts((4,), TARGET, device="cpu"))
    assert graphs.declared(nfmc_torch.NUTS((4,), TARGET, device="cpu"))


# ---- (c) stand-in counters and graphs -------------------------------------------------------

class _Wrapper:
    launches = 0


class _StandInGraph:
    """A capture that runs its function once with the launches recorded,
    and replays that run it again with them swallowed, as a device replay
    runs no Python."""

    pool_bytes = 0

    def __init__(self, device):
        self.fn, self.captures = None, 0

    def side_stream(self):
        import contextlib

        return contextlib.nullcontext()

    def capture(self, fn):
        self.fn = fn
        self.captures += 1
        fn()

    def replay(self):
        with build.recording():
            self.fn()


def test_replays_count_the_recorded_launches(monkeypatch):
    wrapper = _Wrapper()
    seen = []
    monkeypatch.setattr(build, "LISTENERS", [lambda w, key, n: seen.append((key, n))])

    def body(state, rows):
        build.count_launch(wrapper, ("stack", "forward", 4, 8, 2, 8))
        build.count_launch(wrapper, ("vjp", "inverse", 4, 8, 2, 8))
        return [state[0] + rows[0]], [state[0]]

    g = graphs.IterationGraph(body, [torch.zeros(3)], [((10, 3), torch.float32)],
                              [((10, 3), torch.float32)], torch.device("cpu"), _StandInGraph)
    g.load([torch.zeros(3)], [torch.ones(7, 3)])
    g.run(7)
    # the first iteration eagerly, the capture (launches recorded, not
    # counted; its run a stand-in's), then 6 replays
    assert g.backend.captures == 1 and g.replays == 6
    assert wrapper.launches == 2 * 7
    assert sum(n for key, n in seen if key[0] == "stack") == 7
    np.testing.assert_array_equal(g.outputs[0][:7, 0].numpy(), [0, 1, 2, 3, 4, 5, 6])
    # the stand-in's capture ran the body once more than a real capture would
    assert int(g.counter) == 8
    g.load([torch.zeros(3)], [torch.ones(4, 3)])
    g.run(4)  # cached: replays only
    assert g.backend.captures == 1 and wrapper.launches == 2 * 11
    with pytest.raises(ValueError, match="exceeds"):
        g.run(11)


class _Owner:
    pass


def _small_graph(nbytes_rows=4):
    return graphs.IterationGraph(lambda s, r: (s, []), [torch.zeros(1)],
                                 [((nbytes_rows, 256), torch.float32)], [], torch.device("cpu"),
                                 _StandInGraph)


def test_cache_keeps_its_bound():
    cache = graphs.GraphCache(max_graphs=2, max_bytes=1 << 30)
    owners = [_Owner() for _ in range(3)]
    for i, o in enumerate(owners):
        cache.get(o, ("k", i), _small_graph)
    assert len(cache) == 2 and "k" not in str(owners[0]._graphs)
    assert list(owners[2]._graphs) == [("k", 2)]
    # a cached entry is found, and becomes the most recent
    g1 = owners[1]._graphs[("k", 1)]
    assert cache.get(owners[1], ("k", 1), _small_graph) is g1
    cache.get(owners[0], ("k", 3), _small_graph)
    assert ("k", 1) in owners[1]._graphs and owners[2]._graphs == {}
    # the byte bound: each graph's static buffers are ~4 KiB
    small = graphs.GraphCache(max_graphs=10, max_bytes=3 * 4096 + 100)
    o = _Owner()
    for i in range(5):
        small.get(o, i, _small_graph)
    assert len(small) == 3 and small.nbytes() <= small.max_bytes
    assert "3 graphs" in small.describe()
    # a driver that dies takes its graphs out of the cache
    del o
    gc.collect()
    assert len(small) == 0 and small.nbytes() == 0


class _CollectingKey:
    """A key whose hash collects garbage, as a hash that allocates may."""

    def __hash__(self):
        gc.collect()
        return 7

    def __eq__(self, other):
        return isinstance(other, _CollectingKey)


def test_cache_survives_an_owner_collected_while_it_is_iterated():
    cache = graphs.GraphCache(max_graphs=10, max_bytes=1 << 30)
    keep, gone, last = _Owner(), _Owner(), _Owner()
    gone.cycle = gone  # freed only by the collector, inside the key's hash
    for owner, key in ((keep, _CollectingKey()), (gone, "k"), (last, "k")):
        cache.get(owner, key, _small_graph)
    del gone
    assert cache.nbytes() == 2 * last._graphs["k"].nbytes
    assert len(cache) == 2
    cache.get(_Owner(), "k", _small_graph)
    assert len(cache) == 2  # that owner is already gone


def test_declared_step_with_a_host_count_raises():
    def make_step(tuning):
        def step(x, kstate, draws):
            return x + 1.0, kstate, StepInfo(n_accepted=torch.zeros((), dtype=torch.int32),
                                             diverged=torch.zeros((), dtype=torch.int32),
                                             n_calls=5)
        return step

    def run(ctx):
        stats = MCMCStatistics((D,))
        with ctx:
            ChunkedScanDriver((D,), make_step, lambda g, p, n: (), capturable=True).run(
                torch.zeros((C, D)), None, torch.Generator().manual_seed(0), 5, stats=stats,
                samples=MCMCSamples((D,)), calls_per_iter=C)
        return stats

    assert run(graphs.disable_graphs()).n_target_calls == 5 * C + 25
    with pytest.raises(RuntimeError, match="on the host"):
        run(graphs.without_capture())


def test_state_tree_round_trip():
    from nfmc_torch.core.driver import StatsAccum

    acc = StatsAccum.zeros((3,), "cpu")
    tree = (torch.ones(2), [{"w": [torch.zeros(1)], "b": [torch.ones(1)]}], acc,
            StepInfo(torch.zeros(()), torch.ones(())))
    leaves, spec = graphs.flatten(tree)
    back = graphs.unflatten(spec, leaves)
    leaves2, spec2 = graphs.flatten(back)
    assert spec2 == spec and all(a is b for a, b in zip(leaves, leaves2))
    assert isinstance(back[2], StatsAccum) and isinstance(back[3], StepInfo)

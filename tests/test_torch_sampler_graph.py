"""The samplers whose chunks became graph replays with the dense metric's
refresh as a pause: PT (MALA, MH, HMC), AIES, ESS, DenseHMC, DenseMALA,
JumpESS and JumpAIES, on the CPU through the capture layer's protocol
(``graphs.without_capture``), at d=4 with 8 chains:

* each path, warmup and sampling, pipelined and under a time limit that
  never stops it, gives the eager loop's run (``graphs.disable_graphs``)
  bit for bit: draws, counters, moments and the final kernel state;
* no body reads a tensor on the host: ``bool``, ``item``, ``int``,
  ``float``, ``index``, ``tolist`` and ``cpu`` raise while a body runs, for
  these paths and for ``tests/test_torch_chunk_graph.py``'s;
* PT's ladder through the protocol against the JAX package's steps with
  the same draws, across both parities and the counter-dependent kappa;
* the dense refreshes fall at the same iterations both ways, and a
  sampling run in scalar mode builds a graph of its own;
* PT and AIES on two gloo ranks run the eager loop;
* on the card (marker ``cuda``, skipped here): PT-MALA and DenseHMC
  captured for real, and whether ``torch.linalg.eigh`` captures. Run it
  there with ``python -m pytest --noconftest -m cuda
  tests/test_torch_sampler_graph.py``.
"""
import contextlib
import dataclasses
import multiprocessing
import os
import pickle

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.core import graphs
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.potentials import DiagonalGaussian
from tests import parallel_ranks as pr

D, C, WARM, ITERS = 4, 8, 12, 24
TARGET = DiagonalGaussian(np.linspace(-0.5, 0.5, D).astype(np.float32),
                          np.linspace(0.5, 2.0, D).astype(np.float32))
PATHS = {
    "pt_mala": dict(kernel_kwargs={"n_temps": 4}),
    "pt_mh": dict(kernel_kwargs={"n_temps": 4}),
    "pt_hmc": dict(kernel_kwargs={"n_temps": 4, "n_leapfrog_steps": 3}),
    "aies": {},
    "ess": dict(negative_log_likelihood=TARGET),
    "dense_hmc": dict(kernel_kwargs={"n_leapfrog_steps": 3},
                      param_kwargs={"metric_refresh_every": 4}),
    "dense_mala": dict(param_kwargs={"metric_refresh_every": 4}),
    "jump_ess": dict(negative_log_likelihood=TARGET, inner_param_kwargs={"n_iterations": 2}),
    "jump_aies": dict(inner_param_kwargs={"n_iterations": 2}),
}
HOST_READS = ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every host read of a tensor raises while a graph's body runs, but
    for the one a scope makes of its predicate without capture
    (``graphs._decide``, which a capture leaves to the device)."""
    import sys

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if graphs.in_body() and sys._getframe(1).f_code is not graphs._decide.__code__:
                raise AssertionError(f"Tensor.{name} inside a captured body")
            return orig(self, *a, **k)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, guard(name))


@pytest.fixture
def graph_runs(monkeypatch):
    """The iterations each ``IterationGraph.run`` was asked for."""
    runs = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append(n), run(self, n))[1])
    return runs


def _x0(n=C, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32))


def _make(strategy):
    kw = dict(PATHS[strategy])
    params = {"n_iterations": ITERS, "n_warmup_iterations": WARM, **kw.pop("param_kwargs", {})}
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=0) if "jump" in strategy else None
    return nfmc_torch.create_sampler(TARGET, event_shape=(D,), flow=flow, strategy=strategy,
                                     param_kwargs=params, device="cpu", **kw)


def _kernel_state(kernel) -> dict:
    """Every number the kernel holds on the host after a run, the resumed
    adaptation (``_resume_*``) included."""
    out = {}
    for k, v in vars(kernel).items():
        if k in ("flow", "da_params") or k.endswith("_src"):
            continue
        if isinstance(v, tuple):
            v = torch.cat([t.reshape(-1) for t in v]) if all(
                isinstance(t, torch.Tensor) for t in v) else v
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        elif dataclasses.is_dataclass(v):
            v = np.concatenate([np.asarray(getattr(v, f.name)).reshape(-1)
                                for f in dataclasses.fields(v)])
        out[k] = np.asarray(v) if isinstance(v, (np.ndarray, list)) else v
    return out


def _run(strategy, ctx, time_limit=None):
    s = _make(strategy)
    x0 = _x0()
    with ctx:
        if "jump" not in strategy:
            s.warmup(x0, show_progress=False, seed=1, time_limit_seconds=time_limit)
        out = s.sample(x0, show_progress=False, seed=2, time_limit_seconds=time_limit)
    inner = getattr(s, "inner_sampler", s)
    return s, out, _kernel_state(inner.kernel)


def _assert_same(a, b):
    (_, ea, ka), (_, eb, kb) = a, b
    assert torch.equal(ea.samples, eb.samples)
    np.testing.assert_array_equal(ea.mean, eb.mean)
    np.testing.assert_array_equal(ea.variance, eb.variance)
    np.testing.assert_array_equal(ea.running_samples.last_sample, eb.running_samples.last_sample)
    assert {k: v for k, v in vars(ea.statistics).items() if isinstance(v, int)} == {
        k: v for k, v in vars(eb.statistics).items() if isinstance(v, int)}
    assert ka.keys() == kb.keys()
    for k in ka:
        np.testing.assert_array_equal(np.asarray(ka[k]), np.asarray(kb[k]), err_msg=k)


@pytest.mark.parametrize("time_limit", [None, 1e9], ids=["pipelined", "time-limited"])
@pytest.mark.parametrize("strategy", list(PATHS))
def test_protocol_matches_eager_loop(strategy, time_limit, graph_runs, no_host_reads):
    """The body the layer captures, through its static buffers and counter
    (chunks 1, 4, 16, ... under the time limit), gives the eager loop's
    run bit for bit, and reads nothing on the host."""
    eager = _run(strategy, graphs.disable_graphs(), time_limit)
    assert graph_runs == []
    graphed = _run(strategy, graphs.without_capture(), time_limit)
    # the warmup's and the run's iterations (a jump run's outer ones)
    n = ITERS + (0 if "jump" in strategy else WARM)
    assert sum(graph_runs) == n and (time_limit is None or len(graph_runs) >= 6)
    _assert_same(eager, graphed)
    state = graphed[2]
    if strategy.startswith("pt"):
        assert state["n_attempted_swaps"] > 0 and state["_resume_i"] == WARM + ITERS
    if strategy.startswith("dense"):
        assert state["_resume_t"] == WARM and "_resume_factors" in state


@pytest.mark.parametrize("strategy", ["jump_mala", "mala", "hmc", "mh", "imh", "tess",
                                      "neutra_hmc"])
def test_declared_paths_read_nothing_on_the_host(strategy, graph_runs, no_host_reads):
    """``tests/test_torch_chunk_graph.py``'s paths under the same guard."""
    from tests.test_torch_chunk_graph import PATHS as CHUNK_PATHS
    from tests.test_torch_chunk_graph import _sample

    assert strategy in CHUNK_PATHS
    _sample(strategy, False, graphs.without_capture())
    assert sum(graph_runs) >= 24


@pytest.mark.parametrize("move", ["mala", "rwmh", "hmc"])
def test_pt_protocol_matches_jax_steps(move, graph_runs):
    """Six tuning iterations of PT through the driver's protocol, the
    counter starting at 5 (both parities, kappa moving with it), against
    the JAX package's step with the same draws: the cold and hot rungs,
    the ladder, the rung steps and the swap counts."""
    import jax
    import jax.numpy as jnp
    from tests.test_torch_pt import HMC_TOL, TOL, _draws, _pair, assert_pt_close

    from nfmc_torch.core.driver import ChunkedScanDriver
    from nfmc_torch.core.samples import MCMCSamples
    from nfmc_torch.core.statistics import MCMCStatistics

    js, ts = _pair(move, imd_adjustment=0.2)
    n_temps, n_chains, d = ts.kernel.n_temps, 6, ts.event_size
    js.kernel._resume_i = ts.kernel._resume_i = 5
    rng = np.random.default_rng(3)
    x0 = (rng.standard_normal((n_chains, d)) - 1.5).astype(np.float32)
    draws = _draws(rng, 6)
    assert draws[0][0].shape == (n_temps, n_chains, d)

    jstep = jax.jit(js._make_step_aux(True))
    jx = jnp.asarray(x0)
    jstate = js._augment_state(js.kernel.make_state(), jx)
    for dr in draws:
        jx, jstate, _ = jstep(jx, jstate, None, tuple(jnp.asarray(a) for a in dr))

    stacked = tuple(torch.from_numpy(np.stack(col)) for col in zip(*draws))
    driver = ChunkedScanDriver((d,), ts._make_chunk_step, lambda g, prefix, n: stacked,
                               capturable=True)
    tx = torch.from_numpy(x0)
    with graphs.without_capture():
        x, state = driver.run(tx, ts._augment_state(ts.kernel.make_state("cpu"), tx),
                              torch.Generator(), 6, stats=MCMCStatistics((d,)),
                              samples=MCMCSamples((d,)), tuning=True)
    assert graph_runs == [6]
    tol = HMC_TOL if move == "hmc" else TOL
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=tol, atol=tol)
    np.testing.assert_allclose(state[1].numpy(), np.asarray(jstate[1]), rtol=tol, atol=tol)
    assert_pt_close(state[0], jstate[0], tol)
    assert int(state[0].i) == 11 and int(state[0].swap_attempts.sum()) > 0


@pytest.mark.parametrize("strategy", ["dense_hmc", "dense_mala"])
def test_dense_refreshes_and_scalar_mode_graph(strategy, monkeypatch):
    """The refresh runs after tuning iterations 4, 8 and 12 in the eager
    loop and in the protocol's replays alike; the warmup's graph is of the
    iteration without it. A sampling run after a warmup that ended in
    scalar mode is built with the scalar math and gets a graph of its own,
    equal to the eager loop's."""
    from nfmc_torch.samplers.mcmc import dense

    seen = []
    make_refresh = dense._DenseMetricMixin._make_refresh

    def recording(self):
        refresh = make_refresh(self)
        return lambda m: (seen.append((graphs.in_body(), int(m.t))), refresh(m))[1]

    monkeypatch.setattr(dense._DenseMetricMixin, "_make_refresh", recording)
    for ctx in (graphs.disable_graphs(), graphs.without_capture()):
        s = _make(strategy)
        with ctx:
            s.warmup(_x0(), show_progress=False, seed=1)
        assert seen == [(False, 4), (False, 8), (False, 12)]
        seen.clear()

    def sample(ctx):
        kernel = s.kernel
        kernel._resume_scalar_mode, kernel._resume_mu = True, 1.7
        with ctx:
            return s.sample(_x0(), show_progress=False, seed=2)

    def modes():
        return sorted(key[1] for key in s._driver_cache_val._graphs)

    assert modes() == [(False,)]
    eager = sample(graphs.disable_graphs())
    graphed = sample(graphs.without_capture())
    assert modes() == [(False,), (True,)] and s._build_scalar
    assert torch.equal(eager.samples, graphed.samples)


def test_several_ranks_run_pt_and_aies_eagerly(tmp_path):
    """PT's and AIES's steps call a collective every iteration: on two gloo
    ranks they never enter a graph's run, under ``without_capture`` too,
    while the same runs on one rank replay."""
    names = ["pt_mala_declined", "aies_declined"]
    for name in names:
        assert getattr(pr, name)(None, str(tmp_path))["graph_iterations"] == pr.DECLINED_ITERS
    ctx = multiprocessing.get_context("spawn")
    scenarios = {name: getattr(pr, name) for name in names}
    procs = [ctx.Process(target=pr.run_rank, args=(r, 2, str(tmp_path), names, scenarios))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        for name in names:
            assert "error" not in res[name], res[name].get("error")
            assert res[name]["graph_iterations"] == 0, (r, name)


@pytest.mark.cuda
def test_pt_and_dense_capture_on_the_card():
    """PT-MALA and DenseHMC (warmup with refreshes, then sampling) captured
    on the card, bit for bit against the eager loop; and whether
    ``torch.linalg.eigh`` can be captured (the refresh runs eagerly
    between replays either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these graphs are captured on the card")
    dev = torch.device("cuda")

    def run(strategy, ctx, **kw):
        with ctx:
            out = nfmc_torch.sample(TARGET, strategy=strategy, n_chains=C, n_iterations=ITERS,
                                    n_warmup_iterations=WARM, warmup=True, seed=0,
                                    show_progress=False, device=dev, **kw)
        torch.cuda.synchronize()
        return out

    runs = []
    orig = graphs.IterationGraph.run
    graphs.IterationGraph.run = lambda self, n: (runs.append(self), orig(self, n))[1]
    try:
        for strategy in ("pt_mala", "dense_hmc"):
            kw = {k: v for k, v in PATHS[strategy].items()}
            eager = run(strategy, graphs.disable_graphs(), **kw)
            assert runs == []
            graphed = run(strategy, contextlib.nullcontext(), **kw)
            assert runs and all(isinstance(g.backend, graphs._CudaGraph) and g.captured
                                for g in runs)
            assert torch.equal(eager.samples, graphed.samples)
            np.testing.assert_array_equal(eager.mean, graphed.mean)
            runs.clear()
    finally:
        graphs.IterationGraph.run = orig

    a = torch.randn(D, D, device=dev)
    cov = a @ a.T + torch.eye(D, device=dev)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    torch.linalg.eigh(cov)  # cuSOLVER's handle and workspace, outside the capture
    captured = True
    with torch.cuda.stream(stream):
        try:
            with torch.cuda.graph(graph, stream=stream):
                torch.linalg.eigh(cov)
        except RuntimeError as e:
            captured = False
            print(f"torch.linalg.eigh does not capture: {str(e).splitlines()[0]}")
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    print(f"torch.linalg.eigh captured: {captured}")
    assert not captured

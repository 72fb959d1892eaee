"""The refitting chunks as graph replays: DLMC's iteration, TESS's fused
warmup, AdaptiveIMH's fused chunk and a jump run's fixed-effort ``fit_nf``,
each with its ``make_scan_fit`` refit inside one captured iteration (the
JAX package's ``lax.scan`` with the fit in its body). On the CPU through
the capture layer's protocol (``graphs.without_capture``), at d=4 with 8
chains, RealNVP L=2 H=8 and a ``c-rqnsf`` case (K=4), the kernels faked so
that their launches count as on the card:

* each path, pipelined and under a time limit that never stops it, gives
  the eager loop's run (``graphs.disable_graphs``) bit for bit: draws,
  counters, moments, the final weights, each wrapper's launch count and the
  fit steps and epochs done (so no refit is computed only to be
  discarded); the jump run's chunk straddles ``n_jumps_before_training``
  and AdaptiveIMH's schedule has refitting and other iterations;
* no body reads a tensor on the host but a scope's predicate;
* the gated refit is an IF node holding the epochs' WHILE node, each with
  a tally, under a stand-in capture; AdaptiveIMH's history is no buffer of
  its graph;
* refits gather the chains, so several ranks decline the capture;
* against the JAX package, with the fit's randomness off (no shuffle, no
  split) or rebuilt from its key: two DLMC iterations and two refitting
  jump_mala iterations through the protocol, and an AdaptiveIMH chunk with
  injected schedule: weights to 1e-4, a step's state to 1e-5;
* a graph's eager first iteration refits through the fit's own epoch
  graph, its replays inline;
* on the card (marker ``cuda``, skipped here): the four paths captured for
  real, bit for bit against the eager loop, after it and, in a fresh
  process, before it. Run it there with ``python -m pytest --noconftest
  -m cuda tests/test_torch_refit_graph.py``.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nfmc_torch
import nfmc_torch.flows.train as ttrain
from nfmc_torch.core import graphs
from nfmc_torch.core.driver import ChunkedScanDriver
from nfmc_torch.core.samples import MCMCSamples
from nfmc_torch.core.statistics import MCMCStatistics
from nfmc_torch.flows import CouplingRQNSF, Flow, RealNVP, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as ops
from nfmc_torch.ops import spline as sops
from nfmc_torch.potentials import DiagonalGaussian
from nfmc_torch.samplers.nfmc import AdaptiveIMH, IMHKernel, IMHParameters
from nfmc_torch.utils import tree_leaves
from tests.test_torch_sampler_graph import graph_runs, no_host_reads  # noqa: F401 (fixtures)

D, C, L, H, K = 4, 8, 2, 8, 4
ITERS, IMH_ITERS, JUMP_OUTER, JUMP_FROM, INNER = 6, 24, 8, 3, 2
TARGET = DiagonalGaussian(np.linspace(-0.5, 0.5, D).astype(np.float32),
                          np.linspace(0.5, 2.0, D).astype(np.float32))
# the fits' epochs, a WHILE node under a capture
EPOCHS = {"dlmc": 3, "tess": 2, "adaptive_imh": 1, "jump_mala": 3}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fake_kernels(monkeypatch):
    """The kernel wrappers take the CPU for the card: each launch is
    counted as on CUDA and computed by the plain version."""
    def key(kind, inverse, x, params):
        return (kind, "inverse" if inverse else "forward", x.shape[1],
                int(params[0]["w"][1].shape[0]), len(params), x.shape[0])

    def launch(wrapper, params, x, clamp, inverse, packed):
        build.count_launch(wrapper, key("stack", inverse, x, params))
        return ops.realnvp_stack_plain(params, x, clamp, inverse)

    def launch_vjp(params, x, gy, gld, clamp, inverse, packed):
        build.count_launch(ops.fused_realnvp_vjp, key("vjp", inverse, x, params))
        return ops.realnvp_stack_vjp_plain(params, x, gy, gld, clamp, inverse)

    def spline_launch(wrapper, params, x, kind, n_bins, tail_bound, inverse, packed):
        build.count_launch(wrapper, key(kind, inverse, x, params))
        return sops.spline_stack_plain(params, x, kind, n_bins, tail_bound, inverse)

    def spline_vjp(params, x, gy, gld, kind, n_bins, tail_bound, inverse, packed):
        build.count_launch(sops.fused_spline_vjp, key(f"{kind} vjp", inverse, x, params))
        return sops.spline_stack_vjp_plain(params, x, gy, gld, kind, n_bins, tail_bound, inverse)

    for mod in (ops, sops):
        monkeypatch.setattr(mod, "_on_device", lambda x: True)
    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_vjp", launch_vjp)
    monkeypatch.setattr(sops, "_launch", spline_launch)
    monkeypatch.setattr(sops, "_launch_vjp", spline_vjp)


def _flow(name="realnvp"):
    bij = (RealNVP((D,), n_layers=L, hidden_size=H) if name == "realnvp"
           else CouplingRQNSF((D,), n_layers=L, hidden_size=H, n_bins=K))
    return Flow(bij, seed=0)


def _sampler(path, flow, device="cpu"):
    fit = {"flow_fit_kwargs": {"n_epochs": EPOCHS[path]}}
    if path == "adaptive_imh":
        return AdaptiveIMH((D,), TARGET, IMHKernel((D,), flow=flow),
                           IMHParameters(n_iterations=IMH_ITERS, adaptation_dropoff=0.8),
                           device=device)
    if path == "jump_mala":
        return nfmc_torch.create_sampler(
            TARGET, event_shape=(D,), flow=flow, strategy=path, device=device,
            param_kwargs={"n_iterations": JUMP_OUTER, "fit_nf": True,
                          "n_jumps_before_training": JUMP_FROM, **fit},
            inner_param_kwargs={"n_iterations": INNER})
    return nfmc_torch.create_sampler(
        TARGET, event_shape=(D,), flow=flow, strategy=path, negative_log_likelihood=TARGET,
        device=device, param_kwargs={"n_iterations": ITERS, "n_warmup_iterations": ITERS, **fit})


def _x0():
    return torch.from_numpy(np.random.default_rng(0).standard_normal((C, D)).astype(np.float32))


def _run(path, name, ctx, time_limit=None):
    """A run of ``path`` in ``ctx`` (TESS's fused warmup, the others'
    sampling): its output, final weights, launches by wrapper and the fit
    steps and epochs it counted."""
    s = _sampler(path, _flow(name))
    build.reset_launch_counts()
    before = dict(ttrain.COUNTS)
    with ctx:
        call = s.warmup if path == "tess" else s.sample
        out = call(_x0(), show_progress=False, seed=2, time_limit_seconds=time_limit)
    weights = [t.detach().clone() for t in tree_leaves(s.kernel.flow.params)]
    return (out, weights, {w.__name__: w.launches for w in build.WRAPPERS},
            {k: ttrain.COUNTS[k] - before[k] for k in before})


CASES = [("dlmc", "realnvp", None), ("dlmc", "realnvp", 1e9), ("dlmc", "c-rqnsf", None),
         ("tess", "realnvp", None), ("tess", "realnvp", 1e9),
         ("adaptive_imh", "realnvp", None), ("adaptive_imh", "realnvp", 1e9),
         ("jump_mala", "realnvp", None), ("jump_mala", "realnvp", 1e9),
         ("jump_mala", "c-rqnsf", None)]


@pytest.fixture
def runs_by_body(monkeypatch):
    """``(graph, n)`` for each ``IterationGraph.run``: its graph and the
    iterations it was asked for."""
    runs = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append((self, n)), run(self, n))[1])
    return runs


def _outer(runs):
    """The iterations asked of each graph but the fits' own (which a
    graph's eager first iteration replays)."""
    return [k for g, k in runs if g.body.__name__ != "epoch"]


@pytest.mark.parametrize("path,name,time_limit", CASES)
def test_protocol_matches_eager_loop(path, name, time_limit, fake_kernels, runs_by_body,
                                     no_host_reads, monkeypatch):  # noqa: F811
    """The captured body through its static buffers and counter (chunks 1,
    4, 16, ... under the time limit) gives the eager loop's run bit for
    bit, reads nothing on the host but its scopes' predicates, and fits
    exactly where the eager loop fits. A graph's eager first iteration
    refits through the fit's own graph of its epochs; the replays run them
    inline."""
    gates = []
    when = graphs.when
    monkeypatch.setattr(graphs, "when", lambda pred, body: (gates.append(pred), when(pred, body)))
    eager = _run(path, name, graphs.disable_graphs(), time_limit)
    assert runs_by_body == [] and gates == []
    graphed = _run(path, name, graphs.without_capture(), time_limit)
    n = {"adaptive_imh": IMH_ITERS, "jump_mala": JUMP_OUTER}.get(path, ITERS)
    fits = [k for g, k in runs_by_body if g.body.__name__ == "epoch"]
    outer = _outer(runs_by_body)
    assert sum(outer) == n and (time_limit is None or len(outer) >= 3)
    # one outer graph, whose eager first iteration refits where its gate
    # holds there: the jump run's does not (its refits start later)
    assert len({g for g, _k in runs_by_body if g.body.__name__ != "epoch"}) == 1
    assert fits == ([] if path == "jump_mala" else [EPOCHS[path]])
    (ea, wa, la, ca), (eb, wb, lb, cb) = eager, graphed
    assert torch.equal(ea.samples, eb.samples)
    np.testing.assert_array_equal(ea.mean, eb.mean)
    np.testing.assert_array_equal(ea.variance, eb.variance)
    assert torch.equal(ea.running_samples.last_sample, eb.running_samples.last_sample)
    assert {k: v for k, v in vars(ea.statistics).items() if isinstance(v, int)} == {
        k: v for k, v in vars(eb.statistics).items() if isinstance(v, int)}
    assert all(torch.equal(a, b) for a, b in zip(wa, wb))
    assert not torch.equal(wb[2], tree_leaves(_flow(name).params)[2])  # the weights moved
    assert la == lb and ca == cb
    kind = "fused_realnvp_vjp" if name == "realnvp" else "fused_spline_vjp"
    # every Adam step one VJP launch, and DLMC's drift one an iteration
    assert lb[kind] == cb["steps"] + (n if path == "dlmc" else 0) and cb["steps"] > 0
    refits = cb["epochs"] // EPOCHS[path]
    if path in ("dlmc", "tess"):
        assert refits == n and gates == []  # a refit every iteration: no gate
    else:
        # one gate row an iteration, a refit where it holds: the jump run
        # from its outer iteration JUMP_FROM, AdaptiveIMH on a schedule that
        # also skips
        assert len(gates) == n and all(p.dim() == 0 for p in gates)
        if path == "jump_mala":
            assert refits == JUMP_OUTER - JUMP_FROM
        else:
            assert 0 < refits < IMH_ITERS


def test_refit_is_an_if_node_holding_a_while_node(fake_kernels, monkeypatch):
    """Under a stand-in capture (the conditional nodes' work done by hand,
    as ``tests/test_torch_dynamic_graph.py`` does), a gated refit of 3
    epochs records an IF scope that holds the epochs' WHILE scope, each
    with a tally of its own (the IF's launches: the fitted weights' loss
    check), nested within ``graphs.MAX_SCOPE_DEPTH``."""
    nodes, depth = [], [0]

    @contextlib.contextmanager
    def node(device, pred, loop):
        nodes.append(("while" if loop else "if", depth[0]))
        depth[0] += 1
        try:
            yield graphs._Node()
        finally:
            depth[0] -= 1

    monkeypatch.setattr(graphs, "_capturing", lambda device: True)
    monkeypatch.setattr(graphs, "_node", node)
    monkeypatch.setattr(graphs, "in_body", lambda: True)
    flow = _flow()
    fit = ttrain.make_scan_fit(flow, C, n_epochs=3, train_pct=0.7)
    rows = fit.draws(torch.Generator().manual_seed(0), 1)
    with build.recording() as events:
        graphs.cond(torch.tensor(True), lambda p: fit(p, _x0(), rows=[r[0] for r in rows]),
                    flow.params)
    assert nodes == [("if", 0), ("while", 1)] and graphs.MAX_SCOPE_DEPTH >= 2
    (if_scope,) = events
    (while_scope,) = [e for e in if_scope.events if isinstance(e, build.Scope)]
    assert if_scope.tally is not None and while_scope.tally is not None
    steps = [e for e in while_scope.events if not isinstance(e, build.Scope)
             and e[1] is ttrain.COUNTS]
    assert [e[2] for e in steps] == ["epochs", "steps"]  # 5 train rows: one batch an epoch


def test_adaptive_imh_history_is_no_graph_buffer(graph_runs):  # noqa: F811
    """AdaptiveIMH's history lies in one buffer for the run: its graph
    reads and writes it where it lies and holds no copy of it."""
    made = []
    run = graphs.IterationGraph.run
    s = _sampler("adaptive_imh", _flow())
    n = s.params.n_iterations
    try:
        graphs.IterationGraph.run = lambda self, k: (made.append(self), run(self, k))[1]
        with graphs.without_capture():
            out = s.sample(_x0(), show_progress=False, seed=2)
    finally:
        graphs.IterationGraph.run = run
    (graph,) = {g for g in made if g.body.__name__ != "epoch"}
    # the carried state is the weights, chains and accumulators; the
    # inputs hold the chunk's rows; nothing is emitted
    assert all(t.numel() < n * C * D for t in graph.state) and graph.outputs == []
    assert out.samples.shape == (n, C, D)


def test_several_ranks_decline_the_capture():
    """A refit gathers the chains: on several ranks the refitting chunks run
    the eager loop, on one they replay, under ``without_capture`` too."""
    class Shard:
        def __init__(self, size):
            self.size = size

    def replays(s, flow, shard=None):
        # the rule each refitting path applies: a declared sampler and flow,
        # and a step that gathers the chains
        return graphs.declared(s, (flow,)) and graphs.captures(cpu, shard, collective=True)

    cpu = torch.device("cpu")
    maf = nfmc_torch.create_flow_object('maf%{"n_layers": 2, "hidden_size": 8}', (D,), seed=0)
    for path in ("dlmc", "tess", "adaptive_imh", "jump_mala"):
        s = _sampler(path, _flow())
        with graphs.without_capture():
            assert replays(s, s.kernel.flow) and replays(s, s.kernel.flow, Shard(1))
            assert not replays(s, s.kernel.flow, Shard(2))
            assert not replays(s, maf)
        assert not replays(s, s.kernel.flow)


def test_fit_rows_are_the_eager_calls_draws():
    """``draws`` makes the rows that the gated calls would draw one by one,
    in order, and zeros for the calls it skips."""
    fit = ttrain.make_scan_fit(_flow(), 10, n_epochs=2, train_pct=0.7)
    g = torch.Generator().manual_seed(3)
    calls = [fit.draw(g) for _ in range(2)]
    rows = fit.draws(torch.Generator().manual_seed(3), [False, True, False, True])
    assert [tuple(r.shape) for r in rows] == [(4, 10), (4, 2, 7)]
    assert fit.row_elems == 2 * (10 + 2 * 7)
    for i, r in enumerate(rows):
        assert torch.equal(r[1], calls[0][i]) and torch.equal(r[3], calls[1][i])
        assert not r[0].any() and not r[2].any()


# ---- against the JAX package --------------------------------------------------------------

TOL_STATE, TOL_WEIGHTS = 1e-5, 1e-4


def _flat(params):
    return torch.cat([t.reshape(-1) for t in tree_leaves(params)])


def _jax_weights_close(params, jparams):
    want = _flat(from_jax_params(jparams))
    assert float((_flat(params) - want).abs().max()) <= TOL_WEIGHTS


def test_dlmc_iterations_match_jax(runs_by_body):
    """Two DLMC iterations (a 3-epoch refit, the drift, the accept) through
    the driver's protocol against the JAX package's fused step, the fit's
    randomness off and the accept's draws rebuilt from JAX's key."""
    import jax
    import jax.numpy as jnp
    from tests.test_torch_dlmc import C as DC
    from tests.test_torch_dlmc import D as DD
    from tests.test_torch_dlmc import _pair

    js, ts = _pair()
    js.params.train_pct = ts.params.train_pct = None
    n_epochs, lr = 3, 5e-3
    jstep = jax.jit(js._make_fused_step(DC, (n_epochs, lr, "adaptive", False, False)))
    x0 = (0.4 + 1.3 * np.random.default_rng(2).standard_normal((DC, DD))).astype(np.float32)
    jx, jp = jnp.asarray(x0), js.kernel.flow.params
    want, draws = [], []
    for i in range(2):
        key = jax.random.key(20 + i)
        jx, jp, _ = jstep(jx, jp, key)
        want.append(np.asarray(jx))
        _k_fit, k_acc = jax.random.split(key)
        k_prop, k_u = jax.random.split(k_acc)
        draws.append((np.asarray(js.kernel.flow.sample_base_fn(k_prop, DC)),
                      np.asarray(jnp.log(jax.random.uniform(k_u, (DC,))))))
    fit = ttrain.make_scan_fit(ts.kernel.flow, DC, n_epochs=n_epochs, lr=lr, shuffle=False)
    stacked = tuple(torch.from_numpy(np.stack(col)) for col in zip(*draws))
    driver = ChunkedScanDriver((DD,), ts._make_fused_step(fit), lambda g, prefix, n: stacked,
                               capturable=True)
    samples = MCMCSamples((DD,))
    with graphs.without_capture():
        _x, params = driver.run(torch.from_numpy(x0), ts.kernel.flow.params, torch.Generator(),
                                2, stats=MCMCStatistics((DD,)), samples=samples)
    assert _outer(runs_by_body) == [2]
    ys = samples.as_tensor().numpy()
    for i in range(2):
        np.testing.assert_allclose(ys[i], want[i], rtol=TOL_STATE, atol=TOL_STATE)
    _jax_weights_close(params, jp)


def test_jump_refit_iterations_match_jax(runs_by_body):
    """Two refitting jump_mala outer iterations (2 MALA steps, a 3-epoch
    refit on their draws, the proposal from the new weights, the jump)
    through the captured path's protocol against the JAX package's own
    pieces with the same draws."""
    import jax
    import jax.numpy as jnp
    from nfmc_tpu.core.sampler import NFMCKernel as JNFMCKernel
    from nfmc_tpu.flows import Flow as JFlow
    from nfmc_tpu.flows import RealNVP as JRealNVP
    from nfmc_tpu.flows.train import make_scan_fit as jmake_scan_fit
    from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
    from nfmc_tpu.samplers.mcmc.langevin import LangevinParameters as JLangevinParameters
    from nfmc_tpu.samplers.nfmc import JumpMALA as JJumpMALA
    from tests.test_torch_jump import _jump_mala

    d, c, inner_n, n_outer, n_epochs = 6, 8, 2, 2, 3
    rng = np.random.default_rng(0)
    mu, sigma = np.full(d, 0.3, np.float32), np.float32(1.2)
    jflow = JFlow(JRealNVP((d,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    jtarget = JDiagonalGaussian(mu, sigma)
    js = JJumpMALA((d,), jtarget, kernel=JNFMCKernel((d,), flow=jflow),
                   inner_params=JLangevinParameters(n_iterations=inner_n))
    flow = Flow(RealNVP((d,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    ts = _jump_mala((d,), DiagonalGaussian(mu, sigma), inner_n, flow=flow)

    x0 = rng.standard_normal((c, d)).astype(np.float32)
    noise = rng.standard_normal((n_outer, inner_n, c, d)).astype(np.float32)
    log_u = np.log(rng.random((n_outer, inner_n, c))).astype(np.float32)
    z = rng.standard_normal((n_outer, c, d)).astype(np.float32)
    k_accs = [jax.random.key(100 + i) for i in range(n_outer)]
    jump_log_u = np.stack([np.asarray(jnp.log(jax.random.uniform(k, (c,)))) for k in k_accs])

    inner = js.inner_sampler
    step = inner._make_step_aux(False)
    jump_accept = js._make_jump_accept()
    jfit = jax.jit(jmake_scan_fit(jflow, inner_n * c, n_epochs=n_epochs, shuffle=False))
    params = jflow.params
    x = jnp.asarray(x0)
    ks = inner._augment_state(inner.kernel.make_state(), x)
    emitted = []
    for i in range(n_outer):
        states = []
        for s in range(inner_n):
            x, ks, _ = step(x, ks, None, (jnp.asarray(noise[i, s]), jnp.asarray(log_u[i, s])))
            states.append(x)
        emitted.extend(np.asarray(v) for v in states)
        params = jfit(params, jnp.stack(states).reshape(-1, d), jax.random.key(0))
        x_prime, ld_inv = jflow.bijection.inverse_fn(params, jnp.asarray(z[i]))
        aux = (x_prime, jflow.base_log_prob_fn(jnp.asarray(z[i])) - ld_inv, jtarget(x_prime))
        x, _ = jump_accept(params, x, k_accs[i], aux)
        ks = inner._augment_state(inner._extract_mstate(ks), x)
        emitted.append(np.asarray(x))

    draws = {"inner": (torch.from_numpy(noise), torch.from_numpy(log_u)),
             "z": torch.from_numpy(z), "jump_log_u": torch.from_numpy(jump_log_u)}
    scan_fit = ttrain.make_scan_fit(flow, inner_n * c, n_epochs=n_epochs, shuffle=False)
    with graphs.without_capture():
        state, ys = ts.run_chunk(ts.init_chunk_state(torch.from_numpy(x0)), draws,
                                 refit=(scan_fit, [True] * n_outer, []))
    assert _outer(runs_by_body) == [n_outer]
    np.testing.assert_allclose(ys.numpy(), np.stack(emitted), rtol=TOL_STATE, atol=TOL_STATE)
    _jax_weights_close(state.flow_params, params)


def test_adaptive_imh_chunk_matches_jax(runs_by_body):
    """Three iterations of AdaptiveIMH's fused chunk through its graph's
    protocol against the JAX package's fused runner, the schedule injected
    (refits at iterations 0 and 2, on history rows 0 and 1: the row the
    iteration wrote), the accept's draws and the refits' permutations
    rebuilt from JAX's keys."""
    import jax
    import jax.numpy as jnp
    from nfmc_tpu.core.driver import StatsAccum as JStatsAccum
    from nfmc_tpu.samplers.nfmc import AdaptiveIMH as JAdaptiveIMH
    from nfmc_tpu.samplers.nfmc import IMHKernel as JIMHKernel
    from tests.test_torch_dlmc import _pair

    js_dlmc, ts_dlmc = _pair()  # a perturbed RealNVP pair (d=5) and its target
    jflow, flow = js_dlmc.kernel.flow, ts_dlmc.kernel.flow
    d, c, chunk = flow.event_shape[0], 8, 3
    js = JAdaptiveIMH((d,), js_dlmc.target, kernel=JIMHKernel((d,), flow=jflow))
    ts = AdaptiveIMH((d,), ts_dlmc.target, IMHKernel((d,), flow=flow),
                     IMHParameters(n_iterations=chunk), device="cpu")
    do_fit, k_idx = np.array([True, False, True]), np.array([0, 0, 1], np.int32)
    x0 = (0.4 + 1.3 * np.random.default_rng(4).standard_normal((c, d))).astype(np.float32)
    key = jax.random.key(9)

    jx = jnp.asarray(x0)
    run = js._get_fused_runner(c)
    jparams, jxo, jflp, ju, jhist, _acc, _k = run(
        jflow.params, jx, jflow.log_prob_fn(jflow.params, jx), js.target(jx),
        jnp.zeros((chunk, c, d), jnp.float32), 0, JStatsAccum.zeros((d,)), key,
        jnp.asarray(do_fit), jnp.asarray(k_idx), chunk)

    scan_fit = ttrain.make_scan_fit(flow, c, n_epochs=1)
    z, log_u, perms = [], [], []
    for j, key_i in enumerate(jax.random.split(key, chunk + 1)[1:]):
        k_step, k_fit = jax.random.split(key_i)
        k_prop, k_acc = jax.random.split(k_step)
        z.append(np.asarray(jflow.sample_base_fn(k_prop, c)))
        log_u.append(np.asarray(jnp.log(jax.random.uniform(k_acc, (c,)))))
        _k_split, k_epochs = jax.random.split(k_fit)
        (ek,) = jax.random.split(k_epochs, 1)
        perm = np.asarray(jax.random.permutation(ek, c)) if do_fit[j] else np.zeros(c, np.int64)
        perms.append(perm[None])
    draws = (torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(log_u)))
    rows = [torch.from_numpy(np.stack(perms).astype(np.int64))]
    with graphs.without_capture():
        st = ts.make_fused_state(torch.from_numpy(x0), chunk)
        st = ts.fused_graph_runner(st, scan_fit, chunk)(st, 0, draws, do_fit, k_idx, rows)
    assert _outer(runs_by_body) == [chunk]
    for got, want in ((st["x"], jxo), (st["flp"], jflp), (st["u"], ju), (st["hist"], jhist)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_STATE,
                                   atol=TOL_STATE)
    _jax_weights_close(st["params"], jparams)


# ---- on the card ------------------------------------------------------------------------------

def _card_compare(path, name, graphed_first=False):
    """``path`` with ``name``'s flow on the card, captured for real and
    under ``disable_graphs()`` (in that order where ``graphed_first``), bit
    for bit: draws, moments, counters, weights and launches."""
    dev = torch.device("cuda")
    runs = []
    orig = graphs.IterationGraph.run

    def run(ctx):
        s = _sampler(path, _flow(name), dev)
        build.reset_launch_counts()
        with ctx:
            call = s.warmup if path == "tess" else s.sample
            out = call(_x0().to(dev), show_progress=False, seed=2)
        torch.cuda.synchronize()
        return (out, [t.cpu() for t in tree_leaves(s.kernel.flow.params)],
                {w.__name__: w.launches for w in build.WRAPPERS})

    graphs.IterationGraph.run = lambda self, n: (runs.append((self, n)), orig(self, n))[1]
    try:
        if graphed_first:
            graphed = run(contextlib.nullcontext())
            n_runs = len(runs)
            eager = run(graphs.disable_graphs())
            assert len(runs) == n_runs
        else:
            eager = run(graphs.disable_graphs())
            assert runs == []
            graphed = run(contextlib.nullcontext())
    finally:
        graphs.IterationGraph.run = orig
    outer = {g for g, _n in runs if g.body.__name__ != "epoch"}
    assert outer and all(isinstance(g.backend, graphs._CudaGraph) and g.captured for g in outer)
    (ea, wa, la), (eb, wb, lb) = eager, graphed
    assert torch.equal(ea.samples, eb.samples)
    np.testing.assert_array_equal(ea.mean, eb.mean)
    assert {k: v for k, v in vars(ea.statistics).items() if isinstance(v, int)} == {
        k: v for k, v in vars(eb.statistics).items() if isinstance(v, int)}
    assert all(torch.equal(a, b) for a, b in zip(wa, wb))
    assert la == lb and sum(lb.values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path,name", [("dlmc", "realnvp"), ("tess", "realnvp"),
                                       ("adaptive_imh", "realnvp"), ("jump_mala", "realnvp"),
                                       ("jump_mala", "c-rqnsf")])
def test_refitting_chunks_capture_on_the_card(path, name):
    """Each refitting path captured for real (its refit an IF node, its
    epochs a WHILE node), bit for bit against the eager loop: draws,
    moments, counters, weights and launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these graphs are captured on the card")
    _card_compare(path, name)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dlmc", "tess", "adaptive_imh", "jump_mala"])
def test_first_capture_in_a_fresh_process(path):
    """In a fresh process, which has run no fit and no graph, each path
    runs with graphs first, then under ``disable_graphs()``, bit for bit.
    A graph's eager first iteration refits through the fit's own graph, so
    the epochs' WHILE node first runs in the capture; the jump run's gate is
    closed in its first iteration (``n_jumps_before_training`` = 3), so its
    whole refit first runs there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these graphs are captured on the card")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from tests.test_torch_refit_graph import _card_compare; "
            f"_card_compare({path!r}, 'realnvp', graphed_first=True)")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]

"""Flow fits as replays of captured graphs (``nfmc_torch.flows.train`` over
``nfmc_torch.core.graphs``) on the CPU, at d=6 with RealNVP and ``c-rqnsf``
(L=2, H=16, K=4).

* ``fit``, ``variational_fit`` and ``make_scan_fit``, run through the
  capture layer's static-buffer and counter protocol without capture
  (``graphs.without_capture``), give the eager loop's run
  (``graphs.disable_graphs``) bit for bit: the weights, the best weights and
  loss, the losses the host read and Adam's state, over shuffling, best
  weights, padding, validation data, a non-finite batch, early stopping,
  the ``ValueError`` rollback and ``train_pct``;
* a flow without the declaration (MAF) builds no graph;
* two calls of one ``make_scan_fit`` closure, or two ``Flow.fit`` calls of
  one shape, share one graph, and the second call's epochs are all
  replays;
* with a stand-in capture that records the launches and tallies of the
  iteration it captures and replays that count only what was recorded,
  the kernels faked on the CPU, the launch and step counts equal the eager
  loop's;
* the graph path against the JAX package's ``fit`` and ``variational_fit``
  on the same batches and draws, at ``tests/test_torch_train.py``'s and
  ``tests/test_torch_imh.py``'s tolerances (1e-4; 1e-5 relative plus 1e-4
  of the largest weight).
"""
import jax
import numpy as np
import pytest
import torch

import nfmc_torch
import nfmc_torch.flows.train as ttrain
import nfmc_tpu.flows.train as jtrain
from nfmc_torch.core import graphs
from nfmc_torch.flows import CouplingRQNSF, Flow, RealNVP, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as ops
from nfmc_tpu.flows import CouplingRQNSF as JCouplingRQNSF
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP

D, L, H, K = 6, 2, 16, 4
FLOWS = ("realnvp", "c-rqnsf")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flow(name, seed=0, perturb=0.1):
    bij = (RealNVP((D,), n_layers=L, hidden_size=H) if name == "realnvp"
           else CouplingRQNSF((D,), n_layers=L, hidden_size=H, n_bins=K))
    flow = Flow(bij, seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    flow.params = nfmc_torch.utils.tree_map(
        lambda t: t + perturb * torch.randn(t.shape, generator=g), flow.params)
    return flow


def _data(n, seed=2):
    rng = np.random.default_rng(seed)
    return (1.3 * rng.standard_normal((n, D)) + 0.5).astype(np.float32)


def _neg_u(x):
    return -0.5 * (((x - 0.8) / 1.5) ** 2).sum(-1)


class _RecordingNumpy:
    """numpy, except that ``isfinite`` records the 1-d arrays it is given:
    the host's one read of each block's losses."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def isfinite(self, a):
        if np.ndim(a) == 1:
            self.seen.append(np.array(a))
        return np.isfinite(a)


def _run(monkeypatch, ctx, flow, call):
    """``call()`` in ``ctx``: the weights it returns (or leaves in
    ``flow``), the carried tensors it ended with (weights, Adam's moments
    and count, the best weights and loss), the losses the host read and
    whether it raised the divergence ``ValueError``."""
    carries, rec = [], _RecordingNumpy()
    fitted = ttrain._fitted

    def recording(carry, keep_best):
        carries.append([t.clone() for t in carry])
        return fitted(carry, keep_best)

    monkeypatch.setattr(ttrain, "_fitted", recording)
    monkeypatch.setattr(ttrain, "np", rec)
    raised = False
    with ctx:
        try:
            out = call()
        except ValueError as e:
            assert "diverged" in str(e)
            out, raised = None, True
    monkeypatch.undo()
    return flow.params if out is None else out, carries, rec.seen, raised


def _flat(params):
    return torch.cat([t.reshape(-1) for t in nfmc_torch.utils.tree_leaves(params)])


def _assert_same(eager, graphed):
    (pe, ce, le, re), (pg, cg, lg, rg) = eager, graphed
    assert re == rg
    assert torch.equal(_flat(pe), _flat(pg))
    assert len(ce) == len(cg) == 1
    for a, b in zip(ce[0], cg[0]):
        assert torch.equal(a, b)
    assert len(le) == len(lg)
    for a, b in zip(le, lg):
        np.testing.assert_array_equal(a, b)


def _both(monkeypatch, make_call):
    """``make_call()`` gives a fresh ``(flow, call)``; run it eagerly and
    through the protocol, counting the replays."""
    runs = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append(n), run(self, n))[1])
    eager = _run(monkeypatch, graphs.disable_graphs(), *make_call())
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append(n), run(self, n))[1])
    assert runs == []
    graphed = _run(monkeypatch, graphs.without_capture(), *make_call())
    return eager, graphed, runs


def _bad_rows(x, rows=(3,)):
    x = x.copy()
    x[list(rows), 2] = np.nan
    return x


FIT_CASES = {
    "shuffle, padded": dict(n=70, kw=dict(n_epochs=5, batch_size=16)),
    "no shuffle, last weights": dict(n=70, kw=dict(n_epochs=4, batch_size=16, shuffle=False,
                                                   keep_best_weights=False)),
    "whole batches": dict(n=64, kw=dict(n_epochs=3, batch_size=16)),
    "x_val": dict(n=70, val=30, kw=dict(n_epochs=4, batch_size=16)),
    "non-finite batch": dict(n=70, val=30, bad=True, kw=dict(n_epochs=4, batch_size=16)),
    "early stopping": dict(n=70, kw=dict(n_epochs=40, batch_size=16, lr=0.2, early_stopping=True,
                                         early_stopping_threshold=3)),
    "blocks": dict(n=48, kw=dict(n_epochs=70, batch_size=48, shuffle=False)),
    "divergence rollback": dict(n=40, huge=True, kw=dict(n_epochs=3, batch_size=16,
                                                        check_for_divergences=True)),
    "non-finite last loss": dict(n=40, bad=True, kw=dict(n_epochs=2, batch_size=16)),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
@pytest.mark.parametrize("name", FLOWS)
def test_fit_replays_match_eager_loop(monkeypatch, name, case):
    c = FIT_CASES[case]
    x = _data(c["n"])
    if c.get("bad"):
        x = _bad_rows(x)
    if c.get("huge"):
        x = np.full_like(x, 1e30)
    x_val = _data(c["val"], seed=3) if c.get("val") else None

    def make_call():
        flow = _flow(name)
        return flow, lambda: flow.fit(x, x_val=x_val, seed=4, **c["kw"])

    eager, graphed, runs = _both(monkeypatch, make_call)
    _assert_same(eager, graphed)
    n_epochs = sum(len(v) for v in graphed[2])
    assert sum(runs) == n_epochs > 0
    if case == "early stopping":
        assert n_epochs < c["kw"]["n_epochs"]
    if case == "blocks":
        assert len(graphed[2]) == 2
    if case in ("divergence rollback", "non-finite last loss"):
        assert graphed[3]
    if case == "non-finite batch":
        assert not graphed[3] and np.all(np.isfinite(np.concatenate(graphed[2])))


VFIT_CASES = {
    "best weights": dict(kw=dict(n_samples=16, n_epochs=10, lr=0.01)),
    "last weights": dict(kw=dict(n_samples=16, n_epochs=10, lr=0.01, keep_best_weights=False)),
    "blocks, early stopping": dict(kw=dict(n_samples=8, n_epochs=140, lr=0.05,
                                           early_stopping=True, early_stopping_threshold=130)),
    "non-finite steps": dict(bad=True, kw=dict(n_samples=16, n_epochs=10, lr=0.01,
                                               check_for_divergences=True)),
}


@pytest.mark.parametrize("case", list(VFIT_CASES))
@pytest.mark.parametrize("name", FLOWS)
def test_variational_fit_replays_match_eager_loop(monkeypatch, name, case):
    c = VFIT_CASES[case]

    def target(x):
        u = _neg_u(x)
        if c.get("bad"):
            u = torch.where(x[:, 0] > 1.0, torch.full_like(u, float("nan")), u)
        return u

    def make_call():
        flow = _flow(name)
        return flow, lambda: flow.variational_fit(target, seed=5, **c["kw"])

    eager, graphed, runs = _both(monkeypatch, make_call)
    _assert_same(eager, graphed)
    n_steps = sum(len(v) for v in graphed[2])
    assert sum(runs) == n_steps > 0
    if c.get("bad"):
        assert not np.all(np.isfinite(np.concatenate(graphed[2])))


SCAN_CASES = {
    "shuffle": dict(n=70, kw=dict(n_epochs=4, batch_size=16)),
    "no shuffle, best weights": dict(n=64, kw=dict(n_epochs=3, batch_size=16, shuffle=False,
                                                   keep_best_weights=True)),
    "train_pct, best weights": dict(n=70, kw=dict(n_epochs=4, keep_best_weights=True,
                                                  train_pct=0.7)),
    "train_pct, last weights": dict(n=70, kw=dict(n_epochs=3, train_pct=0.7, batch_size=8)),
    "non-finite: rollback": dict(n=48, bad=True, kw=dict(n_epochs=2, batch_size=16)),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
@pytest.mark.parametrize("name", FLOWS)
def test_scan_fit_replays_match_eager_loop(monkeypatch, name, case):
    c = SCAN_CASES[case]
    x = _data(c["n"])
    if c.get("bad"):
        x = _bad_rows(x, rows=range(c["n"]))

    def make_call():
        flow = _flow(name)
        fit = ttrain.make_scan_fit(flow, c["n"], **c["kw"])
        return flow, lambda: fit(flow.params, torch.from_numpy(x),
                                 torch.Generator().manual_seed(6))

    eager, graphed, runs = _both(monkeypatch, make_call)
    _assert_same(eager, graphed)
    assert sum(runs) == c["kw"]["n_epochs"]
    if c.get("bad"):
        # the rollback: the fitted weights give a non-finite loss
        assert torch.equal(_flat(graphed[0]), _flat(_flow(name).params))


def test_undeclared_flow_builds_no_graph(monkeypatch):
    runs = []
    monkeypatch.setattr(graphs.IterationGraph, "run", lambda self, n: runs.append(n))
    flow = nfmc_torch.create_flow_object('maf%{"n_layers": 2, "hidden_size": 16}', (D,), seed=0)
    with graphs.without_capture():
        assert not graphs.fit_captures(flow, torch.device("cpu"))
        flow.fit(_data(40), n_epochs=2, batch_size=16, seed=0)
        flow.variational_fit(_neg_u, n_samples=8, n_epochs=2, seed=0)
        ttrain.make_scan_fit(flow, 40, n_epochs=2)(flow.params, torch.from_numpy(_data(40)),
                                                  torch.Generator().manual_seed(0))
    assert runs == [] and "_graphs" not in vars(flow)


def test_repeated_fits_share_one_graph():
    """A refit of the same shapes replays the graph its first call
    captured: two calls of one ``make_scan_fit`` closure, and two
    one-epoch ``Flow.fit`` calls (AdaptiveIMH's host refits)."""
    flow = _flow("realnvp")
    fit = ttrain.make_scan_fit(flow, 64, n_epochs=3, batch_size=16)
    with graphs.without_capture():
        fit(flow.params, torch.from_numpy(_data(64)), torch.Generator().manual_seed(0))
        (graph,) = fit._graphs.values()
        assert graph.replays == 2  # the first epoch ran eagerly
        params = fit(flow.params, torch.from_numpy(_data(64, seed=9)),
                     torch.Generator().manual_seed(1))
        assert list(fit._graphs.values()) == [graph] and graph.replays == 5
    with graphs.disable_graphs():
        want = fit(flow.params, torch.from_numpy(_data(64, seed=9)),
                   torch.Generator().manual_seed(1))
    assert torch.equal(_flat(params), _flat(want))

    with graphs.without_capture():
        for seed in (0, 1, 2):
            flow.fit(_data(64, seed=seed), n_epochs=1, seed=seed)
    (graph,) = flow._graphs.values()
    assert graph.replays == 2 and graph.captured


class _RecordingCapture:
    """A stand-in capture for the CPU: "capturing" runs the iteration once
    with its launches and tallies recorded, not counted, and then puts the
    graph's buffers back, so that the capture changes no state, as a CUDA
    capture changes none; a replay runs the iteration with its counts
    swallowed, and the graph counts what the capture recorded, as for a
    CUDA replay, which runs no Python."""

    pool_bytes = 0

    def __init__(self, device):
        self.fn = None

    def side_stream(self):
        import contextlib

        return contextlib.nullcontext()

    def capture(self, fn):
        graph = fn.__self__
        bufs = [graph.counter, *graph.state, *graph.outputs]
        saved = [t.clone() for t in bufs]
        fn()  # IterationGraph.run records this iteration's counts
        for t, s in zip(bufs, saved):
            t.copy_(s)
        self.fn = fn

    def replay(self):
        with build.recording():
            self.fn()


def _fake_kernels(monkeypatch):
    """The kernel wrappers take the CPU for the card: each launch is
    counted as on CUDA and computed by the plain version."""
    def launch(wrapper, params, x, clamp, inverse, packed):
        build.count_launch(wrapper, ("stack", "inverse" if inverse else "forward", D, H, L,
                                     x.shape[0]))
        return ops.realnvp_stack_plain(params, x, clamp, inverse)

    def launch_vjp(params, x, gy, gld, clamp, inverse, packed):
        build.count_launch(ops.fused_realnvp_vjp, ("vjp", "inverse" if inverse else "forward",
                                                   D, H, L, x.shape[0]))
        return ops.realnvp_stack_vjp_plain(params, x, gy, gld, clamp, inverse)

    monkeypatch.setattr(ops, "_on_device", lambda x: True)
    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_vjp", launch_vjp)


@pytest.mark.parametrize("kind", ["fit", "variational_fit", "make_scan_fit"])
def test_replayed_counts_equal_eager_counts(monkeypatch, kind):
    _fake_kernels(monkeypatch)
    monkeypatch.setattr(graphs, "_Uncaptured", _RecordingCapture)
    x = torch.from_numpy(_data(70))

    def call():
        flow = _flow("realnvp")
        if kind == "fit":
            flow.fit(x, x_val=x[:20], n_epochs=5, batch_size=16, seed=1)
            return flow.params
        if kind == "variational_fit":
            flow.variational_fit(_neg_u, n_samples=16, n_epochs=6, seed=1)
            return flow.params
        return ttrain.make_scan_fit(flow, 70, n_epochs=4, batch_size=16, keep_best_weights=True,
                                    train_pct=0.7)(flow.params, x, torch.Generator().manual_seed(1))

    counts = {}
    for mode, ctx in (("eager", graphs.disable_graphs()), ("graphs", graphs.without_capture())):
        build.reset_launch_counts()
        before = dict(ttrain.COUNTS)
        with ctx:
            params = call()
        counts[mode] = ({w.__name__: w.launches for w in build.WRAPPERS},
                        {k: ttrain.COUNTS[k] - before[k] for k in before}, _flat(params))
    (le, ce, pe), (lg, cg, pg) = counts["eager"], counts["graphs"]
    assert le == lg and ce == cg and torch.equal(pe, pg)
    if kind == "variational_fit":
        assert cg == {"steps": 0, "epochs": 0, "variational_steps": 6}
        assert lg["fused_realnvp_vjp"] == lg["fused_realnvp_inverse"] == 6
    else:
        # every step a forward and a VJP, every epoch a validation forward;
        # the closure also checks the fitted weights' loss once
        steps, epochs = cg["steps"], cg["epochs"]
        assert steps > epochs > 0 and lg["fused_realnvp_vjp"] == steps
        assert lg["fused_realnvp_forward"] == steps + epochs + (kind == "make_scan_fit")


# ---- the graph path against the JAX package ------------------------------------------------

def _jax_pair(name, seed):
    jcls = JRealNVP if name == "realnvp" else JCouplingRQNSF
    extra = {} if name == "realnvp" else {"n_bins": K}
    jflow = JFlow(jcls((D,), n_layers=L, hidden_size=H, use_pallas=False, **extra), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = _flow(name)
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


@pytest.mark.parametrize("name", FLOWS)
def test_fit_graph_path_matches_jax(monkeypatch, name):
    """70 rows at batch 16 (the last batch padded), 3 epochs, no shuffle, a
    validation set: the per-epoch validation losses and the weights."""
    jflow, flow = _jax_pair(name, seed=0 if name == "realnvp" else 2)
    x, x_val = _data(70), _data(30, seed=3)
    kw = dict(shuffle=False, batch_size=16, n_epochs=3)
    jrec, trec = _RecordingNumpy(), _RecordingNumpy()
    monkeypatch.setattr(jtrain, "np", jrec)
    monkeypatch.setattr(ttrain, "np", trec)
    jflow.fit(x, x_val=x_val, seed=0, **kw)
    runs = []
    run = graphs.IterationGraph.run
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (runs.append(n), run(self, n))[1])
    with graphs.without_capture():
        flow.fit(x, x_val=x_val, seed=0, **kw)
    assert runs == [3]
    np.testing.assert_allclose(trec.seen[0], jrec.seen[0], rtol=0, atol=1e-4)
    want = _flat(from_jax_params(jflow.params))
    assert float((_flat(flow.params) - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", FLOWS)
def test_variational_fit_graph_path_matches_jax(name):
    """Six Adam steps on the JAX run's own base draws."""
    n, n_epochs = 16, 6
    jflow, flow = _jax_pair(name, seed=0)
    key = jax.random.key(7)
    jflow.variational_fit(lambda x: _neg_u(x), n_samples=n, n_epochs=n_epochs, lr=0.01, key=key)
    _, sub = jax.random.split(key)
    zs = iter([torch.from_numpy(np.array(jax.random.normal(k, (n, D))))
               for k in jax.random.split(sub, n_epochs)])
    with graphs.without_capture():
        flow.variational_fit(_neg_u, n_samples=n, n_epochs=n_epochs, lr=0.01, seed=0,
                             base_draws=lambda g, m: next(zs))
    assert len(flow._graphs) == 1
    want = _flat(from_jax_params(jflow.params))
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(_flat(flow.params).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4 * scale)

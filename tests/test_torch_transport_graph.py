"""The transport layer and FAB as replays of captured graphs
(``nfmc_torch.transport``, ``nfmc_torch.flow_training.fab`` over
``nfmc_torch.core.graphs``) on the CPU, at d=4 with RealNVP (L=2, H=8).

* FAB (a 64-row buffer, 24 AIS particles, 3 replay steps, 3 iterations
  over two ``run()`` calls, so that the ring wraps), ``AnnealChain`` (16
  particles), CRAFT's training and sampling passes, AFT's level fits and
  PMC's fits and pCN sweeps, run through the capture layer's static-buffer
  and counter protocol without capture (``graphs.without_capture``), give
  the eager loop's run (``graphs.disable_graphs``) bit for bit: the flow
  weights, every loop's carried tensors (Adam's moments and count, FAB's
  buffer with its device index and fill, the best weights and loss,
  ``rho_logit``) and outputs (``loss_trace``, log Z), the particles and
  log-weights, and, with a stand-in capture that records the launches of
  the iteration it captures and the kernels faked on the CPU, each kernel
  wrapper's launch count;
* repeated runs of one shape replay one graph, and an undeclared flow
  builds none;
* the graph path of FAB and of the AIS chain against the JAX package with
  its draws injected, at ``tests/test_torch_fab.py``'s and
  ``tests/test_torch_transport.py``'s tolerance (1e-5);
* ``tempered`` with a tensor inverse temperature, and its gradient, against
  the JAX package's at 0, 1/2 and 1 on a hard-support target.

The capture itself, on the card: ``tests/test_torch_cuda_transport.py``.
"""
import contextlib
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.core import graphs
from nfmc_torch.flow_training import FAB
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as ops
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.transport import CRAFT, AnnealedFlowTransport, PreconditionedMonteCarlo
from nfmc_torch.transport import ais as tais
from nfmc_torch.transport import common as tcommon
from nfmc_torch.utils import tree_leaves
from nfmc_tpu.flow_training.fab import FAB as JFAB
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.potentials import StandardGaussian as JStandardGaussian
from nfmc_tpu.transport import ais as jais
from nfmc_tpu.transport import common as jcommon
from tests.transport_parity import close, jax_chain_draws, t
from tests.transport_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

# the package exports the function ``fab`` under the module's name
fab_mod = importlib.import_module("nfmc_torch.flow_training.fab")

D, L, H = 4, 2, 8
PRIOR = StandardGaussian((D,))
TARGET = DiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
FAB_KW = dict(n_flow_training_steps=3, n_ais_particles=24, n_training_particles=10)


def _flow(seed=0, perturb=0.2):
    flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H), seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    flow.params = nfmc_torch.utils.tree_map(
        lambda v: v + perturb * torch.randn(v.shape, generator=g), flow.params)
    return flow


def _flat(params):
    return torch.cat([v.reshape(-1) for v in tree_leaves(params)])


def _prior_sample(batch_shape, generator=None):
    return PRIOR.sample(batch_shape, generator=generator)


class _RecordingCapture:
    """A stand-in capture for the CPU: "capturing" runs the iteration once
    with its launches recorded, not counted, and then puts the graph's
    buffers back, as a CUDA capture changes no state; a replay runs the
    iteration with its counts swallowed, and the graph counts what the
    capture recorded, as for a CUDA replay, which runs no Python."""

    pool_bytes = 0

    def __init__(self, device):
        self.fn = None

    def side_stream(self):
        return contextlib.nullcontext()

    def capture(self, fn):
        graph = fn.__self__
        bufs = [graph.counter, *graph.state, *graph.outputs]
        saved = [b.clone() for b in bufs]
        fn()
        for b, s in zip(bufs, saved):
            b.copy_(s)
        self.fn = fn

    def replay(self):
        with build.recording():
            self.fn()


def _fake_kernels(monkeypatch):
    """The RealNVP wrappers take the CPU for the card: each launch is
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
    monkeypatch.setattr(graphs, "_Uncaptured", _RecordingCapture)


# ---- each path, run both ways --------------------------------------------------------

def _fab():
    flow = _flow()
    alg = FAB(TARGET, flow, buffer_size=64, n_ais_steps=3, n_mcmc_steps=2)
    alg.run(n_iterations=1, seed=0, **FAB_KW)
    traces = [alg.loss_trace.clone()]
    alg.run(n_iterations=2, seed=1, **FAB_KW)
    traces.append(alg.loss_trace)
    return {"weights": _flat(flow.params), "buffer": list(alg._buf_state),
            "loss_trace": traces}, alg


def _ais():
    chain = tais.make_ais(PRIOR, TARGET, n_steps=5, n_mcmc_steps=2, step_size=0.1)
    g = torch.Generator().manual_seed(3)
    x0 = PRIOR.sample((16,), generator=g)
    out = [chain(x0, chain.draws(g, tuple(x0.shape))) for _ in range(2)]
    return {"x": [o[0] for o in out], "log_w": [o[1] for o in out]}, chain


def _craft():
    bijections = [_flow(seed=i).bijection for i in range(3)]
    alg = CRAFT(PRIOR, TARGET, bijections, sampling_threshold=0.6, n_mcmc_steps=2)
    alg.train(_prior_sample, n_particles=32, n_training_steps=3, seed=0)
    out = {"weights": [_flat(b.params) for b in bijections]}
    for seed in (1, 2):  # the second pass replays the sampling graph
        res = alg.sample(_prior_sample, n_particles=32, seed=seed)
        out.update({f"{k} {seed}": torch.as_tensor(np.asarray(v)) for k, v in res.items()})
    return out, alg


def _aft():
    flow = _flow()
    alg = AnnealedFlowTransport(PRIOR, TARGET, flow, n_steps=4, n_train_epochs=5)
    res = alg.run(_prior_sample, n_particles=32, n_train_particles=24, n_val_particles=16,
                  seed=0, full_output=True)
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in res.items()}
    return {**out, "weights": _flat(flow.params)}, alg


def _pmc():
    flow = _flow()
    alg = PreconditionedMonteCarlo(PRIOR, TARGET, flow, ess_target=0.3, n_mcmc_steps=3,
                                   n_train_epochs=4, max_levels=4)
    res = alg.run(_prior_sample, n_particles=32, seed=0, full_output=True)
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in res.items()}
    return {**out, "weights": _flat(flow.params)}, alg


PATHS = {"fab": _fab, "ais": _ais, "craft": _craft, "aft": _aft, "pmc": _pmc}


def _run(monkeypatch, ctx, make):
    """``make()`` in ``ctx``: its results, the carried tensors and outputs
    of every loop it ran (``graphs.iterations``), each wrapper's launches,
    the replays and the object that owns the graphs."""
    loops, replays = [], []
    iterations, run = graphs.iterations, graphs.IterationGraph.run

    def recording(*args, **kw):
        carry, consts, outs = iterations(*args, **kw)
        loops.append([v.clone() for v in (*carry, *outs)])
        return carry, consts, outs

    monkeypatch.setattr(graphs, "iterations", recording)
    monkeypatch.setattr(graphs.IterationGraph, "run",
                        lambda self, n: (replays.append(n), run(self, n))[1])
    build.reset_launch_counts()
    with ctx:
        out, owner = make()
    launches = {w.__name__: w.launches for w in build.WRAPPERS}
    monkeypatch.setattr(graphs, "iterations", iterations)
    monkeypatch.setattr(graphs.IterationGraph, "run", run)
    return out, loops, launches, replays, owner


def _equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what} {k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what} {i}")
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), what


@pytest.mark.parametrize("path", list(PATHS))
def test_replays_match_eager_loop(monkeypatch, path):
    _fake_kernels(monkeypatch)
    eager = _run(monkeypatch, graphs.disable_graphs(), PATHS[path])
    graphed = _run(monkeypatch, graphs.without_capture(), PATHS[path])
    (oe, le, ce, re, _), (og, lg, cg, rg, owner) = eager, graphed
    _equal(oe, og, path)
    if path != "ais":  # the eager chain is a plain loop over the levels
        _equal(le, lg, f"{path} loops")
    # AIS runs no flow; every other path trains one through the VJP kernel
    assert ce == cg and (sum(ce.values()) > 0) == (ce["fused_realnvp_vjp"] > 0) == (
        path != "ais"), (ce, cg)
    assert re == [] and sum(rg) > 0
    # FAB's two runs hoist blocks of 1 and 2 iterations: two graphs; CRAFT
    # and PMC each have two loops
    assert len(owner._graphs) == {"fab": 2, "craft": 2, "pmc": 2}.get(path, 1)


def test_fab_buffer_wraps_on_the_device():
    out, alg = _fab()
    buf_x, buf_lw, buf_lq, index, filled = out["buffer"]
    assert index.dtype == filled.dtype == torch.int64 and index.dim() == filled.dim() == 0
    assert (int(index), int(filled)) == (3 * 24 % 64, 64)
    assert out["loss_trace"][0].shape == (1,) and out["loss_trace"][1].shape == (2,)


def test_repeated_runs_replay_one_graph():
    """A second FAB run and a second AIS chain of the same shapes replay the
    graph the first captured; an AFT level fit's graph serves every level."""
    with graphs.without_capture():
        alg = FAB(TARGET, _flow(), buffer_size=64, n_ais_steps=3, n_mcmc_steps=2)
        for seed in (0, 1):
            alg.run(n_iterations=2, seed=seed, **FAB_KW)
        (graph,) = alg._graphs.values()
        # 4 iterations over two runs: the first eager, the other three replays
        assert graph.replays == 3 and graph.captured
        _, chain = _ais()
        (graph,) = chain._graphs.values()
        assert graph.replays == 2 * 5 - 1
        _, aft = _aft()
        (graph,) = aft._graphs.values()
        assert graph.replays == 3 * 5 - 1


def test_undeclared_flow_builds_no_graph(monkeypatch):
    runs = []
    monkeypatch.setattr(graphs.IterationGraph, "run", lambda self, n: runs.append(n))
    flow = nfmc_torch.create_flow_object('maf%{"n_layers": 2, "hidden_size": 8}', (D,), seed=0)
    with graphs.without_capture():
        assert not graphs.transport_captures([flow.bijection], torch.device("cpu"))
        alg = FAB(TARGET, flow, buffer_size=64, n_ais_steps=2, n_mcmc_steps=1)
        alg.run(n_iterations=2, seed=0, **FAB_KW)
        aft = AnnealedFlowTransport(PRIOR, TARGET, flow, n_steps=3, n_train_epochs=2)
        aft.run(_prior_sample, n_particles=16, n_train_particles=16, n_val_particles=8, seed=0)
    assert runs == [] and "_graphs" not in vars(alg) and "_graphs" not in vars(aft)


# ---- the graph path against the JAX package ------------------------------------------------

def test_ais_graph_path_matches_jax():
    x0 = np.random.default_rng(0).standard_normal((16, D)).astype(np.float32)
    jprior = JStandardGaussian((D,))
    jtarget = JDiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
    key = jax.random.key(11)
    jx, jlw = jais.make_ais(jprior, jtarget, n_steps=6, n_mcmc_steps=2, step_size=0.1)(
        jnp.asarray(x0), key)
    run = tais.make_ais(PRIOR, TARGET, n_steps=6, n_mcmc_steps=2, step_size=0.1)
    with graphs.without_capture():
        x, lw = run(t(x0), jax_chain_draws(key, 6, 2, x0.shape))
    assert len(run._graphs) == 1
    close(x, np.asarray(jx), 1e-5, "x")
    close(lw, np.asarray(jlw), 1e-5, "log_w")


def _jax_fab_pair():
    jflow = JFlow(JRealNVP((D,), n_layers=L, hidden_size=H, use_pallas=False), seed=0)
    rng = np.random.default_rng(1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(RealNVP((D,), n_layers=L, hidden_size=H))
    flow.params = from_jax_params(jflow.params)
    jtarget = JDiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
    kw = dict(buffer_size=64, n_ais_steps=3, n_mcmc_steps=2)
    return JFAB(jtarget, jflow, **kw), FAB(TARGET, flow, **kw)


def test_fab_graph_path_matches_jax_with_the_draws_injected(monkeypatch):
    """Three iterations (the third wraps the ring) with the JAX run's own
    draws, the Gumbel noise injected as ``tests/test_torch_fab.py`` does:
    the buffer's rows, weights, densities, index and fill, the reported
    losses and the weights."""
    jf, tf = _jax_fab_pair()
    n_it, (n_steps, n_ais, n_train) = 3, (3, 24, 10)
    key = jax.random.key(5)
    jp = jf.flow.params
    jp2, _, jbuf, jlosses = jf._make_fused_run(n_it, n_steps, n_ais, n_train)(
        jp, jf.opt.init(jp), jf._init_buffer(), key)
    ais, gumbels = [], []
    for k in jax.random.split(key, n_it):
        k_ais, k_train = jax.random.split(k)
        k_draw, k_chain = jax.random.split(k_ais)
        z = t(jax.random.normal(k_draw, (n_ais, D)))
        levels = jax_chain_draws(k_chain, 3, 2, (n_ais, D))
        ais.append((z, torch.stack([lv[0] for lv in levels]),
                    torch.stack([lv[1] for lv in levels])))
        gumbels.append(torch.stack([t(jax.random.gumbel(kt, (n_train, 64)))
                                    for kt in jax.random.split(k_train, n_steps)]))
    ais, gumbels = iter(ais), iter(gumbels)
    monkeypatch.setattr(tf, "_stacked_ais_draws", lambda g, n: next(ais))
    monkeypatch.setattr(fab_mod, "gumbel", lambda g, shape: next(gumbels))
    carries = []
    iterations = graphs.iterations

    def recording(*args, **kw):
        out = iterations(*args, **kw)
        carries.append([v.clone() for v in out[0]])
        return out

    monkeypatch.setattr(graphs, "iterations", recording)
    with graphs.without_capture():
        tf.run(n_iterations=n_it, n_flow_training_steps=n_steps, n_ais_particles=n_ais,
               n_training_particles=n_train, seed=0)
    assert len(tf._graphs) == 1
    for got, want, what in zip(tf._buf_state[:3], jbuf[:3], ("rows", "log w", "log q")):
        close(got, np.asarray(want), 1e-5, what=what)
    assert tuple(int(v) for v in tf._buf_state[3:]) == (int(jbuf[3]), int(jbuf[4])) == (8, 64)
    close(tf.loss_trace, np.asarray(jlosses), 1e-5, what="losses")
    # the witness rule of tests/test_torch_fab.py: a weight may part from
    # JAX's by more than 1e-5 only where its RMS gradient is below 1e-5 of
    # the largest (Adam's step of +-lr on a gradient within float32 of 0)
    theta, nu, count = carries[-1][0], carries[-1][2], carries[-1][3]
    want = torch.cat([b.reshape(-1) for b in tree_leaves(from_jax_params(jp2))])
    rms = (nu / (1.0 - 0.999 ** count)).sqrt()
    parted = (theta - want).abs() > 1e-5 * max(1.0, float(want.abs().max()))
    assert parted.sum() <= 16 and (rms[parted] <= 1e-5 * rms.max()).all(), int(parted.sum())


def _hard(lib):
    """U = +inf where x_0 < 0, else 0.5 |x - 1|^2 (``tests/test_torch_transport.py``'s)."""
    if lib is jnp:
        return lambda x: jnp.where(x[..., 0] < 0.0, jnp.inf, 0.5 * jnp.sum((x - 1.0) ** 2, -1))
    return lambda x: torch.where(x[..., 0] < 0.0, math.inf, 0.5 * ((x - 1.0) ** 2).sum(-1))


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
def test_tensor_tempered_and_its_gradient_match_jax(lam):
    """Values, and gradients where JAX's are finite (every row here), of
    ``tempered`` at a 0-d float32 tensor ``lam`` on the hard-support
    target: no NaN from the masked side."""
    x = (2.0 * np.random.default_rng(0).standard_normal((32, D))).astype(np.float32)
    ju = jcommon.tempered(JStandardGaussian((D,)), _hard(jnp))
    tu = tcommon.tempered(PRIOR, _hard(torch))
    jlam = jnp.float32(lam)
    want = np.asarray(ju(jnp.asarray(x), jlam))
    jgrad = np.asarray(jax.grad(lambda v: ju(v, jlam).sum())(jnp.asarray(x)))
    v = t(x).requires_grad_(True)
    got = tu(v, torch.tensor(lam, dtype=torch.float32))
    (grad,) = torch.autograd.grad(got.sum(), v)
    close(got, want, 1e-6, f"u at lam {lam}")
    assert np.isfinite(jgrad).all()
    assert torch.isfinite(grad).all()
    close(grad, jgrad, 1e-6, f"grad u at lam {lam}")
    # the host float gives the same values
    close(tu(t(x), lam), want, 1e-6, f"u at host lam {lam}")

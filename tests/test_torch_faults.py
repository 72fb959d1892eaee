"""Places where the port once refused or lacked what the JAX package
computes, checked on the CPU against nfmc_tpu with the same numpy inputs:

* the streaming expectations' ``update``, ``reset``, ``as_tensor`` and the
  ``data_transform`` of ``MCMCExpectationDict`` and ``MCMCStatistics``;
* coupling flows whose conditioners have another depth than 2 hidden
  layers, which run the plain stack (the reference's XLA path);
* strided rows (a column slice) handed to a flow;
* ``sample()``'s ``mesh`` and ``checkpoint_*`` keywords (3.6), the unroll
  fields of the parameters (3.7), the default ``sample_continue`` (3.8),
  ``Flow.sample`` / ``Flow.to``'s signatures and the strategy lists (3.9);
* the names ``nfmc_tpu.core`` and ``nfmc_tpu.samplers.mcmc`` export, and
  the samplers built on ``MetropolisSampler`` (3.12).

Tolerances as in ``tests/test_torch_flows.py`` and
``tests/test_torch_spline.py``: float32 values to 1e-5 (RealNVP) or 2e-5
(splines) times max(1, max|reference|); the moments, computed in float64
from the same draws, to 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.core import statistics as jstats
from nfmc_tpu.flows import CouplingRQNSF as JCouplingRQNSF
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_torch.core import statistics as tstats
from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP, from_jax_params
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as cops
from nfmc_torch.utils import tree_leaves

# ---- 3.4: the expectations' API -----------------------------------------------


@pytest.mark.parametrize("shape", [(4, 3, 5), (3, 5)])
def test_expectation_update_matches_jax(shape):
    """Draws (iterations, chains, d) or (chains, d), fed twice, then reset."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    f = lambda v: v ** 2  # noqa: E731
    j, t = jstats.MCMCExpectation((5,), f=f), tstats.MCMCExpectation((5,), f=f)
    j.update(jnp.asarray(a))
    t.update(torch.from_numpy(a))
    j.update(b)
    t.update(torch.from_numpy(b))
    assert t.n_seen == j.n_seen
    np.testing.assert_allclose(t.as_tensor(), j.as_tensor(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="bad shape"):
        t.update(torch.zeros(5))
    t.reset()
    assert t.n_seen == 0 and float(t.as_tensor()) == 0.0


def test_expectation_dict_and_statistics_data_transform_match_jax():
    """The transform applies to the draws before each expectation, in the
    dict and through ``MCMCStatistics``'s own field."""
    rng = np.random.default_rng(1)
    draws = [rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(3)]
    transform = lambda v: 2.0 * v + 1.0  # noqa: E731
    js = jstats.MCMCStatistics((4,), data_transform=transform)
    ts = tstats.MCMCStatistics((4,), data_transform=transform)
    assert ts.expectations.data_transform is transform
    for x in draws:
        js.expectations.update(jnp.asarray(x))
        ts.expectations.update(torch.from_numpy(x))
    jt, tt = js.expectations.as_tensor(), ts.expectations.as_tensor()
    assert set(tt) == set(jt) == {"first_moment", "second_moment"}
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.running_variance, js.running_variance, rtol=0, atol=1e-12)
    ts.expectations.reset()
    assert all(e.n_seen == 0 for e in ts.expectations.expectations.values())
    plain = tstats.JumpNFMCStatistics((4,))
    plain.expectations.update(torch.from_numpy(draws[0]))
    np.testing.assert_allclose(plain.running_first_moment, draws[0].astype(np.float64).mean((0, 1)),
                               rtol=0, atol=1e-12)


# ---- 3.2: conditioners with 3 hidden layers -------------------------------------


def _pair(kind, d, seed=0):
    """A JAX flow with 3 hidden layers a conditioner, every parameter moved
    by 0.1 N(0, 1), and its port with the same weights."""
    rng = np.random.default_rng(seed + 1)
    if kind == "realnvp":
        jb = JRealNVP((d,), n_layers=3, hidden_size=16, n_hidden_layers=3, use_pallas=False)
        tb = RealNVP((d,), n_layers=3, hidden_size=16, n_hidden_layers=3)
    else:
        jb = JCouplingRQNSF((d,), n_layers=3, hidden_size=16, n_bins=4, n_hidden_layers=3,
                            use_pallas=False)
        tb = CouplingRQNSF((d,), n_layers=3, hidden_size=16, n_bins=4, n_hidden_layers=3)
    jflow = JFlow(jb, seed=seed)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(tb)
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _close(got, want, tol):
    want = np.asarray(want)
    err = float(np.max(np.abs(got.detach().numpy() - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


@pytest.mark.parametrize("kind,tol", [("realnvp", 1e-5), ("c-rqnsf", 2e-5)])
def test_three_hidden_layers_match_jax(kind, tol):
    """Forward, inverse and a gradient of the log-density; the flow runs the
    plain stack and no kernel wrapper, while the wrapper itself still
    refuses the depth."""
    build.reset_launch_counts()
    jflow, flow = _pair(kind, 7)
    assert not flow.bijection.fused and len(flow.params[0]["w"]) == 4
    x = 3 * np.random.default_rng(2).standard_normal((37, 7)).astype(np.float32)
    for fn in ("forward_fn", "inverse_fn"):
        yj, ldj = getattr(jflow.bijection, fn)(jflow.params, jnp.asarray(x))
        yt, ldt = getattr(flow.bijection, fn)(flow.params, torch.from_numpy(x))
        _close(yt, yj, tol)
        _close(ldt, ldj, tol)
    gj = jax.grad(lambda v: jflow.log_prob(v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(flow.log_prob_fn(flow.params, xt).sum(), xt)
    _close(gt, gj, 25 * tol)  # the steep maps amplify rounding, as for GRAD_TOL
    assert all(w.launches == 0 for w in build.WRAPPERS)
    with pytest.raises(ValueError, match="exactly 2 hidden layers"):
        cops.pack_weights(flow.params)


def test_three_hidden_layers_through_the_flow_string():
    """The DSL's ``conditioner_kwargs`` reach the depth, as in
    ``tests/test_flow_kwargs.py``, and the flow trains on the plain stack."""
    from nfmc_torch.api.registry import create_flow_object

    flow = create_flow_object(
        'c-lrsnsf%{"n_layers": 2, "n_bins": 4, "conditioner_kwargs": {"n_layers": 3, "n_hidden": 8}}',
        (5,), seed=0)
    assert isinstance(flow.bijection, CouplingLRS) and not flow.bijection.fused
    assert [w.shape[1] for w in flow.params[0]["w"][:-1]] == [8, 8, 8]
    x = np.random.default_rng(3).standard_normal((40, 5)).astype(np.float32)
    before = tree_leaves(flow.params)[0].clone()
    flow.fit(x, n_epochs=2, batch_size=16, early_stopping=False, seed=0)
    assert not torch.equal(tree_leaves(flow.params)[0], before)
    assert torch.isfinite(flow.log_prob(torch.from_numpy(x))).all()


# ---- 3.1: strided rows --------------------------------------------------------


@pytest.mark.parametrize("cls", [RealNVP, CouplingRQNSF])
def test_flow_takes_a_column_slice(cls):
    """``flow.log_prob(big[:, :d])`` is a strided view; the flow gives what
    it gives on the same rows made contiguous, in both directions."""
    flow = Flow(cls((6,), n_layers=2, hidden_size=8), seed=0)
    flow.params = [{k: [t + 0.1 for t in v] for k, v in p.items()} for p in flow.params]
    big = torch.randn((9, 10), generator=torch.Generator().manual_seed(0))
    view = big[:, :6]
    assert not view.is_contiguous()
    assert torch.equal(flow.log_prob(view), flow.log_prob(view.contiguous()))
    z, ld = flow.bijection.inverse(view)
    z_c, ld_c = flow.bijection.inverse(view.contiguous())
    assert torch.equal(z, z_c) and torch.equal(ld, ld_c)


# ---- 3.6-3.9: the JAX package's signatures --------------------------------------

import dataclasses  # noqa: E402
import inspect  # noqa: E402

import nfmc_torch  # noqa: E402
import nfmc_tpu  # noqa: E402
from nfmc_torch.potentials import StandardGaussian  # noqa: E402

_JAX_KW = ("mesh", "checkpoint_path", "checkpoint_segment_iterations",
           "checkpoint_save_samples")


def test_sample_takes_the_jax_keywords():
    """``sample()`` takes every keyword of the JAX front door with its
    default; the port runs with those defaults (both packages do), and a
    ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError`` (sharded runs:
    ``tests/test_torch_parallel.py``; the checkpoint keywords:
    ``tests/test_torch_checkpoint.py``)."""
    jsig = inspect.signature(nfmc_tpu.sample).parameters
    tsig = inspect.signature(nfmc_torch.sample).parameters
    for name, param in jsig.items():
        assert name in tsig and tsig[name].default == param.default, name
    defaults = {k: None for k in _JAX_KW}
    jout = nfmc_tpu.sample(lambda x: 0.5 * jnp.sum(x ** 2, -1), event_shape=(3,), strategy="mala",
                           n_chains=4, n_iterations=3, show_progress=False, seed=0, **defaults)
    out = nfmc_torch.sample(StandardGaussian((3,)), strategy="mala", n_chains=4, n_iterations=3,
                            device="cpu", show_progress=False, seed=0, **defaults)
    assert tuple(out.samples.shape) == tuple(np.shape(jout.samples)) == (3, 4, 3)
    with pytest.raises(TypeError, match="DeviceMesh"):
        nfmc_torch.sample(StandardGaussian((3,)), strategy="mala", n_chains=4, n_iterations=3,
                          device="cpu", show_progress=False, mesh=object())


def _field_defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING}


def test_unroll_fields_match_jax():
    from nfmc_torch.core import MCMCParameters
    from nfmc_torch.samplers.nfmc import JumpNFMCParameters
    from nfmc_tpu.core import MCMCParameters as JMCMCParameters
    from nfmc_tpu.samplers.nfmc.jump import JumpNFMCParameters as JJumpNFMCParameters

    assert _field_defaults(MCMCParameters)["scan_unroll"] == 1
    for field in ("scan_unroll", "fused_unroll_inner", "fused_unroll_outer"):
        assert (_field_defaults(JumpNFMCParameters)[field]
                == _field_defaults(JJumpNFMCParameters)[field] == 1)
    assert _field_defaults(JMCMCParameters)["scan_unroll"] == 1
    out = nfmc_torch.sample(StandardGaussian((3,)), strategy="mala", n_chains=4, n_iterations=3,
                            device="cpu", show_progress=False, seed=0,
                            param_kwargs={"scan_unroll": 2})
    plain = nfmc_torch.sample(StandardGaussian((3,)), strategy="mala", n_chains=4,
                              n_iterations=3, device="cpu", show_progress=False, seed=0)
    assert torch.equal(out.samples, plain.samples)  # no effect on the eager loops


JUMPS = [s for s in nfmc_torch.get_supported_nfmc_samplers() if s.startswith("jump_")]


@pytest.mark.parametrize("strategy", JUMPS)
def test_fused_unroll_runs_for_every_jump_strategy(strategy):
    kw = {"negative_log_likelihood": StandardGaussian((3,))} if strategy == "jump_ess" else {}
    run = lambda **pk: nfmc_torch.sample(  # noqa: E731
        StandardGaussian((3,)), strategy=strategy, flow='realnvp%{"hidden_size": 8}',
        n_chains=4, n_iterations=2, inner_param_kwargs={"n_iterations": 2}, device="cpu",
        show_progress=False, seed=0, param_kwargs=pk, **kw)
    out = run(fused_unroll_outer=4, fused_unroll_inner=2)
    assert torch.equal(out.samples, run().samples)


@pytest.mark.parametrize("strategy", ["mala", "hmc", "mh", "nuts", "aies", "chees_hmc",
                                      "dense_mala", "imh", "jump_mala", "jump_hmc"])
def test_default_sample_continue(strategy):
    """The samplers without their own continuation inherit ``sample`` as
    ``sample_continue``, as the JAX ``Sampler`` does."""
    from nfmc_torch.core.sampler import Sampler
    from nfmc_tpu.core.sampler import Sampler as JSampler

    assert "sample_continue" in vars(JSampler) and "sample_continue" in vars(Sampler)
    sampler = nfmc_torch.create_sampler(StandardGaussian((3,)), strategy=strategy,
                                        flow='realnvp%{"hidden_size": 8}', device="cpu",
                                        param_kwargs={"n_iterations": 2},
                                        inner_param_kwargs={"n_iterations": 2})
    assert type(sampler).sample_continue is Sampler.sample_continue
    x0 = torch.randn((8, 3), generator=torch.Generator().manual_seed(0))
    first = sampler.sample(x0, show_progress=False, seed=1)
    last = first.running_samples.last_sample
    again = sampler.sample_continue(last, show_progress=False, seed=2)
    direct = sampler.sample(last, show_progress=False, seed=2)
    assert torch.equal(again.samples, direct.samples)


def test_flow_sample_and_to_take_the_jax_signatures(monkeypatch):
    """``flow.sample(3, True)`` is draws in both packages (``no_grad``
    second); ``to()`` defaults to the default device; the strategy lists
    equal the JAX package's."""
    jflow = JFlow(JRealNVP((4,), hidden_size=8), seed=0)
    flow = Flow(RealNVP((4,), hidden_size=8), seed=0)
    assert np.shape(jflow.sample(3, True)) == tuple(flow.sample(3, True).shape) == (3, 4)
    x, log_q = flow.sample(3, True, True, seed=1)
    assert x.shape == (3, 4) and log_q.shape == (3,) and not x.requires_grad
    flow.params = [{k: [t.detach().requires_grad_(True) for t in v] for k, v in p.items()}
                   for p in flow.params]
    assert not flow.sample(3, True, seed=1).requires_grad
    assert flow.sample(3, False, seed=1).requires_grad  # the graph to the weights kept
    assert list(inspect.signature(Flow.sample).parameters)[:4] == ["self", "n", "no_grad",
                                                                   "return_log_prob"]
    assert inspect.signature(Flow.to).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flow.to()  # the default device is the card
    monkeypatch.setattr("nfmc_torch.flows.base.resolve_device", lambda d=None: torch.device("cpu"))
    assert flow.to() is flow and flow.get_device().type == "cpu"
    for name in ("get_supported_samplers", "get_supported_mcmc_samplers",
                 "get_supported_nfmc_samplers"):
        assert getattr(nfmc_torch, name)() == getattr(nfmc_tpu, name)()


# ---- 3.10: bijection.layers on every flow ---------------------------------------

LAYER_CASES = [("realnvp", (6,)), ("nice", (6,)), ("c-rqnsf", (6,)), ("c-naf-deep", (6,)),
               ("maf", (6,)), ("ia-naf-dense", (6,)), ("planar", (6,)), ("sylvester", (6,)),
               ("i-resnet", (6,)), ("ffjord", (6,)), ("ddb", (6,)), ("ms-realnvp", (8, 8)),
               ("glow-nice", (8, 8)), ("conv-i-resnet", (8, 8)), ("conv-ffjord", (8, 8))]


@pytest.mark.parametrize("name,shape", LAYER_CASES, ids=[n for n, _ in LAYER_CASES])
def test_bijection_layers_match_jax(name, shape):
    """``bijection.layers`` (torchflows parity) has JAX's length for a name
    of each family, and through ``Inverse``."""
    import nfmc_torch
    import nfmc_tpu
    from nfmc_torch.flows import Inverse
    from nfmc_tpu.flows import Inverse as JInverse

    jb = nfmc_tpu.create_flow_object(name, shape).bijection
    tb = nfmc_torch.create_flow_object(name, shape).bijection
    assert len(tb.layers) == len(jb.layers) > 0
    assert len(Inverse(tb).layers) == len(JInverse(jb).layers)


def test_bijection_layers_through_sample():
    """``tests/test_flow_kwargs.py``'s check in the port: the flow string's
    ``n_layers`` reaches ``out.kernel.flow.bijection.layers``."""
    import nfmc_torch
    import nfmc_tpu

    def n_layers(flow):
        out = nfmc_torch.sample(StandardGaussian((20,)), flow=flow, strategy="imh",
                                n_iterations=2, n_chains=4, device="cpu", seed=0,
                                show_progress=False)
        return len(out.kernel.flow.bijection.layers)

    basic, advanced = n_layers("realnvp"), n_layers('realnvp%{"n_layers": 10}')
    assert advanced == 10 > basic
    assert basic == len(nfmc_tpu.create_flow_object("realnvp", (20,)).bijection.layers)


# ---- 3.11: the lazily loaded submodules -------------------------------------------


def test_lazy_submodules_match_jax():
    """``nfmc_torch.parallel``, ``.profiling`` and ``.validation`` load on
    access, as ``nfmc_tpu``'s, are listed by ``dir()``, and start no
    process group; an unknown name still raises ``AttributeError``."""
    import importlib

    import torch.distributed as dist

    import nfmc_torch
    import nfmc_tpu

    running = dist.is_initialized()
    for name in ("parallel", "profiling", "validation"):
        assert name in dir(nfmc_torch) and name in dir(nfmc_tpu)
        assert getattr(nfmc_torch, name) is importlib.import_module("nfmc_torch." + name)
    assert dist.is_initialized() == running
    assert callable(nfmc_torch.parallel.chain_mesh) and callable(nfmc_torch.profiling.trace)
    with pytest.raises(AttributeError):
        nfmc_torch.no_such_module


# ---- 3.12: the exported names and the Metropolis samplers' base ----------------------

# the JAX package's names that the port has no counterpart of, each a
# recorded divergence (ROADMAP §3)
NOT_PORTED = {
    "next_key": "JAX keys; the port draws from torch.Generators",
    "resolve_key": "JAX keys; the port's core.rng.resolve_generator",
}


@pytest.mark.parametrize("module", ["core", "samplers.mcmc"])
def test_exported_names_match_jax(module):
    """Every name in the ``__all__`` of ``nfmc_tpu.core`` and
    ``nfmc_tpu.samplers.mcmc`` is in the port's module and its
    ``__all__``, but for NOT_PORTED's divergences, which the port lacks."""
    import importlib

    jax_mod = importlib.import_module("nfmc_tpu." + module)
    port = importlib.import_module("nfmc_torch." + module)
    wanted = [n for n in jax_mod.__all__ if n not in NOT_PORTED]
    assert [n for n in wanted if not hasattr(port, n) or n not in port.__all__] == []
    assert [n for n in NOT_PORTED if hasattr(port, n)] == []


def _strategy_kwargs(strategy):
    kw = {"flow": 'realnvp%{"n_layers": 2, "hidden_size": 8}'}
    if strategy in ("ess", "jump_ess", "tess", "dlmc"):
        kw["negative_log_likelihood"] = "target"
    return kw


@pytest.mark.parametrize("strategy", nfmc_torch.api.registry.PORTED_STRATEGIES)
def test_metropolis_sampler_bases_match_jax(strategy):
    """For each strategy of the registry, the sampler ``create_sampler``
    builds and the sampler it holds (a jump, NeuTra or PT sampler's inner
    one) are ``MetropolisSampler``s in the port exactly where they are in
    the JAX package."""
    from nfmc_torch.core.chains import sampler_tree
    from nfmc_torch.samplers.mcmc import MetropolisSampler
    from nfmc_tpu.potentials import StandardGaussian as JStandardGaussian
    from nfmc_tpu.samplers.mcmc import MetropolisSampler as JMetropolisSampler

    def built(pkg, target, **extra):
        kw = _strategy_kwargs(strategy)
        if "negative_log_likelihood" in kw:
            kw["negative_log_likelihood"] = target
        return pkg.create_sampler(target, strategy=strategy, **kw, **extra)

    jax_sampler = built(nfmc_tpu, JStandardGaussian((3,)))
    port = sampler_tree(built(nfmc_torch, StandardGaussian((3,)), device="cpu"))
    jax_tree = [jax_sampler] + [getattr(jax_sampler, a) for a in ("inner_sampler", "sampler")
                                if hasattr(jax_sampler, a)]
    assert [type(s).__name__ for s in port] == [type(s).__name__ for s in jax_tree]
    assert ([isinstance(s, MetropolisSampler) for s in port]
            == [isinstance(s, JMetropolisSampler) for s in jax_tree])

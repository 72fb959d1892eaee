"""Places where the port once refused or lacked what the JAX package
computes, checked on the CPU against nfmc_tpu with the same numpy inputs:

* the streaming expectations' ``update``, ``reset``, ``as_tensor`` and the
  ``data_transform`` of ``MCMCExpectationDict`` and ``MCMCStatistics``;
* coupling flows whose conditioners have another depth than 2 hidden
  layers, which run the plain stack (the reference's XLA path);
* strided rows (a column slice) handed to a flow.

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
    before = cops._leaves(flow.params)[0].clone()
    flow.fit(x, n_epochs=2, batch_size=16, early_stopping=False, seed=0)
    assert not torch.equal(cops._leaves(flow.params)[0], before)
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

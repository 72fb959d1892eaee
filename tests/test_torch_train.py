"""Flow training in nfmc_torch against nfmc_tpu on the CPU: the loss
gradient, ``fit`` and ``make_scan_fit`` from the same perturbed weights on
the same data (for RealNVP and both coupling spline flows), the masked
skip of a non-finite batch and the divergence contract.

Tolerances: the loss gradient to 1e-5 relative (float32, the same sums in
another order); a fit to 1e-4, since a few dozen Adam steps divide by
sqrt(v) + 1e-8 and so carry rounding differences forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch.flows.train as ttrain
import nfmc_tpu.flows.train as jtrain
from nfmc_tpu.flows import CouplingLRS as JCouplingLRS
from nfmc_tpu.flows import CouplingRQNSF as JCouplingRQNSF
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_torch.flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP, from_jax_params
from nfmc_torch.ops import coupling as ops

D = 6
FLOWS = {"RealNVP": (JRealNVP, RealNVP), "CouplingRQNSF": (JCouplingRQNSF, CouplingRQNSF),
         "CouplingLRS": (JCouplingLRS, CouplingLRS)}


def _pair(seed=0, flow="RealNVP"):
    jcls, tcls = FLOWS[flow]
    jflow = JFlow(jcls((D,), n_layers=3, hidden_size=16, use_pallas=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    tflow = Flow(tcls((D,), n_layers=3, hidden_size=16))
    tflow.params = from_jax_params(jflow.params)
    return jflow, tflow


def _data(n, seed=2):
    rng = np.random.default_rng(seed)
    return (1.3 * rng.standard_normal((n, D)) + 0.5).astype(np.float32)


def _assert_params_close(jparams, params, tol):
    for l, p in enumerate(params):
        for k in ("w", "b"):
            for got, want in zip(p[k], jparams[l][k]):
                assert float(np.max(np.abs(got.detach().numpy() - np.asarray(want)))) <= tol


@pytest.mark.parametrize("flow_name", list(FLOWS))
def test_loss_gradient_matches_jax(flow_name):
    """The weighted MLE loss (a padded batch: two rows of weight 0)."""
    jflow, flow = _pair(flow=flow_name)
    x = _data(10)
    w = np.ones(10, np.float32)
    w[-2:] = 0.0

    def jloss(p):
        lp = jflow.log_prob_fn(p, jnp.asarray(x))
        return -jnp.sum(lp * w) / jnp.maximum(jnp.sum(w), 1.0)

    jg = jax.grad(jloss)(jflow.params)
    theta = ttrain._flatten(flow.params).requires_grad_(True)
    loss = ttrain._nll(flow, ops.unpack_like(theta, flow.params), torch.from_numpy(x),
                       torch.from_numpy(w))
    (g,) = torch.autograd.grad(loss, theta)
    want = ttrain._flatten(from_jax_params(jg))
    assert float((g - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    assert float(loss.detach()) == pytest.approx(float(jloss(jflow.params)), rel=1e-5)


class _RecordingNumpy:
    """numpy, except that ``isfinite`` records the 1-d arrays it is given:
    both packages test each block's per-epoch validation losses with it."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def isfinite(self, a):
        if np.ndim(a) == 1:
            self.seen.append(np.array(a))
        return np.isfinite(a)


@pytest.mark.parametrize(
    "flow_name,with_val", [(f, v) for f in FLOWS for v in (True, False)],
    ids=[str(v) if f == "RealNVP" else f"{f}-{v}" for f in FLOWS for v in (True, False)])
def test_fit_matches_jax(monkeypatch, flow_name, with_val):
    """70 rows at batch 16 (the last batch padded with weight-0 rows), 3
    epochs, no shuffle: the per-epoch validation losses and the final
    parameters agree.

    Adam's first step moves every weight by about lr * sign(g), so a weight
    whose first gradient is zero to within rounding moves by +-lr in
    either package at random. With the spline flows' seed-0 weights one
    gradient of the first batch sums to -4e-9 here and 2e-7 in JAX (the
    largest is 2.5), so they start from seed 2, where none does."""
    jflow, flow = _pair(seed=0 if flow_name == "RealNVP" else 2, flow=flow_name)
    x_train, x_val = _data(70), (_data(30, seed=3) if with_val else None)
    kw = dict(shuffle=False, batch_size=16, n_epochs=3, early_stopping=False)
    jrec, trec = _RecordingNumpy(), _RecordingNumpy()
    monkeypatch.setattr(jtrain, "np", jrec)
    monkeypatch.setattr(ttrain, "np", trec)
    jflow.fit(x_train, x_val=x_val, seed=0, **kw)
    flow.fit(x_train, x_val=x_val, seed=0, **kw)
    assert len(trec.seen) == len(jrec.seen) == 1 and trec.seen[0].shape == (3,)
    np.testing.assert_allclose(trec.seen[0], jrec.seen[0], rtol=0, atol=1e-4)
    assert trec.seen[0][-1] < trec.seen[0][0]  # it trained
    _assert_params_close(jflow.params, flow.params, 1e-4)


def test_scan_fit_matches_jax():
    jflow, flow = _pair(seed=5)
    data = _data(48, seed=6)
    kw = dict(n_epochs=3, batch_size=16, shuffle=False, keep_best_weights=False)
    jparams = jtrain.make_scan_fit(jflow, 48, **kw)(jflow.params, jnp.asarray(data),
                                                  jax.random.key(0))
    params = ttrain.make_scan_fit(flow, 48, **kw)(flow.params, torch.from_numpy(data),
                                                torch.Generator().manual_seed(0))
    _assert_params_close(jparams, params, 1e-4)


def test_scan_fit_with_split_trains_and_keeps_shapes():
    _, flow = _pair(seed=7)
    data = torch.from_numpy(_data(60, seed=8))
    fit = ttrain.make_scan_fit(flow, 60, n_epochs=4, keep_best_weights=True, train_pct=0.7)
    params = fit(flow.params, data, torch.Generator().manual_seed(1))
    before = ttrain._flatten(flow.params)
    after = ttrain._flatten(params)
    assert after.shape == before.shape and torch.isfinite(after).all()
    assert not torch.equal(after, before)
    with torch.no_grad():
        assert float(ttrain._nll(flow, params, data)) < float(ttrain._nll(flow, flow.params, data))


def test_non_finite_batch_changes_nothing():
    _, flow = _pair()
    theta = ttrain._flatten(flow.params)
    adam = ttrain._Adam(theta, 5e-3)
    xb = torch.from_numpy(_data(8))
    theta, _ = ttrain._train_step(flow, flow.params, theta, adam, xb, None)  # one good step
    state = (theta.clone(), adam.mu.clone(), adam.nu.clone(), adam.count.clone())
    bad = xb.clone()
    bad[3, 2] = float("nan")
    theta2, loss = ttrain._train_step(flow, flow.params, theta, adam, bad, None)
    assert not torch.isfinite(loss)
    for got, want in zip((theta2, adam.mu, adam.nu, adam.count), state):
        assert torch.equal(got, want)
    assert float(adam.count) == 1.0


def test_divergent_fit_raises_value_error():
    f = Flow(RealNVP((3,), n_layers=2, hidden_size=16), seed=0)
    with pytest.raises(ValueError, match="diverged"):
        f.fit(np.full((64, 3), 1e30, dtype=np.float32), n_epochs=5, check_for_divergences=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        f.fit(_data(8)[:, :3], mesh=object())

"""The continuous flows (FFJORD, RNODE, OT-Flow, DDB) in nfmc_torch against
nfmc_tpu on the CPU.

Each flow is built by name in both packages at d = 6 (hidden 16, 4 steps);
the JAX weights, moved 0.1 N(0, 1) from the init, are carried over with
``from_jax_params``. At d = 6 both take the exact path (the discrete
integrator map, its per-step ``slogdet`` and the Picard inverse); with
``exact_trace_dim = 0`` both take the trace path, with the same probes
injected into both packages. Tolerances, of ``max(1, max|reference|)``:
1e-5 for the closed-form directions (the forward maps and the trace path
both ways), 2e-5 for the Picard inverse (a solve)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch.flows.continuous as tcont
import nfmc_tpu.flows.continuous as jcont
from nfmc_torch.api import registry as treg
from nfmc_torch.flows import FFJORD, RNODE, Flow, from_jax_params
from nfmc_torch.utils import tree_leaves, tree_map
from nfmc_tpu.api import registry as jreg

D = 6
NAMES = ("ffjord", "rnode", "ot-flow", "ddb")
KW = {"hidden_size": 16, "n_steps": 4}


def _pair(name, seed=3, scale=0.1, **kw):
    kw = {**KW, **kw}
    jflow = jreg.create_flow_object(name, (D,), seed=seed, **kw)
    rng = np.random.default_rng(seed + 2)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(np.shape(p)).astype(np.float32), jflow.params)
    flow = treg.create_flow_object(name, (D,), seed=0, **kw)
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _x(n=8, seed=2):
    return (1.2 * np.random.default_rng(seed).standard_normal((n, D))).astype(np.float32)


def _close(want, got, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(want - got.detach().numpy())))
    assert err <= tol * scale, (err, tol * scale)


def _both_ways(jflow, flow, x, tol_fwd, tol_inv):
    jz, jld = jax.jit(jflow.bijection.forward_fn)(jflow.params, jnp.asarray(x))
    jx, jld_inv = jax.jit(jflow.bijection.inverse_fn)(jflow.params, jz)
    z, ld = flow.bijection.forward_fn(flow.params, torch.from_numpy(x))
    x_back, ld_inv = flow.bijection.inverse_fn(flow.params, torch.from_numpy(np.array(jz)))
    for want, got, tol in ((jz, z, tol_fwd), (jld, ld, tol_fwd), (jx, x_back, tol_inv),
                           (jld_inv, ld_inv, tol_inv)):
        _close(want, got, tol)
    return z, ld


@pytest.mark.parametrize("name", NAMES)
def test_exact_path_matches_jax(name):
    """The discrete integrator map, its slogdet and the Picard inverse at
    the same weights; the round trip closes and the log-dets cancel."""
    jflow, flow = _pair(name)
    x = _x()
    z, ld = _both_ways(jflow, flow, x, 1e-5, 2e-5)
    x_rt, ld_rt = flow.bijection.inverse_fn(flow.params, z)
    assert float((x_rt - torch.from_numpy(x)).abs().max()) <= 1e-4
    assert float((ld_rt + ld).abs().max()) <= 1e-4


@pytest.fixture()
def same_probes(monkeypatch):
    """The same Rademacher probes in both packages: a function of the row's
    size and the probe count alone."""
    def probes(d, n):
        return np.random.default_rng(100 * d + n).choice([-1.0, 1.0], size=(n, d)).astype(
            np.float32)

    monkeypatch.setattr(jcont, "hutchinson_probes", lambda v, n, base_key=None, dtype=None:
                        jnp.asarray(probes(v.shape[-1], n)))
    monkeypatch.setattr(tcont, "hutchinson_probes", lambda v, n, key=None: torch.from_numpy(
        probes(v.shape[-1], n)).to(v.dtype).expand(*v.shape[:-1], n, v.shape[-1]))


@pytest.mark.parametrize("name", NAMES)
def test_trace_path_matches_jax_with_the_same_probes(same_probes, name):
    """Above ``exact_trace_dim`` (here 0) both integrate Hutchinson's trace
    (OT-Flow's as HVPs of its potential) and run the dynamics backward."""
    jflow, flow = _pair(name, exact_trace_dim=0)
    _both_ways(jflow, flow, _x(), 1e-5, 1e-5)


def test_trace_fallback_log_det_sign():
    """``tests/test_flow_zoo.py:112``: the trace path's log-det matches the
    exact path's (a sign flip once negated every large-d CNF density), in
    both directions; 64 probes, weights 0.02 from the init."""
    exact = FFJORD((D,), hidden_size=16, n_steps=6)
    fallback = FFJORD((D,), hidden_size=16, n_steps=6, exact_trace_dim=0, n_probes=64)
    g = torch.Generator().manual_seed(5)
    params = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=g),
                      Flow(exact, seed=3).params)
    x = torch.from_numpy(_x(4))
    z_e, ld_e = exact.forward_fn(params, x)
    z_h, ld_h = fallback.forward_fn(params, x)
    assert float((z_e - z_h).abs().max()) <= 1e-4
    assert float((ld_e - ld_h).abs().max()) <= 5e-2, (ld_e, ld_h)
    _, ld_ih = fallback.inverse_fn(params, z_h)
    assert float((ld_ih + ld_h).abs().max()) <= 5e-2


@pytest.mark.parametrize("name", NAMES)
def test_log_det_is_the_jacobian_of_the_discrete_map(name):
    """On the exact path the forward log-det is slogdet of the map's
    Jacobian (float64, so the check is of the math alone)."""
    _, flow = _pair(name, seed=4)
    params = tree_map(lambda t: t.double(), flow.params)
    x = torch.from_numpy(_x(2, seed=6)).double()
    _, ld = flow.bijection.forward_fn(params, x)
    for i in range(2):
        J = torch.autograd.functional.jacobian(
            lambda v: flow.bijection.forward_fn(params, v[None])[0][0], x[i])
        assert abs(float(torch.linalg.slogdet(J)[1] - ld[i])) <= 1e-9


def test_picard_masks_unconverged_rows_to_nan():
    """Stiff dynamics (weights 0.5 N(0, 1) from the init, 2 steps) leave
    Picard unconverged on 5 of these 16 rows: those rows come back NaN in
    both packages, the others finite and equal, and nothing raises."""
    jflow, flow = _pair("ffjord", scale=0.5, n_steps=2)
    z = (3.0 * np.random.default_rng(0).standard_normal((16, D))).astype(np.float32)
    jx, jld = jax.jit(jflow.bijection.inverse_fn)(jflow.params, jnp.asarray(z))
    x, ld = flow.bijection.inverse_fn(flow.params, torch.from_numpy(z))
    bad = np.isnan(np.asarray(jx)).any(-1)
    assert 0 < bad.sum() < len(bad)
    np.testing.assert_array_equal(torch.isnan(x).any(-1).numpy(), bad)
    np.testing.assert_array_equal(torch.isnan(ld).numpy(), np.isnan(np.asarray(jld)))
    _close(np.asarray(jx)[~bad], x[torch.from_numpy(~bad)], 2e-5)


@pytest.mark.parametrize("name", ["rnode", "ot-flow"])
def test_kinetic_regularizer_matches_jax(name):
    jflow, flow = _pair(name)
    x = _x()
    want = jflow.bijection.regularization(jflow.params, jnp.asarray(x))
    got = flow.bijection.regularization(flow.params, torch.from_numpy(x))
    assert got.shape == (8,)
    _close(want, got, 1e-5)


def test_rnode_trains_differently_from_ffjord():
    """``tests/test_flow_zoo.py:215``: RNODE's kinetic term is live in
    ``fit``: the same data and seed give other weights than FFJORD's."""
    x = (2.0 * np.random.default_rng(0).standard_normal((64, 3))).astype(np.float32)

    def train(cls):
        f = Flow(cls((3,), hidden_size=8, n_hidden_layers=1, n_steps=2), seed=0)
        f.fit(x, n_epochs=3, batch_size=32, shuffle=False, seed=1)
        return tree_leaves(f.params)

    assert RNODE.regularization_weight == 0.01 and FFJORD.regularization_weight == 0
    assert max(float((a - b).abs().max()) for a, b in zip(train(FFJORD), train(RNODE))) > 1e-6


def test_otflow_fit_matches_jax():
    """OT-Flow's ``fit`` differentiates its log-det, the trace of the
    Hessian of its potential, so the Adam steps take gradients of
    gradients: the same steps on the same batches (70 rows at batch 16, 2
    epochs, no shuffle) give the same weights to 1e-4 in both packages."""
    jflow, flow = _pair("ot-flow", seed=5, n_steps=2)
    x_train = (1.3 * np.random.default_rng(3).standard_normal((70, D)) + 0.5).astype(np.float32)
    kw = dict(shuffle=False, batch_size=16, n_epochs=2, early_stopping=False)
    jflow.fit(x_train, seed=0, **kw)
    flow.fit(x_train, seed=0, **kw)
    diff = max(float((a - b.detach()).abs().max()) for a, b in
               zip(tree_leaves(from_jax_params(jflow.params)), tree_leaves(flow.params)))
    assert diff <= 1e-4
    moved = max(float(t.abs().max()) for t in tree_leaves(flow.params)[-2:])
    assert moved > 1e-3  # the zero-init output layer trained

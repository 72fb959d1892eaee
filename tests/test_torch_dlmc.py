"""DLMC in nfmc_torch against nfmc_tpu: the drift (both ``latent_updates``)
and the accept with the same weights and draws (1e-5), the accept's
guards, the counter contract, the fixed-effort path against the host path
(statistically, as the JAX package's own test does) and the front door."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.nfmc.dlmc import DLMC as JDLMC
from nfmc_tpu.samplers.nfmc.dlmc import DLMCKernel as JDLMCKernel
from nfmc_tpu.samplers.nfmc.dlmc import DLMCParameters as JDLMCParameters
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.nfmc import DLMC, DLMCKernel, DLMCParameters

D, C = 5, 12
TOL = 1e-5


def _pair(latent_updates=False, pert=0.1):
    jflow = JFlow(JRealNVP((D,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    rng = np.random.default_rng(1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + pert * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    mu, sigma = np.full(D, 0.4, np.float32), np.float32(0.8)
    jt, tt = JDiagonalGaussian(mu, sigma), DiagonalGaussian(mu, sigma)
    js = JDLMC((D,), jt, jt, kernel=JDLMCKernel((D,), flow=jflow, step_size=0.1),
               params=JDLMCParameters(latent_updates=latent_updates))
    ts = DLMC((D,), tt, tt, kernel=DLMCKernel((D,), flow=flow, step_size=0.1),
              params=DLMCParameters(latent_updates=latent_updates), device="cpu")
    return js, ts


@pytest.mark.parametrize("latent_updates", [False, True])
def test_drift_and_accept_match_jax(latent_updates):
    """The drift, then the accept against the flow proposals the JAX key
    gives (its base draws and log-uniforms injected into the port)."""
    js, ts = _pair(latent_updates)
    j_drift, j_accept = js._make_drift_accept(C)
    t_drift, t_accept = ts._make_drift_accept()
    x0 = (0.4 + 1.3 * np.random.default_rng(2).standard_normal((C, D))).astype(np.float32)
    jparams, tparams = js.kernel.flow.params, ts.kernel.flow.params
    jx = j_drift(jparams, jnp.asarray(x0))
    with torch.no_grad():
        tx = t_drift(tparams, torch.from_numpy(x0))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    assert not np.allclose(np.asarray(jx), x0)
    n_acc = 0
    for seed in range(3):
        key = jax.random.key(seed)
        k_prop, k_acc = jax.random.split(key)
        z = np.array(js.kernel.flow.sample_base_fn(k_prop, C))
        log_u = np.array(jnp.log(jax.random.uniform(k_acc, (C,))))
        jx_new, jmask, jdiv = j_accept(jparams, jx, key)
        with torch.no_grad():
            tx_new, tmask, tdiv = t_accept(tparams, tx, (torch.from_numpy(z),
                                                         torch.from_numpy(log_u)))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(tx_new.numpy(), np.asarray(jx_new), rtol=TOL, atol=TOL)
        assert int(tdiv) == int(jdiv) == 0
        n_acc += int(tmask.sum())
    assert 0 < n_acc < 3 * C


def test_accept_guards():
    """A NaN current potential is forced to move; a non-finite proposal is
    refused and flagged as a divergence."""
    def u(x):
        bad = torch.where(x[:, 0] > 50.0, torch.tensor(float("nan")), torch.zeros(()))
        return 0.5 * (x * x).sum(-1) + bad + torch.where(x[:, 1] > 50.0,
                                                         torch.tensor(float("inf")),
                                                         torch.zeros(()))
    t = CallablePotential(u, (D,))
    s = DLMC((D,), t, t, kernel=DLMCKernel((D,), flow=Flow(RealNVP((D,)), seed=0)), device="cpu")
    _, accept = s._make_drift_accept()
    x = torch.zeros(4, D)
    x[0, 0] = 100.0  # NaN potential: moves to any finite proposal
    z = torch.zeros(4, D)
    z[3, 1] = 100.0  # the identity flow proposes x' = z: U(x') = +inf for chain 3
    log_u = torch.full((4,), 10.0)  # no ratio passes on its own
    x_new, mask, div = accept(s.kernel.flow.params, x, (z, log_u))
    assert mask.tolist() == [True, False, False, False] and int(div) == 1
    assert torch.equal(x_new[0], z[0]) and torch.equal(x_new[3], x[3])


def test_counter_contract():
    """B calls and B gradients at the start, then 3B calls and B gradients
    an iteration (the JAX package's tests/test_statistics.py)."""
    _, ts = _pair()
    n = 3
    ts.params.n_iterations = n
    ts.params.flow_fit_kwargs = {"n_epochs": 1}
    out = ts.sample(torch.zeros(C, D), show_progress=False, seed=0)
    st = out.statistics
    assert st.n_target_calls == C + n * 3 * C
    assert st.n_target_gradient_calls == C + n * C
    assert st.n_attempted_trajectories == n * C
    assert out.samples.shape == (n, C, D) and torch.isfinite(out.samples).all()
    # the continuation skips the start's gradient step
    cont = ts.sample_continue(out.samples[-1], show_progress=False, seed=1)
    assert cont.statistics.n_target_calls == n * 3 * C


def test_fixed_effort_path_matches_host_path():
    """The fused refit path against the host loop (``Flow.fit`` with the
    same epochs, its early stopping out of reach): the same counters, and
    moments that agree statistically (the JAX package's tolerances,
    tests/test_samplers.py)."""
    d, c, n_iter = 5, 128, 25
    x0 = torch.randn((c, d), generator=torch.Generator().manual_seed(1))

    def run(fit_kwargs):
        t = StandardGaussian((d,))
        s = DLMC((d,), t, t, kernel=DLMCKernel((d,), flow=Flow(RealNVP((d,), n_layers=2,
                                                                        hidden_size=16), seed=0)),
                 params=DLMCParameters(n_iterations=n_iter, flow_fit_kwargs=fit_kwargs),
                 device="cpu")
        return s.sample(x0, show_progress=False, seed=0)

    fused = run({"n_epochs": 4, "lr": 5e-3})
    host = run({"n_epochs": 4, "lr": 5e-3, "early_stopping": True,
                "early_stopping_threshold": 100, "show_progress": False})
    for out in (fused, host):
        assert out.samples.shape == (n_iter, c, d) and torch.isfinite(out.samples).all()
    a, b = fused.statistics, host.statistics
    assert (a.n_target_calls, a.n_target_gradient_calls, a.n_divergences) == \
        (b.n_target_calls, b.n_target_gradient_calls, b.n_divergences)
    assert float(np.max(np.abs(fused.mean - host.mean))) < 0.15
    assert float(np.max(np.abs(fused.variance - host.variance))) < 0.4


def test_front_door_dlmc():
    t = StandardGaussian((D,))
    with pytest.raises(ValueError, match="Negative log likelihood"):
        nfmc_torch.sample(t, strategy="dlmc", device="cpu", show_progress=False)
    out = nfmc_torch.sample(t, strategy="dlmc", negative_log_likelihood=t, n_chains=C,
                            n_iterations=3, flow='realnvp%{"n_layers": 2, "hidden_size": 8}',
                            param_kwargs={"flow_fit_kwargs": {"n_epochs": 2}}, warmup=True,
                            device="cpu", seed=0, show_progress=False)
    assert out.samples.shape == (3, C, D) and torch.isfinite(out.samples).all()
    assert out.statistics.n_target_calls == C + 3 * 3 * C

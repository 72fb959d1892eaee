"""TESS in nfmc_torch against nfmc_tpu: ``tess_step`` with the same
injected ``(z, w, theta0, shrink)`` and weights, with the identity and with
a non-identity ``cov`` (1e-5), the counters of both warmup routes and of a
run, and a whole run against the JAX package's by the chain-permutation
two-sample test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.nfmc.tess import TESS as JTESS
from nfmc_tpu.samplers.nfmc.tess import TESSKernel as JTESSKernel
from nfmc_tpu.samplers.nfmc.tess import make_tess_step as j_make_tess_step
from nfmc_tpu.validation import mcmc_two_sample_report
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.potentials import DiagonalGaussian
from nfmc_torch.samplers.nfmc import TESS, TESSKernel, TESSParameters, make_tess_step

D, C, MAX_ITER = 5, 16, 5
TOL = 1e-5


def _flows(pert=0.1, seed=0, d=D):
    jflow = JFlow(JRealNVP((d,), n_layers=2, hidden_size=16, use_pallas=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + pert * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(RealNVP((d,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _targets(d=D, mu=0.8, sigma=0.7):
    mu, sigma = np.full(d, mu, np.float32), np.float32(sigma)
    return JDiagonalGaussian(mu, sigma), DiagonalGaussian(mu, sigma)


def _cov(d=D):
    a = np.random.default_rng(9).standard_normal((d, d)).astype(np.float32)
    return (0.3 * a @ a.T + np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("with_cov", [False, True])
def test_tess_step_matches_jax_with_injected_draws(with_cov):
    """Three steps from the same latent state: the data-space and latent
    states, their log pi^ and the accept masks within 1e-5; the draws make
    some chains accept a later bracket point and some none."""
    jflow, flow = _flows()
    jt, tt = _targets()
    cov = _cov() if with_cov else None
    jchol = JTESSKernel((D,), flow=jflow, cov=cov).chol()
    tchol = TESSKernel((D,), flow=flow, cov=cov).chol()
    if with_cov:
        np.testing.assert_allclose(tchol.numpy(), np.asarray(jchol), rtol=TOL, atol=TOL)
    j_init, j_step, _ = j_make_tess_step(jflow, jt, (D,), MAX_ITER, chol=jchol)
    t_init, t_step, t_draws = make_tess_step(flow, tt, (D,), MAX_ITER, chol=tchol)
    rng = np.random.default_rng(1)
    u0 = (1.5 * rng.standard_normal((C, D))).astype(np.float32)
    ju, tu = jnp.asarray(u0), torch.from_numpy(u0)
    jlp, jx = j_init(jflow.params, ju)
    tlp, tx = t_init(flow.params, tu)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)
    shapes = [tuple(a.shape) for a in t_draws(torch.Generator().manual_seed(0), (), C)]
    assert shapes == [(C, D), (C,), (C, 1), (MAX_ITER, C, 1)]
    n_acc, n_late = 0, 0
    for _ in range(3):
        draws = (rng.standard_normal((C, D)).astype(np.float32), rng.random(C).astype(np.float32),
                 rng.standard_normal((C, 1)).astype(np.float32),
                 rng.random((MAX_ITER, C, 1)).astype(np.float32))
        v = draws[0] if tchol is None else draws[0] @ tchol.numpy().T
        theta = draws[2] * 2 * np.pi
        first = tu.numpy() * np.cos(theta) + v * np.sin(theta)  # the bracket's first point
        jx, ju, jlp, jacc = j_step(jflow.params, ju, jlp, jx, None,
                                   draws=tuple(jnp.asarray(a) for a in draws))
        with torch.no_grad():
            tx, tu, tlp, tacc = t_step(flow.params, tu, tlp, tx,
                                       tuple(torch.from_numpy(a) for a in draws))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        for got, want in ((tx, jx), (tu, ju), (tlp, jlp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        n_acc += int(tacc.sum())
        n_late += int((tacc.numpy() & ~np.all(np.abs(tu.numpy() - first) < 1e-6, -1)).sum())
    # some chains accept a later bracket point, some find none
    assert 0 < n_late and n_acc < 3 * C


def test_sample_counters_and_laws():
    """(max_iter + 1) C target calls an iteration and no gradient call;
    the stored draws are data-space, the start is latent."""
    _, flow = _flows()
    n = 7
    s = TESS((D,), _targets()[1], _targets()[1], kernel=TESSKernel((D,), flow=flow),
             params=TESSParameters(n_iterations=n), device="cpu")
    u0 = torch.randn((C, D), generator=torch.Generator().manual_seed(0))
    out = s.sample(u0, show_progress=False, seed=0)
    st = out.statistics
    assert out.samples.shape == (n, C, D) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == n * (MAX_ITER + 1) * C and st.n_target_gradient_calls == 0
    assert st.n_attempted_trajectories == n * C and 0 < st.n_accepted_trajectories <= n * C
    np.testing.assert_allclose(out.mean, out.samples.double().mean((0, 1)).numpy(), atol=1e-5)
    # continuing from a stored (data-space) draw maps it back to the latent
    s.params.n_iterations = 2
    cont = s.sample_continue(out.samples[-1], show_progress=False, seed=1)
    assert cont.samples.shape == (2, C, D)


@pytest.mark.parametrize("route,fit_kwargs", [
    ("fused", {"n_epochs": 2, "lr": 5e-3}),
    ("host", {"n_epochs": 2, "early_stopping": True, "show_progress": False})])
def test_warmup_routes(route, fit_kwargs):
    """Both warmup routes: latent draws ``(n_warmup, C, *event)``, the
    counters, a refitted flow."""
    _, flow = _flows(pert=0.0)
    before = [t.clone() for p in flow.params for v in p.values() for t in v]
    n_warm = 4
    s = TESS((D,), _targets()[1], _targets()[1], kernel=TESSKernel((D,), flow=flow),
             params=TESSParameters(n_warmup_iterations=n_warm, flow_fit_kwargs=fit_kwargs),
             device="cpu")
    out = s.warmup(torch.zeros(C, D), show_progress=False, seed=0)
    st = out.statistics
    assert out.samples.shape == (n_warm, C, D) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == n_warm * (MAX_ITER + 1) * C and st.n_attempted_trajectories == n_warm * C
    after = [t for p in flow.params for v in p.values() for t in v]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_front_door_tess_needs_a_likelihood():
    _, t = _targets()
    with pytest.raises(ValueError, match="Negative log likelihood"):
        nfmc_torch.sample(t, strategy="tess", device="cpu", show_progress=False)
    out = nfmc_torch.sample(t, strategy="tess", negative_log_likelihood=t, n_chains=C,
                            n_iterations=3, flow='realnvp%{"n_layers": 2, "hidden_size": 8}',
                            device="cpu", seed=0, show_progress=False)
    assert out.samples.shape == (3, C, D)
    assert out.statistics.n_target_calls == 3 * (MAX_ITER + 1) * C


def test_tess_run_matches_jax_two_sample():
    """Both packages run TESS with the same frozen perturbed flow on a
    misfit target, each with its own random stream: the data-space draws
    pass the chain-permutation two-sample test and the acceptances agree."""
    d, c, n_iter = 4, 32, 300
    jflow, flow = _flows(pert=0.05, seed=3, d=d)
    jt, tt = _targets(d, mu=0.5, sigma=1.2)
    u0 = np.random.default_rng(0).standard_normal((c, d)).astype(np.float32)
    js = JTESS((d,), jt, jt, kernel=JTESSKernel((d,), flow=jflow))
    js.params.n_iterations = n_iter
    jout = js.sample(jnp.asarray(u0), show_progress=False, seed=0)
    ts = TESS((d,), tt, tt, kernel=TESSKernel((d,), flow=flow),
              params=TESSParameters(n_iterations=n_iter), device="cpu")
    tout = ts.sample(torch.from_numpy(u0), show_progress=False, seed=0)
    report = mcmc_two_sample_report(np.asarray(jout.samples), tout.samples.numpy(),
                                    rng=np.random.default_rng(1))
    assert report["ok"], report
    j_rate, t_rate = jout.statistics.acceptance_rate, tout.statistics.acceptance_rate
    assert abs(t_rate - j_rate) < 0.03, (t_rate, j_rate)

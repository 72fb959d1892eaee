"""Elliptical slice sampling of nfmc_torch against nfmc_tpu's with the same
injected draws: the step (identity and Cholesky ellipses) with its
first-accept-wins masks and the all-accept hack, to 1e-5; the ellipse
adaptation, diagonal and dense, with and without a base covariance (the
corrected nll to 1e-5); ``sample``'s prior redraw and ``sample_continue``;
the counters ((max_iter + 1) B calls, no gradient); the front door."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.samplers.mcmc.ess import ESS as JESS
from nfmc_tpu.samplers.mcmc.ess import ESSKernel as JESSKernel
from nfmc_tpu.samplers.mcmc.ess import elliptical_slice_sampling_step as j_ess_step
from nfmc_torch.potentials import CallablePotential, StandardGaussian
from nfmc_torch.samplers.mcmc import ESS, ESSKernel, ESSParameters
from nfmc_torch.samplers.mcmc.ess import elliptical_slice_sampling_step

TOL = 1e-5
D, C = 5, 9
SIG = np.linspace(0.4, 0.9, D).astype(np.float32)


def _residual():
    """The likelihood that turns the N(0, I) prior into N(0, diag(SIG^2))
    (``tools/run_reference.py``'s "residual")."""
    def jax_nll(x):
        return 0.5 * jnp.sum((x / SIG) ** 2 - x ** 2, -1)

    def torch_nll(x):
        s = torch.from_numpy(SIG)
        return 0.5 * ((x / s) ** 2 - x ** 2).sum(-1)

    return jax_nll, CallablePotential(torch_nll, (D,))


def _draws(rng, use_chol, max_iter=5):
    z = rng.standard_normal((C, D)).astype(np.float32)
    u = rng.random(C).astype(np.float32)
    theta0 = rng.random((C, 1)).astype(np.float32)
    shrink = rng.random((max_iter, C, 1)).astype(np.float32)
    return z, u, theta0, shrink


def _cov(rng):
    a = rng.standard_normal((D, D))
    return (a @ a.T / D + 0.5 * np.eye(D)).astype(np.float32)


@pytest.mark.parametrize("use_cov", [False, True])
def test_ess_step_matches_jax(use_cov):
    """Six carried-likelihood steps of both samplers: states, the carried
    nll, accept counts; and the bare step's first-accept-wins masks."""
    jax_nll, torch_nll = _residual()
    rng = np.random.default_rng(0)
    cov = _cov(rng) if use_cov else None
    js = JESS((D,), None, jax_nll, JESSKernel((D,), cov=cov))
    ts = ESS((D,), None, torch_nll, ESSKernel((D,), cov=cov), device="cpu")
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    jstep, tstep = js._make_step_aux(False), ts._make_step_aux(False)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jst = js._augment_state(js.kernel.make_state(), jx)
    tst = ts._augment_state(ts.kernel.make_state("cpu"), tx)
    n_partial = 0
    for _ in range(6):
        d = _draws(rng, use_cov)
        # the bare step: which chains accepted at all
        _, _, jacc = j_ess_step(jx, jax_nll, (D,), None, chol=jst[0].chol,
                                nll_f=jst[1], draws=tuple(jnp.asarray(a) for a in d))
        _, _, tacc = elliptical_slice_sampling_step(tx, torch_nll, (D,),
                                                    tuple(torch.from_numpy(a) for a in d),
                                                    chol=tst[0].chol, nll_f=tst[1])
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        n_partial += int((~tacc).sum())
        jx, jst, jinfo = jstep(jx, jst, None, tuple(jnp.asarray(a) for a in d))
        tx, tst, tinfo = tstep(tx, tst, tuple(torch.from_numpy(a) for a in d))
        assert float(np.max(np.abs(tx.numpy() - np.asarray(jx)))) <= TOL
        np.testing.assert_allclose(tst[1].numpy(), np.asarray(jst[1]), rtol=TOL, atol=TOL)
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted) == C  # mask = ones
        assert int(tinfo.diverged) == int(jinfo.diverged) == 0
    if use_cov:
        np.testing.assert_allclose(tst[0].chol.numpy(), np.asarray(jst[0].chol), rtol=1e-5,
                                   atol=1e-6)
    assert ts.calls_per_iter(C) == 6 * C and ts.grads_per_iter(C) == 0


def test_non_finite_proposal_keeps_the_state():
    """The all-accept hack refuses only a non-finite state, and flags it: a
    flat likelihood takes every first point, one of them infinite."""
    nll = CallablePotential(lambda x: torch.zeros(x.shape[0]), (D,))
    ts = ESS((D,), None, nll, device="cpu")
    x = torch.zeros(C, D)
    d = [torch.from_numpy(a) for a in _draws(np.random.default_rng(1), False)]
    d[0][0, 0] = float("inf")  # chain 0's ellipse leaves the finite range
    x1, _, info = ts._make_step_aux(False)(x, ts._augment_state(ts.kernel.make_state("cpu"), x),
                                           tuple(d))
    assert torch.equal(x1[0], x[0]) and int(info.diverged) == 1 and int(info.n_accepted) == C - 1


@pytest.mark.parametrize("kind", ["diag", "dense"])
@pytest.mark.parametrize("base_cov", [False, True])
def test_ellipse_adaptation_matches_jax(kind, base_cov):
    """The corrected likelihood after the adaptation, on the same points, to
    1e-5 relative; the adapted covariance; and the resumable state replays
    it."""
    jax_nll, torch_nll = _residual()
    rng = np.random.default_rng(2)
    cov0 = _cov(rng) if base_cov else None
    js = JESS((D,), None, jax_nll, JESSKernel((D,), cov=cov0))
    ts = ESS((D,), None, torch_nll, ESSKernel((D,), cov=cov0), device="cpu")
    if kind == "diag":
        est = 0.2 + rng.random(D)
    else:
        a = rng.standard_normal((D, D))
        est = a @ a.T / D + 0.1 * np.eye(D)
    js._apply_ellipse_adaptation(est)
    ts._apply_ellipse_adaptation(est)
    x = (2 * rng.standard_normal((20, D))).astype(np.float32)
    want = np.asarray(js.negative_log_likelihood(jnp.asarray(x)))
    got = ts.negative_log_likelihood(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ts.kernel.cov, js.kernel.cov)
    fresh = ESS((D,), None, torch_nll, ESSKernel((D,), cov=cov0), device="cpu")
    fresh.restore_extra_resumable_state(ts.extra_resumable_state())
    assert torch.equal(fresh.negative_log_likelihood(torch.from_numpy(x)), torch.from_numpy(got))


@pytest.mark.parametrize("dense", [False, True])
def test_warmup_adapts_the_ellipse_and_keeps_the_law(dense):
    """The warmup returns its draws and re-centres the ellipse on their
    covariance; prior times corrected likelihood is the target's law up to a
    constant, so a run after it still recovers SIG."""
    _, torch_nll = _residual()
    ts = ESS((D,), None, torch_nll, params=ESSParameters(n_warmup_iterations=60,
                                                         n_iterations=300, dense_ellipse=dense),
             device="cpu")
    x0 = torch.randn((64, D), generator=torch.Generator().manual_seed(0))
    wout = ts.warmup(x0, show_progress=False, seed=0)
    assert wout.samples.shape == (60, 64, D) and ts.kernel.cov is not None
    cov = np.asarray(ts.kernel.cov)
    assert (cov.ndim == 2) and (np.count_nonzero(cov - np.diag(np.diag(cov))) > 0) == dense
    np.testing.assert_allclose(np.sqrt(np.diag(cov)), SIG, rtol=0.35)
    # log N(x; 0, S) - log N(x; 0, I) + the residual = -log N(x; 0, SIG^2) + const
    x = torch.randn((7, D), generator=torch.Generator().manual_seed(1))
    chol = np.linalg.cholesky(cov.astype(np.float64))
    ld = np.asarray(ts.negative_log_likelihood(x), np.float64)
    xs = x.numpy().astype(np.float64)
    lp_s = -0.5 * np.sum(np.linalg.solve(chol, xs.T) ** 2, 0) - np.log(np.diag(chol)).sum()
    want = 0.5 * np.sum((xs / SIG) ** 2, -1) + lp_s
    np.testing.assert_allclose(ld - ld[0], want - want[0], atol=1e-3)
    out = ts.sample(x0, show_progress=False, seed=1)
    np.testing.assert_allclose(np.sqrt(out.variance), SIG, rtol=0.2)


def test_sample_redraws_x0_and_sample_continue_keeps_it():
    """``sample`` starts from a prior redraw whatever ``x0``; with the same
    seed ``sample_continue`` from that redraw gives the same run."""
    _, torch_nll = _residual()
    rng = np.random.default_rng(3)
    cov = _cov(rng)
    ts = ESS((D,), None, torch_nll, ESSKernel((D,), cov=cov),
             ESSParameters(n_iterations=4), device="cpu")
    far = torch.full((C, D), 1e3)
    out = ts.sample(far, show_progress=False, seed=7)
    g = torch.Generator().manual_seed(7)
    prior = ts.resample_x0_fn(ts.resample_x0_draws(g, (), C), far)
    assert float(prior.abs().max()) < 20
    again = ts.sample_continue(prior, show_progress=False, seed=7)
    assert torch.equal(out.samples, again.samples)
    kept = ts.sample_continue(far, show_progress=False, seed=7)
    assert float(kept.samples[0].abs().max()) > 100  # the first ellipse passes through x0
    st = out.statistics
    assert st.n_target_calls == 4 * 6 * C and st.n_target_gradient_calls == 0


def test_ess_front_door():
    def run(strategy, **kw):
        return nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy,
                                 negative_log_likelihood=StandardGaussian((3,)), n_chains=6,
                                 n_iterations=5, device="cpu", seed=0, show_progress=False, **kw)

    out = run("ess")
    assert out.samples.shape == (5, 6, 3) and torch.isfinite(out.samples).all()
    assert torch.equal(out.samples, run("ess").samples)
    assert out.statistics.n_target_calls == 5 * 6 * 6
    with pytest.raises(ValueError, match="Negative log likelihood"):
        nfmc_torch.sample(StandardGaussian((3,)), strategy="ess", device="cpu",
                          show_progress=False)

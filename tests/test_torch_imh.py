"""IMH in nfmc_torch against nfmc_tpu: the accept core with injected
log-uniforms, the hoisted proposals and the reverse-KL fit on the same base
draws and weights, the adaptation schedule, the counter contract and its
quirk, the chunk paths against each other, the front door, and whole runs
(sigma recovery, a two-sample test against a JAX run). Sizes are small
(d <= 6, L <= 3, H <= 32); tolerances are stated where they are used."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.core.driver import hoisted_flow_proposals as j_hoisted
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.nfmc import AdaptiveIMH as JAdaptiveIMH
from nfmc_tpu.samplers.nfmc import FixedIMH as JFixedIMH
from nfmc_tpu.samplers.nfmc import IMHKernel as JIMHKernel
from nfmc_tpu.samplers.nfmc import imh as jimh
from nfmc_tpu.validation import mcmc_two_sample_report
from nfmc_torch.core.driver import hoisted_flow_proposals
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.flows import train as ttrain
from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.nfmc import (
    AdaptiveIMH,
    FixedIMH,
    IMHKernel,
    IMHParameters,
    imh as timh,
)

TOL = 1e-5


def _jflow(d, n_layers=2, hidden=16, seed=0, perturb=0.0):
    """A JAX flow, its weights moved ``perturb`` N(0, 1) off the identity
    init (numpy noise), and the port's flow with the same weights."""
    jf = JFlow(JRealNVP((d,), n_layers=n_layers, hidden_size=hidden), seed=seed)
    rng = np.random.default_rng(seed + 100)
    jf.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + perturb * rng.standard_normal(a.shape), jnp.float32),
        jf.params)
    tf = Flow(RealNVP((d,), n_layers=n_layers, hidden_size=hidden), seed=0)
    tf.params = from_jax_params(jax.tree_util.tree_map(np.asarray, jf.params))
    return jf, tf


def _imh(cls, d, target, flow, **params):
    return cls((d,), target, kernel=IMHKernel((d,), flow=flow), params=IMHParameters(**params),
               device="cpu")


def test_accept_core_matches_jax_with_injected_log_u():
    """Rows: plain; U(x) = +inf accepts; NaN U(x) and log q(x) = -inf are
    forced to move; U(x) = -inf stays; non-finite proposals (position, U,
    log q) are refused even from a bad current state; divergence flagged.
    Equal masks and states."""
    n, d = 9, 3
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    xp = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    inf, nan = np.inf, np.nan
    u_x = np.array([0.1, inf, nan, 0.0, -inf, 0.3, nan, 0.2, 1.0], np.float32)
    flp_x = np.array([0.0, 0.0, 0.0, -inf, 0.0, 0.1, 0.0, 0.0, -2.0], np.float32)
    u_p = np.array([0.5, 0.2, 0.1, 0.4, 0.0, inf, 0.3, 0.1, 0.9], np.float32)
    flp_p = np.array([-0.2, 0.0, 0.1, 0.0, 0.0, 0.0, nan, 0.0, -1.0], np.float32)
    xp[7, 1] = nan
    jcore = JFixedIMH((d,), JDiagonalGaussian(np.zeros(d), 1.0))._make_accept_core()
    tcore = _imh(FixedIMH, d, StandardGaussian((d,)), Flow(RealNVP((d,)), seed=0))._make_accept_core()
    for seed in range(3):
        k = jax.random.key(seed)
        log_u = np.array(jnp.log(jax.random.uniform(k, (n,))))
        want = jcore(*(jnp.asarray(a) for a in (x, flp_x, u_x, xp, flp_p, u_p)), k)
        got = tcore(*(torch.from_numpy(a) for a in (x, flp_x, u_x, xp, flp_p, u_p, log_u)))
        assert got[3].tolist() == np.asarray(want[3]).tolist()
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[4]) == int(want[4]) == 1
    mask = got[3].tolist()
    assert mask[1] and mask[2] and mask[3] and not mask[4]
    assert not (mask[5] or mask[6] or mask[7])


def test_hoisted_proposals_match_jax():
    """One batched inverse over chunk * C rows from the same base draws and
    weights: proposals, their log q and U within 1e-5."""
    d, chunk, c = 5, 4, 6
    jf, tf = _jflow(d, perturb=0.3)
    target_j = JDiagonalGaussian(np.full(d, 0.3), 1.3)
    target_t = DiagonalGaussian(np.full(d, 0.3, np.float32), np.float32(1.3))
    keys = jax.random.split(jax.random.key(4), chunk)
    want = j_hoisted(jf, jf.params, keys, c, (d,), target=target_j)
    z = jax.vmap(lambda k: jf.sample_base_fn(k, c))(keys)
    got = hoisted_flow_proposals(tf, tf.params, torch.from_numpy(np.array(z)), target=target_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def _neg_u(x):
    return -0.5 * (((x - 1.0) / 0.7) ** 2).sum(-1)


def test_variational_loss_and_gradient_match_jax():
    """The reverse-KL loss ``mean(-log p(x) - log_det_inv)`` at the same z
    and its gradient in every weight against jax.value_and_grad (1e-5
    relative to the largest)."""
    d, n = 4, 32
    jf, tf = _jflow(d, n_layers=3, perturb=0.2)
    z = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)

    def jloss(p):
        x, ldi = jf.bijection.inverse_fn(p, jnp.asarray(z))
        return jnp.mean(-_neg_u(x) - ldi)

    lw, gw = jax.value_and_grad(jloss)(jf.params)
    params = [{k: [t.clone().requires_grad_(True) for t in v] for k, v in p.items()}
              for p in tf.params]
    loss = ttrain._reverse_kl(tf, params, torch.from_numpy(z), _neg_u)
    grads = torch.autograd.grad(loss, [t for p in params for k in ("w", "b") for t in p[k]])
    assert float(loss.detach()) == pytest.approx(float(lw), rel=TOL)
    want = [np.asarray(t) for p in gw for k in ("w", "b") for t in p[k]]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("keep_best", [True, False])
def test_variational_fit_matches_jax_on_the_same_draws(keep_best):
    """Six Adam epochs with the JAX run's own base draws injected through
    ``base_draws``: the fitted weights within 1e-5 (1e-4 of the largest)."""
    d, n, n_epochs = 3, 16, 6
    jf, tf = _jflow(d, perturb=0.1)
    key = jax.random.key(7)
    jf.variational_fit(_neg_u, n_samples=n, n_epochs=n_epochs, lr=0.01, key=key,
                       keep_best_weights=keep_best)
    # the JAX fit's draws: one block of n_epochs keys split from key
    _, sub = jax.random.split(key)
    zs = [torch.from_numpy(np.array(jax.random.normal(k, (n, d))))
          for k in jax.random.split(sub, n_epochs)]
    it = iter(zs)
    tf.variational_fit(_neg_u, n_samples=n, n_epochs=n_epochs, lr=0.01, seed=0,
                       keep_best_weights=keep_best, base_draws=lambda g, m: next(it))
    want = [np.asarray(t) for p in jf.params for k in ("w", "b") for t in p[k]]
    got = [t.numpy() for p in tf.params for k in ("w", "b") for t in p[k]]
    scale = max(1.0, max(np.abs(w).max() for w in want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-4 * scale)


def test_variational_fit_moves_toward_target():
    def neg_u(x):
        return -0.5 * (((x - 3.0) / 0.7) ** 2).sum(-1)

    f = Flow(RealNVP((3,), n_layers=3, hidden_size=32), seed=2)
    f.variational_fit(neg_u, n_samples=64, n_epochs=200, lr=0.02, seed=0)
    s = f.sample(1024, seed=5).numpy()
    assert np.all(np.abs(s.mean(axis=0) - 3.0) < 0.5)
    assert np.all(np.abs(s.std(axis=0) - 0.7) < 0.4)


def test_variational_fit_survives_nan_epochs():
    """A non-finite step changes neither the weights nor Adam's moments: a
    target that is NaN outside a ball still trains to finite weights."""
    def neg_u(x):
        r2 = (((x - 1.0) / 0.3) ** 2).sum(-1)
        bad = torch.sqrt(3.2 ** 2 - (x ** 2).sum(-1))
        return -0.5 * r2 + 0.0 * bad

    f = Flow(RealNVP((3,), n_layers=3, hidden_size=32), seed=2)
    f.variational_fit(neg_u, n_samples=32, n_epochs=300, lr=0.02, keep_best_weights=False,
                      seed=0)
    assert all(torch.isfinite(t).all() for p in f.params for v in p.values() for t in v)
    assert torch.isfinite(f.sample(1024, seed=5)).all()


def test_variational_fit_stops_on_persistent_divergence_and_mesh_raises():
    f = Flow(RealNVP((3,), n_layers=2, hidden_size=8), seed=0)
    before = [t.clone() for p in f.params for v in p.values() for t in v]
    calls = []

    def draws(g, n):
        calls.append(n)
        return torch.randn((n, 3), generator=g)

    f.variational_fit(lambda x: x.sum(-1) * float("nan"), n_samples=8, n_epochs=300,
                      check_for_divergences=True, base_draws=draws, seed=0)
    # one block of 128 epochs, all non-finite: more than a block's worth
    # is only reached after the second block
    assert len(calls) == 256
    after = [t for p in f.params for v in p.values() for t in v]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    with pytest.raises(TypeError, match="DeviceMesh"):
        f.variational_fit(_neg_u, mesh=object())


@pytest.mark.parametrize("dist", ["uniform", "bounded_geom_approx", "bounded_geom"])
@pytest.mark.parametrize("offset", [0, 37])
def test_adaptation_schedule_is_bit_identical(dist, offset):
    j = JAdaptiveIMH((3,), JDiagonalGaussian(np.zeros(3), 1.0))
    j.params.train_distribution = dist
    t = _imh(AdaptiveIMH, 3, StandardGaussian((3,)), Flow(RealNVP((3,)), seed=0),
             train_distribution=dist, adaptation_dropoff=0.97)
    j.params.adaptation_dropoff = 0.97
    for start, chunk in ((0, 5), (5, 40), (45, 300)):
        want = j._adaptation_schedule(np.random.default_rng(start), start, chunk, offset=offset)
        got = t._adaptation_schedule(np.random.default_rng(start), start, chunk, offset=offset)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for max_val in (0, 1, 7, 250):
        assert timh.sample_bounded_geom(rng_a, 0.025, max_val) == jimh.sample_bounded_geom(
            rng_b, 0.025, max_val)


def test_parameters_defaults_and_check():
    p = IMHParameters()
    assert p.warmup_fit_kwargs == jimh.IMHParameters().warmup_fit_kwargs
    with pytest.raises(ValueError, match="bad train_distribution"):
        IMHParameters(train_distribution="geometric")


def _run(cls, n_iter=7, c=5, d=3, **params):
    s = _imh(cls, d, StandardGaussian((d,)), Flow(RealNVP((d,), n_layers=2, hidden_size=8),
                                                  seed=0), n_iterations=n_iter, **params)
    x0 = torch.randn((c, d), generator=torch.Generator().manual_seed(1))
    return s, s.sample(x0, show_progress=False, seed=2)


def test_counter_contract_and_quirk():
    """FixedIMH: 2 C target calls an iteration and 0 gradient calls;
    AdaptiveIMH counts the same 2 C evaluations as gradient calls, on both
    of its paths."""
    _, out = _run(FixedIMH)
    st = out.statistics
    assert (st.n_target_calls, st.n_target_gradient_calls) == (7 * 2 * 5, 0)
    assert st.n_attempted_trajectories == 7 * 5 and out.samples.shape == (7, 5, 3)
    for limit in (1 << 27, 0):
        s = _imh(AdaptiveIMH, 3, StandardGaussian((3,)), Flow(RealNVP((3,)), seed=0),
                 n_iterations=7)
        s.history_element_limit = limit
        st = s.sample(torch.zeros((5, 3)), show_progress=False, seed=2).statistics
        assert (st.n_target_calls, st.n_target_gradient_calls) == (0, 7 * 2 * 5)
        assert st.n_attempted_trajectories == 7 * 5


def test_fixed_imh_hoisted_matches_in_loop():
    """The chunk's proposals in one batched inverse or per iteration (the
    limit 0 forces it): the same draws give the same chain (1e-5)."""
    def run(limit):
        s = _imh(FixedIMH, 4, DiagonalGaussian(np.full(4, 0.4, np.float32), np.float32(1.3)),
                 _jflow(4, perturb=0.2)[1], n_iterations=8)
        s.rng_hoist_element_limit = limit
        return s.sample(torch.randn((8, 4), generator=torch.Generator().manual_seed(7)),
                        show_progress=False, seed=3)

    a, b = run(1 << 27), run(0)
    assert torch.allclose(a.samples, b.samples, atol=TOL)
    assert a.statistics.n_accepted_trajectories == b.statistics.n_accepted_trajectories
    assert 0 < a.statistics.acceptance_rate < 1


def test_adaptive_imh_fused_matches_host_path():
    """The fused path (history on the device, make_scan_fit refits) and the
    host loop (Flow.fit): the counters equal, the refits move the flow,
    and the moments agree statistically (other fit streams)."""
    d, c, n_iter = 5, 64, 30

    def build():
        s = _imh(AdaptiveIMH, d, StandardGaussian((d,)),
                 Flow(RealNVP((d,), n_layers=2, hidden_size=16), seed=0), n_iterations=n_iter)
        return s

    x0 = torch.randn((c, d), generator=torch.Generator().manual_seed(1))
    fused = build()
    before = [t.clone() for p in fused.kernel.flow.params for v in p.values() for t in v]
    out_f = fused.sample(x0, show_progress=False, seed=0)
    after = [t for p in fused.kernel.flow.params for v in p.values() for t in v]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    host = build()
    host.history_element_limit = 0
    out_h = host.sample(x0, show_progress=False, seed=0)
    for out in (out_f, out_h):
        assert out.samples.shape == (n_iter, c, d) and torch.isfinite(out.samples).all()
    for k in ("n_target_gradient_calls", "n_attempted_trajectories", "n_divergences"):
        assert getattr(out_f.statistics, k) == getattr(out_h.statistics, k)
    assert float(np.max(np.abs(out_f.mean - out_h.mean))) < 0.3
    assert fused._iters_done == host._iters_done == n_iter


def test_adaptive_imh_schedule_position_and_warnings(capsys):
    s = _imh(AdaptiveIMH, 3, StandardGaussian((3,)), Flow(RealNVP((3,)), seed=0),
             n_iterations=4, store_samples=False)
    assert "setting params.store_samples to True" in capsys.readouterr().out
    assert s.params.store_samples
    s.sample(torch.zeros((4, 3)), show_progress=False, seed=0)
    assert s.extra_resumable_state() == {"imh_iters_done": 4}
    s.sample_continue(torch.zeros((4, 3)), show_progress=False, seed=1)
    assert s._iters_done == 8
    # a time limit counts only the iterations actually completed
    s.sample(torch.zeros((4, 3)), show_progress=False, seed=0, time_limit_seconds=0.0)
    assert s._iters_done == 0


def test_warmup_fits_the_flow_and_user_kwargs_win():
    s = _imh(FixedIMH, 3, DiagonalGaussian(np.zeros(3, np.float32), np.float32(2.0)),
             Flow(RealNVP((3,), n_layers=2, hidden_size=16), seed=0),
             warmup_fit_kwargs={"n_epochs": 60, "lr": 0.02, "show_progress": False})
    out = s.warmup(torch.zeros((10, 3)), show_progress=True, seed=0)
    assert out.samples.shape == (1, 10, 3)
    draws = s.kernel.flow.sample(2000, seed=1)
    assert 1.5 < float(draws.std()) < 2.5  # moved from N(0, I) toward sigma = 2


def test_front_door_defaults_run_fixed_imh_and_adaptive_ignores_param_kwargs():
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((3,)), n_chains=6, n_iterations=5,
                                 device="cpu", seed=0, show_progress=False,
                                 flow_kwargs={"n_layers": 2, "hidden_size": 8}, **kw)

    out = run()
    assert isinstance(out.kernel, IMHKernel) and out.samples.shape == (5, 6, 3)
    assert out.statistics.acceptance_rate == 1.0  # an identity flow proposes the target
    assert torch.equal(out.samples, run().samples)
    assert torch.equal(run(strategy="fixed_imh").samples, out.samples)
    ada = run(strategy="adaptive_imh", param_kwargs={"n_iterations": 5})
    assert ada.samples.shape == (100, 6, 3)  # reference quirk: always 100 iterations
    warm = run(warmup=True)
    assert warm.samples.shape == (5, 6, 3) and torch.isfinite(warm.samples).all()
    s = nfmc_torch.create_sampler(StandardGaussian((3,)), device="cpu")
    assert type(s) is FixedIMH


def test_imh_recovers_sigma():
    """tests/test_statistical_correctness.py's IMH case: the 5-d sigma =
    1..3 target with the reverse-KL warmup, 64 chains, 400 iterations,
    sigma within 20% and the mean within 0.2 sigma."""
    sigma = np.linspace(1.0, 3.0, 5).astype(np.float32)
    nfmc_torch.set_seed(0)
    out = nfmc_torch.sample(DiagonalGaussian(np.zeros(5), sigma), n_chains=64, n_iterations=400,
                            warmup=True, show_progress=False, seed=3, device="cpu",
                            flow_kwargs={"n_layers": 2, "hidden_size": 32})
    assert torch.isfinite(out.samples).all()
    np.testing.assert_allclose(np.sqrt(out.variance), sigma, rtol=0.2)
    assert np.all(np.abs(out.mean) <= 0.2 * sigma)


def test_fixed_imh_run_matches_jax_two_sample():
    """Both packages run FixedIMH with the same perturbed flow on a
    misfit target, each with its own random stream: the draws pass the
    chain-permutation two-sample test and the acceptances agree."""
    d, c, n_iter = 4, 32, 150
    jf, tf = _jflow(d, perturb=0.05, seed=3)
    mu, sig = np.full(d, 0.5, np.float32), np.float32(1.2)
    x0 = (mu + sig * np.random.default_rng(0).standard_normal((c, d))).astype(np.float32)
    js = JFixedIMH((d,), JDiagonalGaussian(mu, sig), kernel=JIMHKernel((d,), flow=jf))
    js.params.n_iterations = n_iter
    jout = js.sample(jnp.asarray(x0), show_progress=False, seed=0)
    ts = _imh(FixedIMH, d, DiagonalGaussian(mu, sig), tf, n_iterations=n_iter)
    tout = ts.sample(torch.from_numpy(x0), show_progress=False, seed=0)
    report = mcmc_two_sample_report(np.asarray(jout.samples), tout.samples.numpy(),
                                    rng=np.random.default_rng(1))
    assert report["ok"], report
    j_rate, t_rate = jout.statistics.acceptance_rate, tout.statistics.acceptance_rate
    # ~4800 proposals each: the binomial sd of a rate near 0.5 is ~0.007
    assert 0.2 < t_rate < 0.9 and abs(t_rate - j_rate) < 0.04, (t_rate, j_rate)


def test_fused_chunk_is_reproducible_from_injected_draws():
    """``run_fused_chunk`` depends only on its state, draws, schedule and
    fit generator: two runs from the same inputs are equal (what the
    card-vs-CPU check of chip_smoke.py relies on), and a refit changes the
    flow log-prob it carries."""
    d, c = 4, 8
    s = _imh(AdaptiveIMH, d, StandardGaussian((d,)), _jflow(d, perturb=0.1)[1], n_iterations=5)
    x0 = torch.randn((c, d), generator=torch.Generator().manual_seed(0))
    draws = s.make_draws(torch.Generator().manual_seed(1), (5,), c)
    do_fit, k_idx = np.array([True, False, True, True, False]), np.array([0, 0, 1, 0, 0])
    scan_fit = ttrain.make_scan_fit(s.kernel.flow, c, n_epochs=1)
    outs = [s.run_fused_chunk(s.make_fused_state(x0, 5), 0, draws, do_fit, k_idx, scan_fit,
                              torch.Generator().manual_seed(2)) for _ in range(2)]
    for k in ("x", "flp", "u", "hist"):
        assert torch.equal(outs[0][k], outs[1][k])
    fitted = outs[0]["params"]
    assert not torch.equal(fitted[0]["w"][2], s.kernel.flow.params[0]["w"][2])
    np.testing.assert_allclose(outs[0]["flp"].numpy(),
                               s.kernel.flow.log_prob_fn(fitted, outs[0]["x"]).numpy(), atol=1e-6)
    # the potential of the carried state is the target's
    assert torch.allclose(outs[0]["u"], StandardGaussian((d,))(outs[0]["x"]))


def test_callable_target_through_imh():
    s = _imh(FixedIMH, 3, CallablePotential(lambda x: 0.5 * (x * x).sum(-1), (3,)),
             Flow(RealNVP((3,)), seed=0), n_iterations=3)
    out = s.sample(torch.zeros((4, 3)), show_progress=False, seed=0)
    assert out.samples.shape == (3, 4, 3)

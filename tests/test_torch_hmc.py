"""MH, HMC and UHMC of nfmc_torch against nfmc_tpu's steps with the same
injected draws (states and masks: 1e-5 for MH, 1e-4 after 20 leapfrogs),
the counter contract, the divergence rule, tuning steps, and the jump
variants (``jump_hmc``, ``jump_uhmc``, ``jump_mh``) through the front door."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.mcmc.hmc import HMC as JHMC
from nfmc_tpu.samplers.mcmc.hmc import UHMC as JUHMC
from nfmc_tpu.samplers.mcmc.hmc import HMCKernel as JHMCKernel
from nfmc_tpu.samplers.mcmc.hmc import HMCParameters as JHMCParameters
from nfmc_tpu.samplers.mcmc.mh import MH as JMH
from nfmc_tpu.samplers.mcmc.mh import RandomWalk as JRandomWalk
from nfmc_torch.flows.convert import from_jax_metropolis_state
from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import HMC, MH, UHMC, HMCKernel, HMCParameters, RandomWalk

D, C = 5, 7
MH_TOL, HMC_TOL = 1e-5, 1e-4


def _targets(seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(D).astype(np.float32)
    sigma = (0.5 + rng.random(D)).astype(np.float32)
    return JDiagonalGaussian(mu, sigma), DiagonalGaussian(mu, sigma)


def _state(sampler, x, jstate):
    """The port's carried state from the JAX one (same kernel state)."""
    jm = jstate[0] if isinstance(jstate, tuple) else jstate
    return sampler._augment_state(from_jax_metropolis_state(jm), x)


def _mstate(state):
    return state[0] if isinstance(state, tuple) else state


def _steps(js, ts, x0, draws, tol, tuning=False):
    """Run both packages' steps over the injected ``draws`` (a list of
    per-iteration tuples of numpy arrays); compare states, masks, infos and
    the carried kernel state after every step."""
    jstep, tstep = js._make_step_aux(tuning), ts._make_step_aux(tuning)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate = js._augment_state(js.kernel.make_state(), jx)
    tstate = _state(ts, tx, jstate)
    for d in draws:
        jx_new, jstate, jinfo = jstep(jx, jstate, None, tuple(jnp.asarray(a) for a in d))
        tx_new, tstate, tinfo = tstep(tx, tstate, tuple(torch.from_numpy(a) for a in d))
        jmask = np.any(np.asarray(jx_new) != np.asarray(jx), axis=-1)
        tmask = (tx_new != tx).any(-1).numpy()
        np.testing.assert_array_equal(tmask, jmask)
        assert float(np.max(np.abs(tx_new.numpy() - np.asarray(jx_new)))) <= tol
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        assert int(tinfo.diverged) == int(jinfo.diverged)
        if isinstance(jstate, tuple):  # MH's carried U(x)
            np.testing.assert_allclose(tstate[1].numpy(), np.asarray(jstate[1]), rtol=tol, atol=tol)
        jm, tm = _mstate(jstate), _mstate(tstate)
        np.testing.assert_allclose(float(tm.step_size), float(jm.step_size), rtol=tol)
        np.testing.assert_allclose(tm.inv_mass_diag.numpy(), np.asarray(jm.inv_mass_diag),
                                   rtol=tol, atol=tol)
        jx, tx = jx_new, tx_new
    return tx, tstate


@pytest.mark.parametrize("adjusted", [True, False])
def test_mh_step_matches_jax(adjusted):
    jt, tt = _targets()
    jcls, tcls = (JMH, MH) if adjusted else (JRandomWalk, RandomWalk)
    js, ts = jcls((D,), jt), tcls((D,), tt, device="cpu")
    inv_mass = (0.3 + np.random.default_rng(3).random(D)).astype(np.float32)
    js.kernel.inv_mass_diag = ts.kernel.inv_mass_diag = inv_mass
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    draws = [(rng.standard_normal((C, D)).astype(np.float32),
              np.log(rng.random(C)).astype(np.float32) if adjusted else np.zeros(C, np.float32))
             for _ in range(6)]
    _steps(js, ts, x0, draws, MH_TOL)
    assert ts.calls_per_iter(C) == (2 * C if adjusted else 0) and ts.grads_per_iter(C) == 0


def _hmc_draws(rng, n, jitter=0.0):
    return [(rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32),
             (1.0 + jitter * (2 * rng.random(C) - 1)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("adjusted,jitter", [(True, 0.0), (True, 0.2), (False, 0.0)])
def test_hmc_step_matches_jax_after_20_leapfrogs(adjusted, jitter):
    """Three iterations of 20 leapfrog steps with a non-unit mass, the same
    momenta, accept uniforms and step scales: states within 1e-4, masks
    equal."""
    jt, tt = _targets()
    jcls, tcls = (JHMC, HMC) if adjusted else (JUHMC, UHMC)
    inv_mass = (0.5 + np.random.default_rng(4).random(D)).astype(np.float32)
    js = jcls((D,), jt, JHMCKernel(event_size=D, step_size=0.15, inv_mass_diag=inv_mass),
              JHMCParameters(step_jitter=jitter))
    ts = tcls((D,), tt, HMCKernel(event_size=D, step_size=0.15, inv_mass_diag=inv_mass),
              HMCParameters(step_jitter=jitter), device="cpu")
    assert ts.kernel.n_leapfrog_steps == 20
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    x, _ = _steps(js, ts, x0, _hmc_draws(rng, 3, jitter), HMC_TOL)
    assert not torch.equal(x, torch.from_numpy(x0))


def test_hmc_draws_shape_and_jitter():
    s = HMC((2, 3), StandardGaussian((2, 3)), params=HMCParameters(step_jitter=0.25),
            device="cpu")
    p_raw, log_u, eps = s.make_draws()(torch.Generator().manual_seed(0), (4, 2), C)
    assert p_raw.shape == (4, 2, C, 6) and log_u.shape == eps.shape == (4, 2, C)
    assert float(eps.min()) >= 0.75 and float(eps.max()) <= 1.25 and float(log_u.max()) < 0
    eps0 = HMC((3,), StandardGaussian((3,)), device="cpu").make_draws()(
        torch.Generator().manual_seed(0), (2,), C)[2]
    assert torch.equal(eps0, torch.ones(2, C))


def _inf_targets():
    def jax_u(x):
        return 0.5 * jnp.sum(x * x, -1) + jnp.where(x[:, 0] > 1.5, jnp.inf, 0.0)

    def torch_u(x):
        return 0.5 * (x * x).sum(-1) + torch.where(x[:, 0] > 1.5, torch.tensor(float("inf")),
                                                   torch.zeros(()))

    return jax_u, CallablePotential(torch_u, (D,))


@pytest.mark.parametrize("kind", ["hmc", "mh"])
def test_divergence_rule_on_a_target_that_returns_inf(kind):
    """A trajectory (a proposal) that ends where U = +inf is rejected by both
    packages and flags the iteration as diverged; the other chains move."""
    jax_u, torch_u = _inf_targets()
    rng = np.random.default_rng(5)
    x0 = (0.2 * rng.standard_normal((C, D))).astype(np.float32)
    if kind == "hmc":
        js = JHMC((D,), jax_u, JHMCKernel(event_size=D, step_size=0.05))
        ts = HMC((D,), torch_u, HMCKernel(event_size=D, step_size=0.05), device="cpu")
        draws = _hmc_draws(rng, 1)
        draws[0][0][0, 0] = 60.0  # chain 0's momentum carries it past x_0 = 1.5
        draws[0][1][:] = -40.0  # every finite trajectory accepts
    else:
        js, ts = JMH((D,), jax_u), MH((D,), torch_u, device="cpu")
        noise = (0.1 * rng.standard_normal((C, D))).astype(np.float32)
        noise[0, 0] = 10.0
        draws = [(noise, np.full(C, -40.0, np.float32))]
    x, state = _steps(js, ts, x0, draws, HMC_TOL)
    np.testing.assert_array_equal(x[0].numpy(), x0[0])
    assert not torch.equal(x[1:], torch.from_numpy(x0[1:]))
    step = ts._make_step_aux(False)
    xt = torch.from_numpy(x0)
    _, _, info = step(xt, ts._augment_state(ts.kernel.make_state("cpu"), xt),
                      tuple(torch.from_numpy(a) for a in draws[0]))
    assert int(info.diverged) == 1 and int(info.n_accepted) == C - 1


@pytest.mark.parametrize("kind", ["hmc", "mh"])
def test_tuning_steps_match_jax(kind):
    """Five tuning steps: the dual-averaged step size (HMC) and the EMA
    inverse mass agree with the JAX package's after every step."""
    jt, tt = _targets(1)
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    if kind == "hmc":
        js = JHMC((D,), jt, JHMCKernel(event_size=D, step_size=0.3))
        ts = HMC((D,), tt, HMCKernel(event_size=D, step_size=0.3), device="cpu")
        draws = _hmc_draws(rng, 5)
    else:
        js, ts = JMH((D,), jt), MH((D,), tt, device="cpu")
        draws = [(rng.standard_normal((C, D)).astype(np.float32),
                  np.log(rng.random(C)).astype(np.float32)) for _ in range(5)]
    js.params.imd_adjustment = ts.params.imd_adjustment = 0.2  # make the EMA visible
    step0 = ts.kernel.step_size
    _, state = _steps(js, ts, x0, draws, HMC_TOL, tuning=True)
    m = _mstate(state)
    assert not np.allclose(m.inv_mass_diag.numpy(), 1.0)
    assert (abs(float(m.step_size) - step0) > 1e-6) == (kind == "hmc")  # MH pins the step


@pytest.mark.parametrize("strategy,calls,grads", [("hmc", 2 * 20 + 2, 2 * 20), ("uhmc", 40, 40),
                                                  ("mh", 2, 0)])
def test_front_door_standalone(strategy, calls, grads):
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy, n_chains=6,
                                 n_iterations=5, n_warmup_iterations=4, device="cpu", seed=0,
                                 show_progress=False, **kw)

    out = run()
    st = out.statistics
    assert out.samples.shape == (5, 6, 3) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == 5 * calls * 6 and st.n_target_gradient_calls == 5 * grads * 6
    assert st.n_attempted_trajectories == 30
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    assert warm.samples.shape == (5, 6, 3)
    assert not np.allclose(warm.kernel.inv_mass_diag, 1.0)  # tuned by the warmup


@pytest.mark.parametrize("strategy,inner_n,calls,grads", [
    ("jump_hmc", 5, 42, 40), ("jump_uhmc", 2, 40, 40), ("jump_mh", 3, 2, 0)])
def test_jump_variants_through_the_front_door(strategy, inner_n, calls, grads):
    """The interleaving law ``(n * (inner_n + 1), C, *event)`` and the
    counters; ``jump_hmc`` defaults to 5 inner iterations (the reference),
    the others to the inner sampler's 100, overridden here."""
    n, c = 3, 6
    kw = {} if strategy == "jump_hmc" else {"inner_param_kwargs": {"n_iterations": inner_n}}
    out = nfmc_torch.sample(StandardGaussian((2, 2)), strategy=strategy,
                            flow='realnvp%{"n_layers": 2, "hidden_size": 8}', n_chains=c,
                            n_iterations=n, device="cpu", seed=0, show_progress=False, **kw)
    st = out.statistics
    assert out.samples.shape == (n * (inner_n + 1), c, 2, 2)
    assert torch.isfinite(out.samples).all()
    assert st.n_target_calls == n * (inner_n * calls * c + 2 * c)
    assert st.n_target_gradient_calls == n * inner_n * grads * c
    assert st.n_attempted_jumps == n * c and st.n_attempted_trajectories == n * inner_n * c
    assert 0 <= st.n_accepted_jumps <= n * c
    np.testing.assert_allclose(out.mean, out.samples.double().mean((0, 1)).numpy(), atol=1e-5)
    # an identity-init flow on N(0, I) is the target: the jumps accept
    assert st.jump_acceptance_rate > 0.9

"""DenseHMC and DenseMALA of nfmc_torch against nfmc_tpu's with the same
injected draws and the same kernel state: one step of each, dense and
scalar (states within 1e-4 for HMC after 20 leapfrogs, 1e-5 for MALA;
accept masks equal); the refresh (the shrunk matrix, its factors and the
scalar-mode decision, within 1e-4 relative); the gate's hysteresis and
patience; a user's ``mass_cov`` over the adapted state; the counters and
the front door."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.potentials import FullRankGaussian as JFullRankGaussian
from nfmc_tpu.samplers.mcmc.dense import DenseHMC as JDenseHMC
from nfmc_tpu.samplers.mcmc.dense import DenseHMCKernel as JDenseHMCKernel
from nfmc_tpu.samplers.mcmc.dense import DenseHMCParameters as JDenseHMCParameters
from nfmc_tpu.samplers.mcmc.dense import DenseLangevinKernel as JDenseLangevinKernel
from nfmc_tpu.samplers.mcmc.dense import DenseLangevinParameters as JDenseLangevinParameters
from nfmc_tpu.samplers.mcmc.dense import DenseMALA as JDenseMALA
from nfmc_torch.core.tuning import DualAveragingState
from nfmc_torch.potentials import FullRankGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import (DenseHMC, DenseHMCKernel, DenseHMCParameters,
                                      DenseLangevinKernel, DenseLangevinParameters, DenseMALA,
                                      DenseMetropolisState)

D, C = 5, 8
HMC_TOL, MALA_TOL, REFRESH_TOL = 1e-4, 1e-5, 1e-4


def _spd(seed, d=D, scale=1.0):
    a = np.random.default_rng(seed).standard_normal((d, d))
    return (scale * (a @ a.T / d + 0.5 * np.eye(d))).astype(np.float32)


def _targets(seed=0):
    chol = np.linalg.cholesky(_spd(seed).astype(np.float64))
    mu = np.random.default_rng(seed + 1).standard_normal(D).astype(np.float32)
    return JFullRankGaussian(mu, chol), FullRankGaussian(mu, chol)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def from_jax_dense_state(js) -> DenseMetropolisState:
    da = js.da
    return DenseMetropolisState(
        step_size=_t(js.step_size), cov_a=_t(js.cov_a), cov_b=_t(js.cov_b), chol=_t(js.chol),
        chol_inv=_t(js.chol_inv), jitter_frac=_t(js.jitter_frac), t=int(js.t), mu=_t(js.mu),
        scalar_mode=_t(js.scalar_mode, torch.bool), r_low_streak=_t(js.r_low_streak, torch.int32),
        da=DualAveragingState(t=_t(da.t), error_sum=_t(da.error_sum),
                              log_step_averaged=_t(da.log_step_averaged), mu=_t(da.mu)))


def _mstate(state):
    return state[0] if isinstance(state, tuple) else state


def assert_states_close(tm, jm, tol):
    for f in ("step_size", "cov_a", "cov_b", "chol", "chol_inv", "jitter_frac", "mu"):
        want = np.asarray(getattr(jm, f))
        np.testing.assert_allclose(getattr(tm, f).numpy(), want, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(want).max())), err_msg=f)
    assert tm.t == int(jm.t)
    assert bool(tm.scalar_mode) == bool(jm.scalar_mode)
    assert int(tm.r_low_streak) == int(jm.r_low_streak)


def _pair(kind, mass_cov=None, jitter=0.2, step=None, **params):
    jt, tt = _targets()
    if kind == "hmc":
        jk = JDenseHMCKernel(event_size=D, step_size=step or 0.45, mass_cov=mass_cov)
        tk = DenseHMCKernel(event_size=D, step_size=step or 0.45, mass_cov=mass_cov)
        js = JDenseHMC((D,), jt, jk, JDenseHMCParameters(step_jitter=jitter, **params))
        ts = DenseHMC((D,), tt, tk, DenseHMCParameters(step_jitter=jitter, **params), device="cpu")
    else:
        jk = JDenseLangevinKernel(event_size=D, step_size=step or 0.3, mass_cov=mass_cov)
        tk = DenseLangevinKernel(event_size=D, step_size=step or 0.3, mass_cov=mass_cov)
        js = JDenseMALA((D,), jt, jk, JDenseLangevinParameters(**params))
        ts = DenseMALA((D,), tt, tk, DenseLangevinParameters(**params), device="cpu")
    return js, ts


def _draws(kind, rng, n):
    if kind == "hmc":
        return [(rng.standard_normal((C, D)).astype(np.float32),
                 np.log(rng.random(C)).astype(np.float32),
                 (1.0 + 0.2 * (2 * rng.random(C) - 1)).astype(np.float32)) for _ in range(n)]
    return [(rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32)) for _ in range(n)]


def _set_scalar(kernel, mu):
    """A kernel whose last run ended in scalar mode at ``mu``."""
    kernel._resume_src = kernel.mass_cov
    kernel._resume_src_value = np.array(kernel.mass_cov, copy=True)
    kernel._resume_scalar_mode = True
    kernel._resume_mu = mu


def _steps(js, ts, x0, draws, tol, tuning=False, jitter_frac=None):
    """Both packages' steps over ``draws`` from the same kernel state;
    states (relative to max(1, max|x|)), masks, infos and the carried
    kernel state compared each step."""
    jstep, tstep = js._make_step_aux(tuning), ts._make_step_aux(tuning)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jm = js.kernel.make_state()
    if jitter_frac is not None:
        jm = dataclasses.replace(jm, jitter_frac=jnp.float32(jitter_frac))
    jstate = js._augment_state(jm, jx)
    tstate = ts._augment_state(from_jax_dense_state(jm), tx)
    n_moved = 0
    for d in draws:
        jx_new, jstate, jinfo = jstep(jx, jstate, None, tuple(jnp.asarray(a) for a in d))
        tx_new, tstate, tinfo = tstep(tx, tstate, tuple(torch.from_numpy(a) for a in d))
        jmask = np.any(np.asarray(jx_new) != np.asarray(jx), axis=-1)
        tmask = (tx_new != tx).any(-1).numpy()
        np.testing.assert_array_equal(tmask, jmask)
        scale = max(1.0, float(np.abs(np.asarray(jx_new)).max()))
        assert float(np.max(np.abs(tx_new.numpy() - np.asarray(jx_new)))) <= tol * scale
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        assert int(tinfo.diverged) == int(jinfo.diverged)
        assert_states_close(_mstate(tstate), _mstate(jstate), tol)
        n_moved += int(tmask.sum())
        jx, tx = jx_new, tx_new
    assert 0 < n_moved < len(draws) * C  # both accepts and rejects were held
    return tx, tstate


@pytest.mark.parametrize("kind", ["hmc", "mala"])
@pytest.mark.parametrize("variant", ["dense", "scalar"])
def test_step_matches_jax(kind, variant):
    """Sampling steps with a non-identity metric (dense: the user's
    ``mass_cov``, the jitter gate open; scalar: a warmup that ended in
    scalar mode at mu = 1.7, built with the scalar math)."""
    # steps long enough that some chains reject
    step = {("dense", "hmc"): 1.5, ("scalar", "hmc"): 1.0}.get((variant, kind), 0.7)
    js, ts = _pair(kind, mass_cov=_spd(3, scale=0.3), step=step)
    if variant == "scalar":
        for k in (js.kernel, ts.kernel):
            _set_scalar(k, 1.7)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    tol = HMC_TOL if kind == "hmc" else MALA_TOL
    _steps(js, ts, x0, _draws(kind, rng, 3), tol, jitter_frac=1.0)
    assert getattr(ts, "_build_scalar") == (variant == "scalar")


@pytest.mark.parametrize("kind", ["hmc", "mala"])
def test_dense_math_equals_scalar_math_in_scalar_mode(kind):
    """In scalar mode the refresh writes chol = sqrt(mu) I and the jitter
    gate is shut, so the dense build (what a tuning run uses) gives the
    scalar build's step."""
    js, ts = _pair(kind)
    _set_scalar(ts.kernel, 1.7)
    state = ts.kernel.make_state("cpu")
    state.chol = np.sqrt(np.float32(1.7)) * torch.eye(D)
    state.chol_inv = (1.0 / np.sqrt(np.float32(1.7))) * torch.eye(D)
    state.jitter_frac = torch.tensor(1.0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    d = tuple(torch.from_numpy(a) for a in _draws(kind, rng, 1)[0])
    scalar = ts._make_step_aux(False)(x, ts._augment_state(state, x), d)
    # a tuning build is dense; with nothing to tune its step is the proposal
    ts.params.tune_inv_mass_diag = ts.params.tune_step_size = False
    dense = ts._make_step_aux(True)(x, ts._augment_state(state, x), d)
    torch.testing.assert_close(dense[0], scalar[0], rtol=1e-5, atol=1e-5)
    # the scalar build runs no dense product: factors of NaN leave it as it was
    state.chol = torch.full((D, D), float("nan"))
    state.chol_inv = torch.full((D, D), float("nan"))
    again = ts._make_step_aux(False)(x, ts._augment_state(state, x), d)
    assert torch.equal(again[0], scalar[0]) and int(again[2].diverged) == 0
    # while the dense build reads them: every proposal is NaN and diverges
    dense_nan = ts._make_step_aux(True)(x, ts._augment_state(state, x), d)
    assert int(dense_nan[2].diverged) == 1 and int(dense_nan[2].n_accepted) == 0


@pytest.mark.parametrize("kind", ["hmc", "mala"])
def test_tuning_steps_and_refreshes_match_jax(kind):
    """Twelve tuning steps with a refresh every 4 on a correlated target:
    the half-EMAs, the shrunk factors, mu, the mode, the streak, the jitter
    gate and the dual-averaged step agree after every step."""
    js, ts = _pair(kind, metric_refresh_every=4, metric_adjustment=0.3)
    rng = np.random.default_rng(4)
    x0 = (2.0 * rng.standard_normal((C, D))).astype(np.float32)
    _, state = _steps(js, ts, x0, _draws(kind, rng, 12), HMC_TOL, tuning=True)
    m = _mstate(state)
    assert m.t == 12 and float(m.jitter_frac) == 1.0


def _refresh_pair(scalar_mode, streak, seed):
    """A state one tuning step before a refresh; with an EMA weight of 0
    its halves stay as they are set."""
    js, ts = _pair("hmc", tune_step_size=False, metric_refresh_every=8, metric_adjustment=0.0)
    jm = js.kernel.make_state()
    jm = dataclasses.replace(jm, cov_a=jnp.asarray(_spd(seed)), cov_b=jnp.asarray(_spd(seed + 1)),
                             t=jnp.int32(7), scalar_mode=jnp.asarray(scalar_mode),
                             r_low_streak=jnp.int32(streak))
    return js, ts, jm


@pytest.mark.parametrize("case", ["dense", "noise_first", "noise_patience", "scalar_stays"])
def test_one_refresh_matches_jax(case):
    """One refresh from fixed EMA halves: the shrunk matrix A A^T, A and
    A^{-1} within 1e-4 relative, mu, the mode and the streak equal.
    ``dense``: halves that share their structure; the others: halves of
    independent noise around the identity, before and at the patience, and
    already in scalar mode."""
    shared = case == "dense"
    scalar_mode, streak = {"dense": (False, 0), "noise_first": (False, 0),
                           "noise_patience": (False, 1), "scalar_stays": (True, 0)}[case]
    js, ts, jm = _refresh_pair(scalar_mode, streak, 10)
    rng = np.random.default_rng(11)
    if shared:
        cov = _spd(12, scale=3.0)
        jm = dataclasses.replace(jm, cov_a=jnp.asarray(cov + 0.01 * _spd(13)),
                                 cov_b=jnp.asarray(cov + 0.01 * _spd(14)))
    else:
        # deviations from mu I on disjoint entries: r = r_diag = 0
        halves = []
        for i, j in ((0, 1), (2, 3)):
            h = np.eye(D, dtype=np.float32)
            h[i, j] = h[j, i] = 0.1
            halves.append(jnp.asarray(h))
        jm = dataclasses.replace(jm, cov_a=halves[0], cov_b=halves[1])
    x = rng.standard_normal((C, D)).astype(np.float32)
    mask = np.ones(C, bool)
    jnew = js.make_update_kernel()(jm, jnp.asarray(x), jnp.asarray(mask))
    tnew = ts.make_update_kernel()(from_jax_dense_state(jm), torch.from_numpy(x),
                                   torch.from_numpy(mask))
    assert tnew.t == 8
    shrunk_j = np.asarray(jnew.chol) @ np.asarray(jnew.chol).T
    shrunk_t = (tnew.chol @ tnew.chol.T).numpy()
    np.testing.assert_allclose(shrunk_t, shrunk_j, rtol=REFRESH_TOL,
                               atol=REFRESH_TOL * np.abs(shrunk_j).max())
    assert_states_close(tnew, jnew, REFRESH_TOL)
    want_mode = {"dense": False, "noise_first": False, "noise_patience": True,
                 "scalar_stays": True}[case]
    assert bool(tnew.scalar_mode) == want_mode
    if want_mode:
        np.testing.assert_allclose(tnew.chol.numpy(), float(tnew.chol[0, 0]) * np.eye(D), atol=1e-7)


def test_a_failed_factorisation_keeps_the_old_factors():
    """Halves of -I: mu = -1, the clamped eigenvalues and the ridge 1e-9 mu
    leave a matrix that is not positive definite. JAX's Cholesky gives NaN,
    the port's cholesky_ex a nonzero info; both keep the old factors, mu,
    the mode and the jitter gate."""
    js, ts, jm = _refresh_pair(False, 0, 20)
    bad = -np.eye(D, dtype=np.float32)
    jm = dataclasses.replace(jm, cov_a=jnp.asarray(bad), cov_b=jnp.asarray(bad))
    x = np.random.default_rng(21).standard_normal((C, D)).astype(np.float32)
    mask = np.ones(C, bool)
    jnew = js.make_update_kernel()(jm, jnp.asarray(x), jnp.asarray(mask))
    tm = from_jax_dense_state(jm)
    tnew = ts.make_update_kernel()(tm, torch.from_numpy(x), torch.from_numpy(mask))
    assert_states_close(tnew, jnew, REFRESH_TOL)
    assert torch.equal(tnew.chol, tm.chol) and float(tnew.jitter_frac) == 0.0


def test_refresh_gate_hysteresis_and_patience_match_jax():
    """``tests/test_dense_scalar_path.py``'s drive of the refresh through
    both packages with the same batches: noise enters scalar mode only at
    the patience, strong structure brings dense mode back, the modes equal
    at every refresh and the factors within 1e-4."""
    d, n = 6, 64
    kw = dict(tune_inv_mass_diag=True, tune_step_size=False, metric_refresh_every=1,
              scalar_fallback_patience=2)
    js = JDenseHMC((d,), lambda x: 0.5 * jnp.sum(x * x, -1), JDenseHMCKernel(event_size=d),
                   JDenseHMCParameters(**kw))
    ts = DenseHMC((d,), StandardGaussian((d,)), DenseHMCKernel(event_size=d),
                  DenseHMCParameters(**kw), device="cpu")
    jup, tup = jax.jit(js.make_update_kernel()), ts.make_update_kernel()
    jst = js.kernel.make_state()
    tst = from_jax_dense_state(jst)
    rng = np.random.default_rng(0)
    modes = []
    for corr in [False] * 3 + [True] * 60:
        scales = np.linspace(1.0, 10.0, d) if corr else np.ones(d)
        x = (rng.standard_normal((n, d)) * scales).astype(np.float32)
        mask = np.ones(n, bool)
        jst = jup(jst, jnp.asarray(x), jnp.asarray(mask))
        tst = tup(tst, torch.from_numpy(x), torch.from_numpy(mask))
        assert bool(tst.scalar_mode) == bool(jst.scalar_mode)
        np.testing.assert_allclose(tst.chol.numpy(), np.asarray(jst.chol), rtol=REFRESH_TOL,
                                   atol=REFRESH_TOL * float(np.abs(np.asarray(jst.chol)).max()))
        modes.append(bool(tst.scalar_mode))
    assert modes[:3] == [False, True, True]  # patience 2
    assert not modes[-1]  # recovered


def test_user_mass_cov_overrides_the_adapted_state():
    """``tests/test_dense_metric.py``'s rule in both packages: after a
    warmup the adapted stashes are in effect; a new ``mass_cov`` wins over
    them and runs jitter-free. In the port, a ``mass_cov`` written in place
    does too (the JAX package's synced ``mass_cov`` is a read-only view)."""
    def warm(pkg):
        if pkg == "jax":
            s = JDenseHMC((4,), lambda x: 0.5 * jnp.sum(x * x, -1),
                          params=JDenseHMCParameters(n_warmup_iterations=40))
            s.warmup(jnp.asarray(x0), show_progress=False, seed=1)
            return s, s.kernel.make_state
        s = nfmc_torch.create_sampler(StandardGaussian((4,)), strategy="dense_hmc", device="cpu",
                                      param_kwargs={"n_warmup_iterations": 40})
        s.warmup(torch.from_numpy(x0), show_progress=False, seed=1)
        return s, lambda: s.kernel.make_state("cpu")

    x0 = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    for pkg in ("jax", "torch"):
        s, make = warm(pkg)
        assert float(make().jitter_frac) == 1.0  # adapted: the stashes hold
        my_cov = 4.0 * np.eye(4, dtype=np.float32)
        s.kernel.mass_cov = my_cov
        st = make()
        np.testing.assert_allclose(np.asarray(st.chol), 2.0 * np.eye(4), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(st.cov_a), my_cov, rtol=1e-6)
        assert float(st.jitter_frac) == 0.0
    s, make = warm("torch")
    s.kernel.mass_cov[:] = 9.0 * np.eye(4, dtype=np.float32)  # in place
    st = make()
    np.testing.assert_allclose(np.asarray(st.chol), 3.0 * np.eye(4), rtol=1e-4)
    assert float(st.jitter_frac) == 0.0


def test_bad_mass_cov_raises_and_untuned_dense_hmc_is_hmc():
    with pytest.raises(ValueError, match="positive definite"):
        DenseHMCKernel(event_size=3, mass_cov=-np.eye(3))
    with pytest.raises(ValueError, match="mass_cov shape"):
        DenseLangevinKernel(event_size=3, mass_cov=np.eye(2))
    # the identity metric, jitter-free while untuned: HMC's trajectories (up
    # to make_state's ridge: the factor is sqrt(1 + 1e-6) I)
    tt = StandardGaussian((D,))
    dh = nfmc_torch.create_sampler(tt, strategy="dense_hmc", device="cpu",
                                   kernel_kwargs={"step_size": 0.1})
    h = nfmc_torch.create_sampler(tt, strategy="hmc", device="cpu",
                                  kernel_kwargs={"step_size": 0.1},
                                  param_kwargs={"step_jitter": 0.2})
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal((C, D)).astype(np.float32))
    draws = h.make_draws()(torch.Generator().manual_seed(0), (), C)
    xd = dh._make_step_aux(False)(x0, dh.kernel.make_state("cpu"), draws)[0]
    draws = (draws[0], draws[1], torch.ones_like(draws[2]))
    xh = h._make_step_aux(False)(x0, h.kernel.make_state("cpu"), draws)[0]
    torch.testing.assert_close(xd, xh, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("strategy,calls,grads", [("dense_hmc", 2 * 20 + 2, 2 * 20),
                                                  ("dense_mala", 2, 2)])
def test_front_door_counters_and_warmup(strategy, calls, grads):
    """The counter laws, the seeded stream, and a warmup that adapts the
    metric and hands its shrunk factors to the sampling run."""
    target = FullRankGaussian(np.zeros(3, np.float32), np.diag([1.0, 2.0, 3.0]))

    def run(**kw):
        return nfmc_torch.sample(target, strategy=strategy, n_chains=6, n_iterations=5,
                                 n_warmup_iterations=16, device="cpu", seed=0,
                                 show_progress=False, **kw)

    out = run()
    st = out.statistics
    assert out.samples.shape == (5, 6, 3) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == 5 * calls * 6 and st.n_target_gradient_calls == 5 * grads * 6
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    k = warm.kernel
    assert not np.allclose(k.mass_cov, np.eye(3)) and k._resume_t == 16
    assert float(k._resume_jitter_frac) == 1.0
    # the sampling run started from the warmup's factors and did not tune
    st = k.make_state("cpu")
    assert torch.equal(st.chol, k._resume_factors[0]) and st.t == 16

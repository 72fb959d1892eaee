"""Kernel adaptation in nfmc_torch against nfmc_tpu on the CPU: dual
averaging, the inverse-mass EMA, the train/val split, MALA tuning steps with
the same injected ``(noise, log_u)``, and the standalone MALA/ULA runs.

Tolerance 1e-5 (float32): the same operations on the same numbers; the
dual-averaging log step divides by sqrt(t) gamma = 0.16 and so stays O(1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.core import tuning as jt
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.mcmc.langevin import MALA as JMALA
from nfmc_torch.core import tuning as tt
from nfmc_torch.flows import from_jax_metropolis_state
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import MALA, ULA, LangevinParameters

TOL = 1e-5
D, C = 5, 9


def _close(a, b, tol=TOL):
    assert float(np.max(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)))) <= tol


def _da_fields(da):
    return [da.t, da.error_sum, da.log_step_averaged, da.mu]


def test_dual_averaging_matches_jax():
    p_j, p_t = jt.DualAveragingParams(), tt.DualAveragingParams()
    assert (p_t.target_acceptance_rate, p_t.kappa, p_t.gamma, p_t.t0) == (0.651, 0.75, 0.05, 10)
    da_j, da_t = jt.da_init(0.4, p_j), tt.da_init(0.4, p_t)
    for rate in (0.2, 0.9, 0.65, 1.0, 0.0, 0.4):
        da_j, s_j = jt.da_update_step_size(da_j, jnp.float32(rate), p_j)
        da_t, s_t = tt.da_update_step_size(da_t, torch.tensor(rate), p_t)
        for a, b in zip(_da_fields(da_t), _da_fields(da_j)):
            _close(a, b)
        _close(s_t, s_j)
        _close(tt.da_value(da_t), jt.da_value(da_j))


def test_ema_inv_mass_is_the_population_variance():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, D)).astype(np.float32) * np.arange(1, D + 1, dtype=np.float32)
    imd = rng.random(D).astype(np.float32) + 0.5
    got = tt.ema_inv_mass_diag(torch.from_numpy(imd), torch.from_numpy(x), 0.3)
    _close(got, jt.ema_inv_mass_diag(jnp.asarray(imd), jnp.asarray(x), 0.3))
    _close(got, 0.3 * x.var(0) + 0.7 * imd)


@pytest.mark.parametrize("shuffle", [True, False])
def test_train_val_split_matches_jax(shuffle):
    x = np.random.default_rng(1).standard_normal((10, 7, 3)).astype(np.float32)
    for got, want in zip(tt.train_val_split(torch.from_numpy(x), 0.7, 40, 20, shuffle, seed=3),
                         jt.train_val_split(x, 0.7, 40, 20, shuffle, seed=3)):
        np.testing.assert_array_equal(got, want)


def test_mala_tuning_steps_match_jax():
    """Five tuning steps: x, U, grad U, the step size, the inverse mass and
    every dual-averaging field agree after each step. The port starts from
    the JAX kernel state carried across."""
    rng = np.random.default_rng(0)
    mu = rng.standard_normal(D).astype(np.float32)
    sigma = (0.5 + rng.random(D)).astype(np.float32)
    js = JMALA((D,), JDiagonalGaussian(mu, sigma))
    ts = MALA((D,), DiagonalGaussian(mu, sigma), device="cpu")
    js.params.imd_adjustment = ts.params.imd_adjustment = 0.2  # make the EMA visible
    jstep, tstep = js._make_step_aux(True), ts._make_step_aux(True)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate = js._augment_state(js.kernel.make_state(), jx)
    tstate = ts._augment_state(from_jax_metropolis_state(jstate[0]), tx)
    for _ in range(5):
        noise = rng.standard_normal((C, D)).astype(np.float32)
        log_u = np.log(rng.random(C)).astype(np.float32)
        jx, jstate, jinfo = jstep(jx, jstate, None, (jnp.asarray(noise), jnp.asarray(log_u)))
        tx, tstate, tinfo = tstep(tx, tstate, (torch.from_numpy(noise), torch.from_numpy(log_u)))
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        for a, b in ((tx, jx), (tstate[1], jstate[1]), (tstate[2], jstate[2])):
            _close(a, b)
        jm, tm = jstate[0], tstate[0]
        _close(tm.step_size, jm.step_size)
        _close(tm.inv_mass_diag, jm.inv_mass_diag)
        for a, b in zip(_da_fields(tm.da), _da_fields(jm.da)):
            _close(a, b)
    assert float(tstate[0].step_size) != pytest.approx(D ** (-1 / 3))


@pytest.mark.parametrize("cls,calls", [(MALA, 2), (ULA, 1)])
def test_standalone_warmup_and_sample(cls, calls):
    n_warm, n, c = 12, 7, 6
    s = cls((2, 3), StandardGaussian((2, 3)),
            params=LangevinParameters(n_iterations=n, n_warmup_iterations=n_warm), device="cpu")
    x0 = torch.randn((c, 2, 3), generator=torch.Generator().manual_seed(0))
    step0 = s.kernel.step_size
    warm = s.warmup(x0, show_progress=False, seed=0)
    assert warm.samples.shape == (n_warm, c, 2, 3)
    assert warm.statistics.n_target_calls == n_warm * calls * c
    assert not np.allclose(s.kernel.inv_mass_diag, 1.0)  # the EMA moved it
    # MALA tunes its step size; ULA (unadjusted) keeps it
    assert (s.kernel.step_size != pytest.approx(step0, rel=1e-6)) == (cls is MALA)
    da_t = float(s.kernel._resume_da.t)
    out = s.sample(warm.samples[-1], show_progress=False, seed=1)
    assert out.samples.shape == (n, c, 2, 3) and torch.isfinite(out.samples).all()
    assert out.statistics.n_target_gradient_calls == n * calls * c
    assert out.statistics.n_attempted_trajectories == n * c
    np.testing.assert_allclose(out.mean, out.samples.double().mean((0, 1)).numpy(), atol=1e-5)
    # sampling does not tune, and the dual-averaging state carries across runs
    assert float(s.kernel._resume_da.t) == da_t
    s.warmup(x0, show_progress=False, seed=2)
    assert float(s.kernel._resume_da.t) == (da_t + n_warm if cls is MALA else da_t)

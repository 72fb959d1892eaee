"""Parallel tempering (PT-MALA, PT-MH, PT-HMC) of nfmc_torch against
nfmc_tpu's with the same injected draws and ladder state: a few ladder
steps of each move, sampling and tuning (positions, potentials and
gradients within 1e-5, PT-HMC's 1e-4 after its leapfrogs; the per-edge swap
counts, the masks and the parity equal; the swap-rate EMA, the per-rung
dual averaging, the inverse mass and the Vousden ladder update within
1e-5), the default ladder's bits, the counter laws, the swap statistics,
the chunk cap and the continuation hooks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.core.tuning import DualAveragingParams as JDAParams
from nfmc_tpu.core.tuning import DualAveragingState as JDAState
from nfmc_tpu.core.tuning import da_step as jda_step
from nfmc_tpu.potentials import GaussianMixture as JGaussianMixture
from nfmc_tpu.samplers.mcmc.pt import PTHMC as JPTHMC
from nfmc_tpu.samplers.mcmc.pt import PTMALA as JPTMALA
from nfmc_tpu.samplers.mcmc.pt import PTRWMH as JPTRWMH
from nfmc_tpu.samplers.mcmc.pt import PTKernel as JPTKernel
from nfmc_tpu.samplers.mcmc.pt import PTParameters as JPTParameters
from nfmc_torch.core.driver import RNG_HOIST_ELEMENT_LIMIT
from nfmc_torch.core.statistics import PTStatistics
from nfmc_torch.core.tuning import DualAveragingParams, DualAveragingState, da_step
from nfmc_torch.potentials import GaussianMixture, StandardGaussian
from nfmc_torch.samplers.mcmc import PTHMC, PTMALA, PTRWMH, PTKernel, PTParameters, PTState

D, C, T = 3, 6, 4
TOL, HMC_TOL = 1e-5, 1e-4
MOVES = {"mala": (JPTMALA, PTMALA), "rwmh": (JPTRWMH, PTRWMH), "hmc": (JPTHMC, PTHMC)}


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def from_jax_pt_state(js) -> PTState:
    da = js.da
    return PTState(
        betas=_t(js.betas), step_sizes=_t(js.step_sizes),
        da=DualAveragingState(t=_t(da.t), error_sum=_t(da.error_sum),
                              log_step_averaged=_t(da.log_step_averaged), mu=_t(da.mu)),
        inv_mass_diag=_t(js.inv_mass_diag), i=_t(js.i, torch.int32),
        swap_accepts=_t(js.swap_accepts, torch.int32),
        swap_attempts=_t(js.swap_attempts, torch.int32), swap_rate_ema=_t(js.swap_rate_ema))


def _targets():
    means = np.stack([np.full(D, -1.5), np.full(D, 1.5)]).astype(np.float32)
    return JGaussianMixture(means, sigma=1.0), GaussianMixture(means, sigma=1.0)


def _pair(move, **params):
    jt, tt = _targets()
    jcls, tcls = MOVES[move]
    # PT-HMC's hot rungs take steps of step_size / sqrt(beta): 0.25 keeps
    # their leapfrogs stable
    kern = dict(event_size=D, n_temps=T, beta_min=0.1, step_size=0.25 if move == "hmc" else 0.5,
                n_leapfrog_steps=5,
                inv_mass_diag=(0.6 + 0.2 * np.arange(D)).astype(np.float32))
    js = jcls((D,), jt, JPTKernel(**kern), JPTParameters(**params))
    ts = tcls((D,), tt, PTKernel(**kern), PTParameters(**params), device="cpu")
    return js, ts


def _draws(rng, n):
    return [(rng.standard_normal((T, C, D)).astype(np.float32),
             np.log(rng.random((T, C))).astype(np.float32),
             np.log(rng.random((T, C))).astype(np.float32)) for _ in range(n)]


def assert_pt_close(tm, jm, tol):
    for f in ("betas", "step_sizes", "inv_mass_diag", "swap_rate_ema"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), rtol=tol,
                                   atol=tol, err_msg=f)
    for f in ("t", "error_sum", "log_step_averaged", "mu"):
        np.testing.assert_allclose(getattr(tm.da, f).numpy(), np.asarray(getattr(jm.da, f)),
                                   rtol=tol, atol=tol, err_msg=f"da.{f}")
    assert tm.i == int(jm.i)
    np.testing.assert_array_equal(tm.swap_accepts.numpy(), np.asarray(jm.swap_accepts))
    np.testing.assert_array_equal(tm.swap_attempts.numpy(), np.asarray(jm.swap_attempts))


def _run_steps(js, ts, x0, draws, tol, tuning):
    jstep, tstep = js._make_step_aux(tuning), ts._make_step_aux(tuning)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate = js._augment_state(js.kernel.make_state(), jx)
    tstate = ts._augment_state(from_jax_pt_state(jstate[0]), tx)
    n_swaps = 0
    for d in draws:
        jx, jstate, jinfo = jstep(jx, jstate, None, tuple(jnp.asarray(a) for a in d))
        prev_acc = tstate[0].swap_accepts.clone()
        tx, tstate, tinfo = tstep(tx, tstate, tuple(torch.from_numpy(a) for a in d))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=tol, atol=tol)
        for k in range(1, len(jstate)):  # the hot rungs, U, grad U
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=tol,
                                       atol=tol * max(1.0, float(np.abs(np.asarray(jstate[k])).max())))
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        assert int(tinfo.diverged) == int(jinfo.diverged)
        assert_pt_close(tstate[0], jstate[0], tol)
        n_swaps += int((tstate[0].swap_accepts - prev_acc).sum())
    return tx, tstate, n_swaps


@pytest.mark.parametrize("move", ["mala", "rwmh", "hmc"])
@pytest.mark.parametrize("tuning", [False, True])
def test_ladder_steps_match_jax(move, tuning):
    """Six ladder steps (three of each parity), every rung moving and the
    sweeps swapping: the states, the per-edge swap counts and, in tuning,
    the per-rung steps, the inverse mass and the ladder agree with the JAX
    package's after every step."""
    js, ts = _pair(move, imd_adjustment=0.2)
    rng = np.random.default_rng(0)
    x0 = (rng.standard_normal((C, D)) - 1.5).astype(np.float32)
    tol = HMC_TOL if move == "hmc" else TOL
    _, state, n_swaps = _run_steps(js, ts, x0, _draws(rng, 6), tol, tuning)
    pts = state[0]
    assert n_swaps > 0 and pts.i == 6
    # an edge is attempted every other step, C chains a time
    np.testing.assert_array_equal(pts.swap_attempts.numpy(), [3 * C, 3 * C, 3 * C])
    moved_ladder = not np.allclose(pts.betas.numpy(), ts.kernel.betas)
    assert moved_ladder == tuning
    assert ts.hoisted_elements_per_iter(torch.zeros(C, D)) == T * C * (D + 2)


def test_default_ladder_is_the_jax_packages_bits():
    for kw in ({}, {"n_temps": 5, "beta_min": 0.003}, {"step_size": 0.37}):
        jk, tk = JPTKernel(event_size=10, **kw), PTKernel(event_size=10, **kw)
        assert tk.betas.dtype == np.float32 and tk.step_sizes.dtype == np.float32
        np.testing.assert_array_equal(tk.betas, jk.betas)
        np.testing.assert_array_equal(tk.step_sizes, jk.step_sizes)
    with pytest.raises(ValueError, match="strictly decreasing"):
        PTKernel(event_size=2, betas=np.array([1.0, 0.5, 0.7]))
    with pytest.raises(ValueError, match="betas"):
        PTKernel(event_size=2, betas=np.array([0.9, 0.5]))
    tm = PTKernel(event_size=D, n_temps=T).make_state("cpu")
    jm = JPTKernel(event_size=D, n_temps=T).make_state()
    assert_pt_close(tm, jm, 1e-6)


def test_dual_averaging_runs_per_rung():
    """``da_step`` with (T,) leaves: each rung's error moves its own step,
    as the JAX package's; a (T,) error broadcast against a scalar state
    would give one step for all."""
    p = DualAveragingParams()
    steps = np.array([0.1, 0.3, 0.9, 2.0], np.float32)
    jda = JDAState(t=jnp.full((T,), 10.0), error_sum=jnp.zeros(T),
                   log_step_averaged=jnp.log(steps), mu=jnp.log(10.0 * steps))
    tda = DualAveragingState(t=torch.full((T,), 10.0), error_sum=torch.zeros(T),
                             log_step_averaged=torch.log(torch.from_numpy(steps)),
                             mu=torch.log(10.0 * torch.from_numpy(steps)))
    err = np.array([0.5, -0.2, 0.0, 0.3], np.float32)
    for _ in range(3):
        jda = jda_step(jda, jnp.asarray(err), JDAParams())
        tda = da_step(tda, torch.from_numpy(err), p)
    for f in ("t", "error_sum", "log_step_averaged", "mu"):
        assert getattr(tda, f).shape == (T,)
        np.testing.assert_allclose(getattr(tda, f).numpy(), np.asarray(getattr(jda, f)),
                                   rtol=1e-6, atol=1e-6)
    assert len(set(np.round(tda.log_step_averaged.numpy(), 5))) == T


@pytest.mark.parametrize("strategy,calls,grads", [("pt_mala", 2, 2), ("pt_mh", 2, 0),
                                                  ("pt_hmc", 2 * 10 + 2, 2 * 10)])
def test_front_door_counters_and_swap_statistics(strategy, calls, grads):
    """The counter laws per rung (T C each), the cold rung's draws, the
    swap counters in ``PTStatistics`` and the seeded stream; a warmup
    adapts the ladder."""
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((D,)), strategy=strategy, n_chains=C,
                                 n_iterations=5, n_warmup_iterations=6, device="cpu", seed=0,
                                 kernel_kwargs={"n_temps": T}, show_progress=False, **kw)

    out = run()
    st = out.statistics
    assert isinstance(st, PTStatistics) and out.samples.shape == (5, C, D)
    assert st.n_target_calls == 5 * calls * T * C and st.n_target_gradient_calls == 5 * grads * T * C
    assert st.n_attempted_trajectories == 5 * C
    # edges 0 and 2 on even steps, edge 1 on odd ones: 2 + 1 + 2 + 1 + 2
    assert st.n_attempted_swaps == 8 * C and 0 <= st.swap_acceptance_rate <= 1
    assert st.n_accepted_swaps == out.kernel.n_accepted_swaps
    assert "swap_acceptance_rate" in st.as_dict()
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    assert not np.allclose(warm.kernel.betas, np.geomspace(1.0, 0.02, T).astype(np.float32))
    assert warm.kernel._resume_i == 6 + 5


def test_continuation_resumes_the_hot_rungs():
    """``sample_continue`` starts the hot rungs where the last run left them
    (``sample`` starts every rung at x0); the checkpoint hooks carry them."""
    s = nfmc_torch.create_sampler(StandardGaussian((D,)), strategy="pt_mh", device="cpu",
                                  kernel_kwargs={"n_temps": T},
                                  param_kwargs={"n_iterations": 4})
    x0 = torch.zeros(C, D)
    s.sample(x0, show_progress=False, seed=0)
    hot = s._final_mstate[1].clone()
    assert s._final_mstate[0] is None and hot.shape == (T - 1, C, D) and hot.abs().sum() > 0
    seen = {}

    def spy(sampler):
        orig = sampler._augment_state

        def augment(ptstate, x):
            state = orig(ptstate, x)
            seen["hot"] = state[1].clone()
            return state

        sampler._augment_state = augment

    spy(s)
    s.sample_continue(x0, show_progress=False, seed=1)
    assert torch.equal(seen["hot"], hot)
    s.sample(x0, show_progress=False, seed=1)
    assert torch.equal(seen["hot"], torch.zeros(T - 1, C, D))
    extra = s.extra_resumable_state()
    s2 = nfmc_torch.create_sampler(StandardGaussian((D,)), strategy="pt_mh", device="cpu",
                                   kernel_kwargs={"n_temps": T})
    s2.restore_extra_resumable_state(extra)
    spy(s2)
    s2.sample_continue(x0, show_progress=False, seed=2)
    np.testing.assert_array_equal(seen["hot"].numpy(), extra["pt_hot_rungs"])
    with pytest.raises(ValueError, match="hot-rung state"):
        s2.sample_continue(torch.zeros(C + 2, D), show_progress=False, seed=2)


def test_the_chunk_cap_counts_the_ladder():
    """The ladder-wide draws cap the chunk: at T C (d + 2) elements an
    iteration, a pipelined run's chunks stay under the footprint limit (a
    limit of 16 iterations' draws, where the cold chains alone would admit
    106)."""
    s = PTMALA((D,), StandardGaussian((D,)), PTKernel(event_size=D, n_temps=T), device="cpu")
    x = torch.zeros(C, D)
    per_iter = s.hoisted_elements_per_iter(x)
    assert per_iter == T * C * (D + 2) and per_iter > C * D
    cap = RNG_HOIST_ELEMENT_LIMIT // per_iter
    chunks = []
    orig = s.make_draws

    def spy():
        draws = orig()

        def f(g, prefix, n):
            chunks.append(prefix[0])
            return draws(g, prefix, n)

        return f

    s.make_draws = spy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("nfmc_torch.core.driver.RNG_HOIST_ELEMENT_LIMIT", per_iter * 16)
        s.params.n_iterations = 40
        s.sample(x, show_progress=False, seed=0)
    assert cap > 16 and max(chunks) == 16 and sum(chunks) == 40

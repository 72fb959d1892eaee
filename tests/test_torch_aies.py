"""AIES (the affine-invariant stretch move) and jump_aies of nfmc_torch
against nfmc_tpu's: AIES steps with the same injected draws (both half
moves; states and carried potentials within 1e-5, masks equal, the tuned
stretch scale within 1e-6), the walker-count check, the counter law and
the front door; jump_aies's interleaving law, its counters, and the
carried U refreshed after each jump."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.potentials import FullRankGaussian as JFullRankGaussian
from nfmc_tpu.samplers.mcmc.ensemble import AIES as JAIES
from nfmc_tpu.samplers.mcmc.ensemble import AIESKernel as JAIESKernel
from nfmc_tpu.samplers.mcmc.ensemble import AIESParameters as JAIESParameters
from nfmc_torch.core.tuning import DualAveragingState
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.potentials import DiagonalGaussian, FullRankGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import AIES, AIESKernel, AIESParameters, AIESState
from nfmc_torch.samplers.nfmc import JumpAIES

D, C = 4, 11  # an odd walker count: halves of 5 and 6
TOL = 1e-5


def _targets():
    a = np.random.default_rng(0).standard_normal((D, D))
    chol = np.linalg.cholesky(a @ a.T / D + 0.3 * np.eye(D))
    mu = np.arange(D, dtype=np.float32) * 0.5
    return JFullRankGaussian(mu, chol), FullRankGaussian(mu, chol)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def from_jax_aies_state(js) -> AIESState:
    da = js.da
    return AIESState(a=_t(js.a), da=DualAveragingState(t=_t(da.t), error_sum=_t(da.error_sum),
                                                       log_step_averaged=_t(da.log_step_averaged),
                                                       mu=_t(da.mu)))


def _draws(rng, n, c=C):
    c0 = c // 2
    return [(rng.random(c).astype(np.float32), rng.integers(0, c - c0, c0),
             rng.integers(0, c0, c - c0), np.log(rng.random(c)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("tuning", [False, True])
def test_steps_match_jax(tuning):
    """Eight iterations, each two half moves (half 1 against the updated
    half 0): positions, the carried U, masks and the stretch scale."""
    jt, tt = _targets()
    js = JAIES((D,), jt, JAIESKernel(event_size=D, a=2.5), JAIESParameters())
    ts = AIES((D,), tt, AIESKernel(event_size=D, a=2.5), AIESParameters(), device="cpu")
    jstep, tstep = js._make_step_aux(tuning), ts._make_step_aux(tuning)
    rng = np.random.default_rng(1)
    x0 = (rng.standard_normal((C, D)) + 1.0).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jstate = js._augment_state(js.kernel.make_state(), jx)
    tstate = ts._augment_state(from_jax_aies_state(jstate[0]), tx)
    n_moved = 0
    for d in _draws(rng, 8):
        jx_new, jstate, jinfo = jstep(jx, jstate, None, tuple(jnp.asarray(a) for a in d))
        tx_new, tstate, tinfo = tstep(tx, tstate, tuple(torch.from_numpy(a) for a in d))
        jmask = np.any(np.asarray(jx_new) != np.asarray(jx), axis=-1)
        tmask = (tx_new != tx).any(-1).numpy()
        np.testing.assert_array_equal(tmask, jmask)
        np.testing.assert_allclose(tx_new.numpy(), np.asarray(jx_new), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tstate[1].numpy(), np.asarray(jstate[1]), rtol=TOL, atol=TOL)
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted) == int(tmask.sum())
        assert int(tinfo.diverged) == int(jinfo.diverged) == 0
        np.testing.assert_allclose(float(tstate[0].a), float(jstate[0].a), rtol=1e-6)
        n_moved += int(tmask.sum())
        jx, tx = jx_new, tx_new
    assert 0 < n_moved < 8 * C
    assert (float(tstate[0].a) != 2.5) == tuning


def test_walker_count_and_draws():
    s = AIES((D,), StandardGaussian((D,)), device="cpu")
    with pytest.raises(ValueError, match="AIES needs n_chains >= 4"):
        s._augment_state(s.kernel.make_state("cpu"), torch.zeros(3, D))
    with pytest.raises(ValueError, match="stretch scale a must be > 1"):
        AIESKernel(event_size=D, a=1.0)
    z_u, idx0, idx1, log_u = s.make_draws()(torch.Generator().manual_seed(0), (3, 2), C)
    assert z_u.shape == log_u.shape == (3, 2, C)
    assert idx0.shape == (3, 2, C // 2) and idx1.shape == (3, 2, C - C // 2)
    assert int(idx0.max()) < C - C // 2 and int(idx1.max()) < C // 2 and float(log_u.max()) < 0
    # z = ((a - 1) u + 1)^2 / a spans [1/a, a]
    a = torch.tensor(2.0)
    z = ((a - 1.0) * torch.tensor([0.0, 1.0]) + 1.0) ** 2 / a
    torch.testing.assert_close(z, torch.tensor([0.5, 2.0]))


def test_front_door_counters_and_warmup():
    """2 C calls and no gradients an iteration; the warmup tunes a toward
    an acceptance of 0.3 and the sampling run keeps it."""
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((D,)), strategy="aies", n_chains=16,
                                 n_iterations=5, n_warmup_iterations=30, device="cpu", seed=0,
                                 show_progress=False, **kw)

    out = run()
    st = out.statistics
    assert out.samples.shape == (5, 16, D) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == 5 * 2 * 16 and st.n_target_gradient_calls == 0
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    assert warm.kernel.a != 2.0 and warm.kernel.da_params.target_acceptance_rate == 0.3


def test_jump_aies_law_counters_and_refreshed_potential():
    """jump_aies through the front door: ``(n * (inner + 1), C, d)`` draws,
    2 C calls an inner step plus 2 C a jump, no gradients; and in the chunk
    runner the carried U(x) equals U at the chains' positions after the
    jumps moved some of them (the runner refreshes it)."""
    mu = np.full(D, 0.3, np.float32)
    target = DiagonalGaussian(mu, np.float32(1.0))
    n_outer, inner = 4, 3
    out = nfmc_torch.sample(target, strategy="jump_aies",
                            flow='realnvp%{"n_layers": 2, "hidden_size": 8}', n_chains=C,
                            n_iterations=n_outer, inner_param_kwargs={"n_iterations": inner},
                            device="cpu", seed=0, show_progress=False)
    st = out.statistics
    assert out.samples.shape == (n_outer * (inner + 1), C, D)
    assert st.n_target_calls == n_outer * inner * 2 * C + n_outer * 2 * C
    assert st.n_target_gradient_calls == 0 and st.n_attempted_jumps == n_outer * C
    assert st.n_attempted_trajectories == n_outer * inner * C
    assert 0 < st.n_accepted_jumps < n_outer * C
    s = JumpAIES((D,), target, kernel=nfmc_torch.NFMCKernel(
        (D,), flow=Flow(RealNVP((D,), n_layers=2, hidden_size=8), seed=0)), device="cpu")
    s.inner_sampler.params.n_iterations = inner
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((C, D)).astype(np.float32))
    state = s.init_chunk_state(x0)
    draws = s.make_chunk_draws(torch.Generator().manual_seed(3), n_outer, C)
    state, ys = s.run_chunk(state, draws)
    assert int(state.jump_acc.n_accepted) > 0
    torch.testing.assert_close(state.inner_state[1], target(state.x), rtol=0, atol=0)

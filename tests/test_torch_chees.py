"""ChEES-HMC of nfmc_torch against nfmc_tpu's steps with the same injected
draws: sampling and tuning steps under both jitter modes, with the state
(step size, log T, Adam's m / v / t, inverse mass, dual averaging, the
iteration counter) to 1e-5 after every step; the leapfrog count at the
ceiling's boundaries; the chunk's precomputed counts against the step's
own; the counters (2 L C + 2 C calls, 2 L C gradients); the front door."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.samplers.mcmc.chees import CheesHMC as JCheesHMC
from nfmc_tpu.samplers.mcmc.chees import CheesHMCKernel as JCheesHMCKernel
from nfmc_tpu.samplers.mcmc.chees import _van_der_corput as j_vdc
from nfmc_torch.potentials import CallablePotential, StandardGaussian
from nfmc_torch.samplers.mcmc import CheesHMC, CheesHMCKernel
from nfmc_torch.samplers.mcmc.chees import _van_der_corput, leapfrog_count

TOL = 1e-5
D, C = 5, 8
SIGMA = (0.5 + np.arange(D) / 2).astype(np.float32)


def _pair(jitter, **kernel):
    def jax_u(x):
        return 0.5 * jnp.sum((x / SIGMA) ** 2, -1)

    def torch_u(x):
        return 0.5 * ((x / torch.from_numpy(SIGMA)) ** 2).sum(-1)

    kw = dict(event_size=D, step_size=0.3, trajectory_length=1.1, jitter=jitter, **kernel)
    js = JCheesHMC((D,), jax_u, JCheesHMCKernel(**kw))
    ts = CheesHMC((D,), CallablePotential(torch_u, (D,)), CheesHMCKernel(**kw), device="cpu")
    js.params.imd_adjustment = ts.params.imd_adjustment = 0.2  # make the EMA visible
    return js, ts


def _compare_state(ts_state, js_state):
    for f in ("step_size", "log_t", "adam_m", "adam_v", "adam_t"):
        a, b = float(getattr(ts_state, f)), float(getattr(js_state, f))
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (f, a, b)
    assert int(ts_state.iter_idx) == int(js_state.iter_idx)
    np.testing.assert_allclose(ts_state.inv_mass_diag.numpy(), np.asarray(js_state.inv_mass_diag),
                               rtol=TOL)
    for f in ("t", "error_sum", "log_step_averaged", "mu"):
        np.testing.assert_allclose(float(getattr(ts_state.da, f)), float(getattr(js_state.da, f)),
                                   rtol=TOL, atol=TOL)


def _run_steps(js, ts, tuning, n_steps, seed=0):
    rng = np.random.default_rng(seed)
    x0 = (SIGMA * rng.standard_normal((C, D))).astype(np.float32)
    jstep = jax.jit(js._make_step_aux(tuning))
    tstep = ts._make_step_aux(tuning)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jst, tst = js.kernel.make_state(), ts.kernel.make_state("cpu")
    counts = []
    for _ in range(n_steps):
        d = (rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32), np.float32(1.0 - rng.random()))
        jx_new, jst, jinfo = jstep(jx, jst, None, tuple(jnp.asarray(a) for a in d))
        tx_new, tst, tinfo = tstep(tx, tst, tuple(torch.as_tensor(a) for a in d))
        assert float(np.max(np.abs(tx_new.numpy() - np.asarray(jx_new)))) <= TOL * max(
            1.0, float(np.abs(np.asarray(jx_new)).max()))
        np.testing.assert_array_equal((tx_new != tx).any(-1).numpy(),
                                      np.any(np.asarray(jx_new) != np.asarray(jx), -1))
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        assert int(tinfo.diverged) == int(jinfo.diverged)
        assert int(tinfo.n_calls) == int(jinfo.n_calls) and int(tinfo.n_grads) == int(jinfo.n_grads)
        _compare_state(tst, jst)
        counts.append(int(tinfo.n_grads) // (2 * C))
        jx, tx = jx_new, tx_new
    return counts, tst


@pytest.mark.parametrize("jitter", ["halton", "uniform"])
@pytest.mark.parametrize("tuning", [False, True])
def test_chees_steps_match_jax(jitter, tuning):
    """Eight steps with the same draws: states, masks, counters and the
    carried state after every step."""
    js, ts = _pair(jitter)
    counts, state = _run_steps(js, ts, tuning, 8)
    assert len(set(counts)) > 1  # the jitter moved L
    if tuning:
        assert abs(float(state.step_size) - 0.3) > 1e-3 and float(state.adam_t) == 8.0
    else:
        assert float(state.step_size) == pytest.approx(0.3) and float(state.adam_t) == 0.0
    assert ts.leapfrog_total == sum(counts)


def test_van_der_corput_matches_jax():
    n = np.concatenate([np.arange(0, 300), [2 ** 23 - 1, 2 ** 23, 2 ** 24 - 1, 123456789]])
    got = _van_der_corput(torch.as_tensor(n, dtype=torch.int32)).numpy()
    want = np.array([float(j_vdc(jnp.int32(v))) for v in n], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 7, 40, 255])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_leapfrog_count_at_the_ceiling_boundary(k, side):
    """``u T / eps`` just below, at and just above the integer ``k`` (eight
    float32 ulps away, where both packages' exp agree): the same ``L``
    as the JAX step's ``clip(ceil(u exp(log_t) / eps), 1, 256)``."""
    eps = np.float32(0.125)  # exact in binary
    log_t = np.float32(0.0)  # T = 1 exactly
    u = np.float32(k * 0.125)
    u = np.float32(u * (1 + side * 8 * np.finfo(np.float32).eps))
    want = int(jnp.clip(jnp.ceil(jnp.float32(u) * jnp.exp(jnp.float32(log_t)) / jnp.float32(eps))
                        .astype(jnp.int32), 1, 256))
    got = int(leapfrog_count(torch.tensor(u), torch.tensor(log_t), torch.tensor(eps), 256))
    assert got == want == min(256, k + (side > 0))
    # and with a T that is not a power of two
    log_t = np.float32(np.log(1.7))
    u = np.float32(k * 0.125 / np.exp(np.float64(log_t)) * (1 + side * 16 * np.finfo(np.float32).eps))
    want = int(jnp.clip(jnp.ceil(jnp.float32(u) * jnp.exp(jnp.float32(log_t)) / jnp.float32(eps))
                        .astype(jnp.int32), 1, 256))
    got = int(leapfrog_count(torch.tensor(u), torch.tensor(log_t), torch.tensor(eps), 256))
    assert got == want


@pytest.mark.parametrize("jitter", ["halton", "uniform"])
def test_chunk_precompute_gives_the_steps_counts(jitter):
    """Without tuning, a chunk's counts computed up front (one host copy)
    are the ones each step computes from its state; both runs agree."""
    _, ts = _pair(jitter)
    draws = ts.make_draws()(torch.Generator().manual_seed(0), (2, 3), C)
    state = ts.kernel.make_state("cpu")
    state.iter_idx = torch.tensor(5, dtype=torch.int32)
    (counts,) = ts._make_precompute(False)(None, state, draws)
    assert counts.shape == (2, 3) and counts.device.type == "cpu"
    x = torch.randn((C, D), generator=torch.Generator().manual_seed(1))
    step, step_pre = ts._make_step_aux(False), ts._make_step_precomputed(False)
    xa, xb, sa, sb = x, x, state, state
    for i in range(2):
        for s in range(3):
            d = tuple(t[i, s] for t in draws)
            before = ts.leapfrog_total
            xa, sa, ia = step(xa, sa, d)
            assert ts.leapfrog_total - before == int(counts[i, s])
            xb, sb, ib = step_pre(xb, sb, d, (counts[i, s],))
            assert torch.equal(xa, xb) and int(ia.n_grads) == int(ib.n_grads)
    assert ts._make_precompute(True) is None


def test_chees_front_door_and_counters():
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((4,)), strategy="chees_hmc", n_chains=6,
                                 n_iterations=7, n_warmup_iterations=10, device="cpu", seed=0,
                                 show_progress=False, **kw)

    out = run()
    st = out.statistics
    assert out.samples.shape == (7, 6, 4) and torch.isfinite(out.samples).all()
    assert torch.equal(out.samples, run().samples)
    n_lf = st.n_target_gradient_calls // (2 * 6)
    assert st.n_target_gradient_calls == 2 * n_lf * 6
    assert st.n_target_calls == st.n_target_gradient_calls + 2 * 6 * 7
    warm = run(warmup=True)
    k = warm.kernel
    assert abs(k.step_size - 0.1) > 1e-4 and abs(k.trajectory_length - 0.1) > 1e-4
    with pytest.raises(ValueError, match="jitter"):
        CheesHMCKernel(event_size=3, jitter="sobol")

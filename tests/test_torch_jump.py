"""Jump NFMC in nfmc_torch: the accept core's edge cases, three outer
iterations against nfmc_tpu's own pieces with the same draws, the counter
and sample-shape laws, and a two-sample test of whole runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.core.driver import StatsAccum as JStatsAccum
from nfmc_tpu.core.sampler import NFMCKernel as JNFMCKernel
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.mcmc.langevin import LangevinParameters as JLangevinParameters
from nfmc_tpu.samplers.nfmc import JumpMALA as JJumpMALA
from nfmc_tpu.samplers.nfmc.jump import _JumpAccum as JJumpAccum
from nfmc_tpu.validation import mcmc_two_sample_report
from nfmc_torch.core.sampler import NFMCKernel
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.potentials import CallablePotential, DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import LangevinParameters
from nfmc_torch.samplers.nfmc import JumpMALA, JumpNFMCParameters, JumpULA

TOL = 1e-5


def _jump_mala(event_shape, target, inner_n, flow=None, cls=JumpMALA, **params):
    flow = flow or Flow(RealNVP(event_shape, n_layers=2, hidden_size=16), seed=0)
    return cls(event_shape, target, kernel=NFMCKernel(event_shape, flow=flow),
               params=JumpNFMCParameters(**params),
               inner_params=LangevinParameters(n_iterations=inner_n), device="cpu")


def test_accept_core_edge_cases():
    """Rows: NaN current U moves; log q(x) = -inf moves; U(x) = +inf
    accepts; U(x) = -inf does not force a move; a non-finite proposal is
    rejected even from an unevaluable current state."""
    u_curr = torch.tensor([float("nan"), 0.0, float("inf"), float("-inf"), float("nan")])
    logq_curr = torch.tensor([0.0, float("-inf"), 0.0, 0.0, 0.0])
    s = _jump_mala((3,), CallablePotential(lambda x: u_curr, (3,)), inner_n=1)
    s.kernel.flow.log_prob_fn = lambda params, x: logq_curr
    core = s._make_jump_accept_core()
    x = torch.zeros(5, 3)
    x_prime = torch.ones(5, 3)
    u_prime = torch.tensor([0.0, 0.0, 0.0, 0.0, float("inf")])
    x_new, mask = core(None, x, x_prime, torch.zeros(5), u_prime, torch.full((5,), np.log(0.5)))
    assert mask.tolist() == [True, True, True, False, False]
    assert torch.equal(x_new[mask], x_prime[mask]) and torch.equal(x_new[~mask], x[~mask])


def test_unadjusted_jump_accepts_every_finite_proposal():
    s = _jump_mala((3,), StandardGaussian((3,)), inner_n=1, adjusted_jumps=False)
    core = s._make_jump_accept_core()
    x_prime = torch.ones(4, 3)
    x_prime[2, 1] = float("nan")
    _, mask = core(None, torch.zeros(4, 3), x_prime, torch.zeros(4), torch.zeros(4),
                   torch.zeros(4))
    assert mask.tolist() == [True, True, False, True]


def test_three_outer_iterations_match_jax():
    d, C, inner_n, n_outer = 6, 8, 2, 3
    rng = np.random.default_rng(0)
    mu = np.full(d, 0.3, np.float32)
    sigma = np.float32(1.2)
    jflow = JFlow(JRealNVP((d,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), jflow.params)
    jtarget = JDiagonalGaussian(mu, sigma)
    js = JJumpMALA((d,), jtarget, kernel=JNFMCKernel((d,), flow=jflow),
                   inner_params=JLangevinParameters(n_iterations=inner_n))
    flow = Flow(RealNVP((d,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    ts = _jump_mala((d,), DiagonalGaussian(mu, sigma), inner_n, flow=flow)

    x0 = rng.standard_normal((C, d)).astype(np.float32)
    noise = rng.standard_normal((n_outer, inner_n, C, d)).astype(np.float32)
    log_u = np.log(rng.random((n_outer, inner_n, C))).astype(np.float32)
    z = rng.standard_normal((n_outer, C, d)).astype(np.float32)
    k_accs = [jax.random.key(100 + i) for i in range(n_outer)]
    # the JAX jump draws its log_u from k_acc (jump.py:185): the same numbers
    jump_log_u = np.stack([np.asarray(jnp.log(jax.random.uniform(k, (C,)))) for k in k_accs])

    # JAX: the package's own pieces, step by step
    inner = js.inner_sampler
    step = inner._make_step_aux(False)
    jump_accept = js._make_jump_accept()
    params = jflow.params
    x = jnp.asarray(x0)
    ks = inner._augment_state(inner.kernel.make_state(), x)
    acc, jacc = JStatsAccum.zeros((d,)), JJumpAccum.zeros((d,))
    emitted = []
    for i in range(n_outer):
        for s in range(inner_n):
            x, ks, info = step(x, ks, None, (jnp.asarray(noise[i, s]), jnp.asarray(log_u[i, s])))
            acc = acc.add(info, x)
            emitted.append(np.asarray(x))
        x_prime, ld_inv = jflow.bijection.inverse_fn(params, jnp.asarray(z[i]))
        aux = (x_prime, jflow.base_log_prob_fn(jnp.asarray(z[i])) - ld_inv, jtarget(x_prime))
        x, jmask = jump_accept(params, x, k_accs[i], aux)
        ks = inner._augment_state(inner._extract_mstate(ks), x)
        jacc = jacc.add_jump(jmask, x)
        emitted.append(np.asarray(x))

    draws = {"inner": (torch.from_numpy(noise), torch.from_numpy(log_u)),
             "z": torch.from_numpy(z), "jump_log_u": torch.from_numpy(jump_log_u)}
    state, ys = ts.run_chunk(ts.init_chunk_state(torch.from_numpy(x0)), draws)

    assert ys.shape == (n_outer * (inner_n + 1), C, d)
    assert float(np.max(np.abs(ys.numpy() - np.stack(emitted)))) <= TOL
    assert float(np.max(np.abs(state.x.numpy() - np.asarray(x)))) <= TOL
    assert int(state.acc.n_accepted) == int(acc.n_accepted)
    assert int(state.jump_acc.n_accepted) == int(jacc.n_accepted)
    for got, want in zip((*state.acc.moment_sums(), *state.jump_acc.moment_sums()),
                         (*acc.moment_sums(), *jacc.moment_sums())):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= 1e-4  # sums of 48 draws


@pytest.mark.parametrize("cls,calls_per_step", [(JumpMALA, 2), (JumpULA, 1)])
def test_counter_and_shape_laws(cls, calls_per_step):
    n, inner_n, C, event = 3, 2, 8, (2, 3)
    s = _jump_mala(event, StandardGaussian(event), inner_n, cls=cls, n_iterations=n)
    x0 = torch.randn((C, *event), generator=torch.Generator().manual_seed(0))
    out = s.sample(x0, show_progress=False, seed=0)
    st = out.statistics
    assert out.samples.shape == (n * (inner_n + 1), C, *event)
    assert st.n_target_calls == n * (inner_n * calls_per_step * C + 2 * C)
    assert st.n_target_gradient_calls == n * inner_n * calls_per_step * C
    assert st.n_attempted_jumps == n * C
    assert st.n_attempted_trajectories == n * inner_n * C
    assert 0 <= st.n_accepted_jumps <= n * C
    assert out.mean.shape == event and out.variance.shape == event
    # the stored draws and the device moment sums describe the same run
    np.testing.assert_allclose(out.mean, out.samples.double().mean((0, 1)).numpy(), atol=1e-5)


def test_misfit_run_matches_jax_two_sample():
    """Both packages run the misfit configuration (frozen identity RealNVP,
    target N(0.12 * 1, I)) with their own random streams; the draws pass the
    chain-permutation two-sample test and the jump acceptances agree."""
    d, C, n_outer, inner_n, mu = 10, 32, 100, 5, 0.12
    rng = np.random.default_rng(0)
    x0 = (mu + rng.standard_normal((C, d))).astype(np.float32)
    mu_v = np.full(d, mu, np.float32)

    js = JJumpMALA((d,), JDiagonalGaussian(mu_v, np.float32(1.0)),
                   kernel=JNFMCKernel((d,), flow=JFlow(JRealNVP((d,), n_layers=2, hidden_size=16), seed=0)),
                   inner_params=JLangevinParameters(n_iterations=inner_n))
    js.params.n_iterations = n_outer
    jout = js.sample(jnp.asarray(x0), show_progress=False, seed=0)

    ts = _jump_mala((d,), DiagonalGaussian(mu_v, np.float32(1.0)), inner_n, n_iterations=n_outer)
    tout = ts.sample(torch.from_numpy(x0), show_progress=False, seed=0)

    report = mcmc_two_sample_report(np.asarray(jout.samples), tout.samples.numpy(),
                                    rng=np.random.default_rng(1))
    assert report["ok"], report
    j_rate = jout.statistics.jump_acceptance_rate
    t_rate = tout.statistics.jump_acceptance_rate
    # the JAX package accepts ~0.78 of the jumps here; over 3200 jumps the
    # binomial sd of such a rate is ~0.007
    assert 0.70 <= t_rate <= 0.86 and abs(t_rate - j_rate) < 0.04, (t_rate, j_rate)
    assert abs(tout.statistics.acceptance_rate - jout.statistics.acceptance_rate) < 0.03


def _inner_pair(kind, d, target_pair):
    """The JAX package's and the port's inner sampler of ``kind``."""
    from nfmc_tpu.samplers.mcmc.chees import CheesHMC as JCheesHMC
    from nfmc_tpu.samplers.mcmc.chees import CheesHMCKernel as JCheesHMCKernel
    from nfmc_tpu.samplers.mcmc.ess import ESS as JESS
    from nfmc_tpu.samplers.mcmc.nuts import NUTS as JNUTS
    from nfmc_tpu.samplers.mcmc.nuts import NUTSKernel as JNUTSKernel
    from nfmc_torch.samplers.mcmc import ESS, NUTS, CheesHMC, CheesHMCKernel, NUTSKernel

    jt, tt = target_pair
    if kind == "ess":
        return JESS((d,), jt, jt), ESS((d,), tt, tt, device="cpu")
    if kind == "nuts":
        return (JNUTS((d,), jt, JNUTSKernel(event_size=d, max_tree_depth=4, step_size=0.3)),
                NUTS((d,), tt, NUTSKernel(event_size=d, max_tree_depth=4, step_size=0.3),
                     device="cpu"))
    kw = dict(event_size=d, step_size=0.2, trajectory_length=0.9)
    return (JCheesHMC((d,), jt, JCheesHMCKernel(**kw)),
            CheesHMC((d,), tt, CheesHMCKernel(**kw), device="cpu"))


@pytest.mark.parametrize("kind", ["ess", "nuts", "chees"])
def test_jump_variant_outer_iterations_match_jax(kind):
    """Three outer iterations of jump_ess / jump_nuts / jump_chees through
    the port's chunk runner against the JAX package's own pieces with the
    same numbers: every emitted draw, the accept counts, the dynamic
    counters. For ESS each outer iteration starts from a prior redraw and
    the carried nll is refreshed for it."""
    from nfmc_torch.samplers.nfmc import JumpNFMC

    from .test_torch_nuts import chain_draws

    d, C, inner_n, n_outer = 6, 8, 2, 3
    rng = np.random.default_rng(1)
    mu, sigma = np.full(d, 0.3, np.float32), np.float32(1.2)
    jtarget, ttarget = JDiagonalGaussian(mu, sigma), DiagonalGaussian(mu, sigma)
    jflow = JFlow(JRealNVP((d,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), jflow.params)
    flow = Flow(RealNVP((d,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    jinner, tinner = _inner_pair(kind, d, (jtarget, ttarget))
    tinner.params.n_iterations = inner_n
    js = JJumpMALA((d,), jtarget, kernel=JNFMCKernel((d,), flow=jflow),
                   inner_params=JLangevinParameters(n_iterations=inner_n))
    js.inner_sampler = jinner
    ts = JumpNFMC((d,), ttarget, tinner, kernel=NFMCKernel((d,), flow=flow), device="cpu")

    x0 = (10.0 + rng.standard_normal((C, d))).astype(np.float32)  # far from the prior
    z = rng.standard_normal((n_outer, C, d)).astype(np.float32)
    k_accs = [jax.random.key(100 + i) for i in range(n_outer)]
    jump_log_u = np.stack([np.asarray(jnp.log(jax.random.uniform(k, (C,)))) for k in k_accs])
    prior = rng.standard_normal((n_outer, C, d)).astype(np.float32)

    if kind == "nuts":
        keys = [[jax.random.key(1000 + 10 * i + s) for s in range(inner_n)] for i in range(n_outer)]
        per = [[chain_draws(jax.random.split(k, C), d, 4) for k in row] for row in keys]
        inner_draws = tuple(torch.stack([torch.stack([p[m] for p in row]) for row in per])
                            for m in range(4))
        jstep = jax.jit(jinner._make_step(False))
    elif kind == "ess":
        inner_draws = (rng.standard_normal((n_outer, inner_n, C, d)).astype(np.float32),
                       rng.random((n_outer, inner_n, C)).astype(np.float32),
                       rng.random((n_outer, inner_n, C, 1)).astype(np.float32),
                       rng.random((n_outer, inner_n, 5, C, 1)).astype(np.float32))
        jstep = jinner._make_step_aux(False)
    else:
        inner_draws = (rng.standard_normal((n_outer, inner_n, C, d)).astype(np.float32),
                       np.log(rng.random((n_outer, inner_n, C))).astype(np.float32),
                       (1.0 - rng.random((n_outer, inner_n))).astype(np.float32))
        jstep = jinner._make_step_aux(False)

    jump_accept = js._make_jump_accept()
    x = jnp.asarray(x0)
    ks = jinner._augment_state(jinner.kernel.make_state(), x)
    acc = JStatsAccum.zeros((d,))
    emitted, n_jumps = [], 0
    for i in range(n_outer):
        if kind == "ess":
            x = jnp.asarray(prior[i])
            ks = jinner._augment_state(jinner._extract_mstate(ks), x)
        for s in range(inner_n):
            if kind == "nuts":
                x, ks, info = jstep(x, ks, keys[i][s])
            else:
                x, ks, info = jstep(x, ks, None, tuple(jnp.asarray(a[i, s]) for a in inner_draws))
            acc = acc.add(info, x)
            emitted.append(np.asarray(x))
        x_prime, ld_inv = jflow.bijection.inverse_fn(jflow.params, jnp.asarray(z[i]))
        aux = (x_prime, jflow.base_log_prob_fn(jnp.asarray(z[i])) - ld_inv, jtarget(x_prime))
        x, jmask = jump_accept(jflow.params, x, k_accs[i], aux)
        ks = jinner._augment_state(jinner._extract_mstate(ks), x)
        n_jumps += int(jnp.sum(jmask))
        emitted.append(np.asarray(x))

    draws = {"inner": tuple(torch.as_tensor(np.asarray(a)) for a in inner_draws),
             "z": torch.from_numpy(z), "jump_log_u": torch.from_numpy(jump_log_u)}
    if kind == "ess":
        draws["x0"] = torch.from_numpy(prior)
    state, ys = ts.run_chunk(ts.init_chunk_state(torch.from_numpy(x0)), draws)
    assert ys.shape == (n_outer * (inner_n + 1), C, d)
    assert float(np.max(np.abs(ys.numpy() - np.stack(emitted)))) <= TOL
    assert int(state.acc.n_accepted) == int(acc.n_accepted)
    assert int(state.jump_acc.n_accepted) == n_jumps
    calls, grads = state.acc.dynamic_counts()
    assert calls == int(float(acc.n_calls_dyn) + float(acc.c_calls_dyn))
    assert grads == int(float(acc.n_grads_dyn) + float(acc.c_grads_dyn))
    if kind == "ess":
        assert float(np.abs(ys[0].numpy()).max()) < 10  # the first step left the redraw, not x0
        assert calls == grads == 0
    else:
        assert grads > 0


@pytest.mark.parametrize("strategy", ["jump_ess", "jump_nuts", "jump_chees"])
def test_jump_variants_through_the_front_door(strategy):
    """The interleaving law and the counters, static plus dynamic: ESS's
    (5 + 1) C calls a step and no gradient; NUTS's leapfrogs + C a step in
    both counters; ChEES's 2 L C + 2 C calls and 2 L C gradients; and 2 C
    calls a jump."""
    import nfmc_torch

    n, inner_n, C, d = 4, 3, 6, 3
    kw = {"negative_log_likelihood": StandardGaussian((d,))} if strategy == "jump_ess" else {}
    out = nfmc_torch.sample(StandardGaussian((d,)), strategy=strategy,
                            flow='realnvp%{"n_layers": 2, "hidden_size": 8}', n_chains=C,
                            n_iterations=n, inner_param_kwargs={"n_iterations": inner_n},
                            device="cpu", seed=0, show_progress=False, **kw)
    st = out.statistics
    assert out.samples.shape == (n * (inner_n + 1), C, d) and torch.isfinite(out.samples).all()
    assert st.n_attempted_jumps == n * C and st.n_attempted_trajectories == n * inner_n * C
    jump_calls = n * 2 * C
    if strategy == "jump_ess":
        assert st.n_target_calls == n * inner_n * 6 * C + jump_calls
        assert st.n_target_gradient_calls == 0
    elif strategy == "jump_nuts":
        assert st.n_target_calls == st.n_target_gradient_calls + jump_calls
        assert st.n_target_gradient_calls > n * inner_n * 2 * C
    else:
        grads = st.n_target_gradient_calls
        assert grads % (2 * C) == 0 and grads >= n * inner_n * 2 * C
        assert st.n_target_calls == grads + n * inner_n * 2 * C + jump_calls
    # jump_nuts and jump_chees default to 5 inner iterations, as jump_hmc
    if strategy != "jump_ess":
        s = nfmc_torch.create_sampler(StandardGaussian((d,)), strategy=strategy, device="cpu")
        assert s.inner_sampler.params.n_iterations == 5


def test_chunk_draws_keep_their_order():
    """The jump's draws come in the order they always came (the inner draws,
    the proposals' base draws, the jump uniforms), so a seed gives the same
    run as before; an inner sampler with a prior redraw adds its draws
    last."""
    from nfmc_torch.samplers.nfmc import JumpESS

    s = _jump_mala((3,), StandardGaussian((3,)), inner_n=2)
    draws = s.make_chunk_draws(torch.Generator().manual_seed(5), 4, 6)
    g = torch.Generator().manual_seed(5)
    noise = torch.randn((4, 2, 6, 3), generator=g)
    log_u = torch.log(torch.rand((4, 2, 6), generator=g))
    z = torch.randn((24, 3), generator=g)
    jlog_u = torch.log(torch.rand((4, 6), generator=g))
    assert set(draws) == {"inner", "z", "jump_log_u"}
    assert torch.equal(draws["inner"][0], noise) and torch.equal(draws["inner"][1], log_u)
    assert torch.equal(draws["z"], z.reshape(4, 6, 3)) and torch.equal(draws["jump_log_u"], jlog_u)
    e = JumpESS((3,), StandardGaussian((3,)), StandardGaussian((3,)),
                kernel=NFMCKernel((3,), flow=Flow(RealNVP((3,), n_layers=2, hidden_size=8), seed=0)),
                device="cpu")
    e.inner_sampler.params.n_iterations = 2
    ed = e.make_chunk_draws(torch.Generator().manual_seed(5), 4, 6)
    g = torch.Generator().manual_seed(5)
    inner = e.inner_sampler.make_draws()(g, (4, 2), 6)
    torch.randn((24, 3), generator=g)
    torch.rand((4, 6), generator=g)
    assert all(torch.equal(a, b) for a, b in zip(ed["inner"], inner))
    assert torch.equal(ed["x0"], torch.randn((4, 6, 3), generator=g))

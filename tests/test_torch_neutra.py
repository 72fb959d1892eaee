"""NeuTra in nfmc_torch against nfmc_tpu on the same numpy weights: the
adjusted target and its input gradient (RealNVP and c-rqnsf, 1e-5
relative), one NeuTra-HMC and one NeuTra-MH iteration with injected draws,
``transport_x0``, the data-space moments through ``data_transform``, that
no gradient reaches the flow's weights, and a warmup run; NeuTra-ChEES's
steps against the JAX package's with injected draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.flows import CouplingRQNSF as JCouplingRQNSF
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.samplers.mcmc.hmc import HMCKernel as JHMCKernel
from nfmc_tpu.samplers.nfmc.neutra import NeuTraHMC as JNeuTraHMC
from nfmc_tpu.samplers.nfmc.neutra import NeuTraKernel as JNeuTraKernel
from nfmc_tpu.samplers.nfmc.neutra import NeuTraMH as JNeuTraMH
from nfmc_tpu.samplers.nfmc.neutra import NeuTraParameters as JNeuTraParameters
from nfmc_torch.flows import CouplingRQNSF, Flow, RealNVP, from_jax_params
from nfmc_torch.flows.convert import from_jax_metropolis_state
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import HMCKernel
from nfmc_torch.samplers.nfmc import NeuTraChEES, NeuTraHMC, NeuTraKernel, NeuTraMH, NeuTraParameters

D, C = 6, 8
TOL = 1e-5
FLOWS = {"realnvp": (JRealNVP, RealNVP, {}), "c-rqnsf": (JCouplingRQNSF, CouplingRQNSF,
                                                        {"n_bins": 4})}


def _flows(name, pert=0.1, seed=0):
    jcls, tcls, kw = FLOWS[name]
    jflow = JFlow(jcls((D,), n_layers=2, hidden_size=16, use_pallas=False, **kw), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + pert * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(tcls((D,), n_layers=2, hidden_size=16, **kw))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def _targets():
    rng = np.random.default_rng(7)
    mu = (0.5 * rng.standard_normal(D)).astype(np.float32)
    sigma = (0.6 + rng.random(D)).astype(np.float32)
    return JDiagonalGaussian(mu, sigma), DiagonalGaussian(mu, sigma)


def _pair(cls_pair, name, step_size=0.1, **params):
    jflow, flow = _flows(name)
    jt, tt = _targets()
    jcls, tcls = cls_pair
    kw = {}
    if jcls is JNeuTraHMC:
        kw = dict(inner_kernel=JHMCKernel(event_size=D, step_size=step_size))
    js = jcls((D,), jt, kernel=JNeuTraKernel((D,), flow=jflow), params=JNeuTraParameters(**params),
              **kw)
    if tcls is NeuTraHMC:
        kw = dict(inner_kernel=HMCKernel(event_size=D, step_size=step_size))
    ts = tcls((D,), tt, kernel=NeuTraKernel((D,), flow=flow), params=NeuTraParameters(**params),
              device="cpu", **kw)
    return js, ts


@pytest.mark.parametrize("name", list(FLOWS))
def test_adjusted_target_and_its_input_gradient_match_jax(name):
    js, ts = _pair((JNeuTraHMC, NeuTraHMC), name)
    z = np.random.default_rng(2).standard_normal((C, D)).astype(np.float32)
    want = np.asarray(js.adjusted_target(jnp.asarray(z)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(js.adjusted_target(v)))(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = ts.adjusted_target(zt)
    (got_g,) = torch.autograd.grad(got.sum(), zt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=TOL, atol=TOL * np.abs(want_g).max())


def _one_iteration(js, ts, draws, tol):
    """One inner step on both sides from the same latent state and draws."""
    jin, tin = js.inner_sampler, ts.inner_sampler
    z0 = np.random.default_rng(3).standard_normal((C, D)).astype(np.float32)
    jz, tz = jnp.asarray(z0), torch.from_numpy(z0)
    jstate = jin._augment_state(jin.kernel.make_state(), jz)
    jm = jstate[0] if isinstance(jstate, tuple) else jstate
    tstate = tin._augment_state(from_jax_metropolis_state(jm), tz)
    jz1, _, jinfo = jin._make_step_aux(False)(jz, jstate, None, tuple(jnp.asarray(a) for a in draws))
    with torch.no_grad():
        tz1, _, tinfo = tin._make_step_aux(False)(tz, tstate, tuple(torch.from_numpy(a)
                                                                    for a in draws))
    np.testing.assert_array_equal((tz1 != tz).any(-1).numpy(),
                                  np.any(np.asarray(jz1) != z0, axis=-1))
    assert float(np.max(np.abs(tz1.numpy() - np.asarray(jz1)))) <= tol
    assert int(tinfo.n_accepted) == int(jinfo.n_accepted) > 0
    return tz1


@pytest.mark.parametrize("name", list(FLOWS))
def test_one_neutra_hmc_iteration_matches_jax(name):
    """20 leapfrog steps, each gradient through the flow's inverse and
    back: the end states within 1e-4, the same accept masks."""
    js, ts = _pair((JNeuTraHMC, NeuTraHMC), name)
    rng = np.random.default_rng(4)
    draws = (rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32), np.ones(C, np.float32))
    _one_iteration(js, ts, draws, 1e-4)


def test_one_neutra_mh_iteration_matches_jax():
    js, ts = _pair((JNeuTraMH, NeuTraMH), "realnvp")
    js.inner_sampler.kernel.inv_mass_diag = np.full(D, 0.3, np.float32)
    ts.inner_sampler.kernel.inv_mass_diag = np.full(D, 0.3, np.float32)
    rng = np.random.default_rng(5)
    draws = (rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32))
    _one_iteration(js, ts, draws, TOL)


def test_transport_x0_maps_the_start_forward():
    """Without ``transport_x0`` x0 is the latent start; with it, f(x0), as
    in the JAX package (1e-5)."""
    x0 = np.random.default_rng(6).standard_normal((C, D)).astype(np.float32)
    for transport in (False, True):
        js, ts = _pair((JNeuTraHMC, NeuTraHMC), "realnvp", transport_x0=transport)
        got = ts._initial_latent(torch.from_numpy(x0)).numpy()
        np.testing.assert_allclose(got, np.asarray(js._initial_latent(jnp.asarray(x0))),
                                   rtol=TOL, atol=TOL)
        assert np.array_equal(got, x0) != transport
    # sample_continue re-enters a latent state as it is
    ts.params.n_iterations = 2
    out = ts.sample_continue(torch.from_numpy(x0), show_progress=False, seed=0)
    assert ts.params.transport_x0 and out.samples.shape == (2, C, D)


def test_front_door_transport_x0_after_warmup_starts_at_the_warmup_draws(monkeypatch):
    """The warmup's draws are latent; with ``transport_x0`` the front door
    hands the sampler their data-space points, so that its forward map gives
    the draws back."""
    seen = {}
    orig_sample, orig_warmup = NeuTraHMC.sample, NeuTraHMC.warmup

    def sample(self, x0, **kw):
        seen["z0"] = self._initial_latent(x0)
        return orig_sample(self, x0, **kw)

    def warmup(self, x0, **kw):
        out = orig_warmup(self, x0, **kw)
        seen["warm"] = out.samples.reshape(-1, D)
        return out

    monkeypatch.setattr(NeuTraHMC, "sample", sample)
    monkeypatch.setattr(NeuTraHMC, "warmup", warmup)
    flow = _flows("realnvp")[1]
    out = nfmc_torch.sample(StandardGaussian((D,)), strategy="neutra_hmc", flow=flow, n_chains=C,
                            n_iterations=2, n_warmup_iterations=3, warmup=True, device="cpu",
                            seed=0, show_progress=False,
                            param_kwargs={"transport_x0": True,
                                          "warmup_fit_kwargs": {"n_epochs": 3}})
    assert out.samples.shape == (2, C, D)
    # every start is one of the warmup's latent draws, to a float32 round trip
    dist = torch.cdist(seen["z0"], seen["warm"]).min(1).values
    assert float(dist.max()) <= 1e-4


def test_moments_are_taken_through_the_data_transform():
    """The stored draws are latent; the moments are those of f^{-1}(z)."""
    _, ts = _pair((JNeuTraHMC, NeuTraHMC), "realnvp", n_iterations=5)
    x0 = torch.randn((C, D), generator=torch.Generator().manual_seed(0))
    out = ts.sample(x0, show_progress=False, seed=1)
    z = out.samples
    x = ts._latent_to_data(z.reshape(-1, D)).reshape(z.shape).double()
    assert not torch.allclose(x, z.double(), atol=1e-3)  # a non-identity flow
    np.testing.assert_allclose(out.mean, x.mean((0, 1)).numpy(), atol=1e-5)
    np.testing.assert_allclose(out.second_moment, (x * x).mean((0, 1)).numpy(), atol=1e-4)
    assert out.kernel.flow is ts.kernel.flow


def test_no_gradient_reaches_the_flow_weights():
    """A flow whose weights require grad (as they may after a fit): the
    leapfrog's input gradients leave every ``.grad`` empty."""
    _, ts = _pair((JNeuTraHMC, NeuTraHMC), "realnvp", n_iterations=2)
    for p in ts.kernel.flow.params:
        for v in p.values():
            for t in v:
                t.requires_grad_(True)
    out = ts.sample(torch.zeros(C, D), show_progress=False, seed=0)
    assert torch.isfinite(out.samples).all()
    assert all(t.grad is None for p in ts.kernel.flow.params for v in p.values() for t in v)


@pytest.mark.parametrize("strategy,grads", [("neutra_hmc", 40), ("neutra_mh", 0)])
def test_warmup_run_counters_and_finiteness(strategy, grads):
    n, n_warm = 4, 3
    flow = _flows("realnvp")[1]
    out = nfmc_torch.sample(_targets()[1], strategy=strategy, flow=flow, n_chains=C,
                            n_iterations=n, n_warmup_iterations=n_warm, warmup=True,
                            device="cpu", seed=0, show_progress=False,
                            param_kwargs={"warmup_fit_kwargs": {"n_epochs": 5, "n_samples": 16}})
    st = out.statistics
    calls = 42 if strategy == "neutra_hmc" else 2
    assert out.samples.shape == (n, C, D) and torch.isfinite(out.samples).all()
    assert st.n_target_calls == n * calls * C and st.n_target_gradient_calls == n * grads * C
    assert np.isfinite(out.mean).all() and np.isfinite(out.variance).all()


def test_neutra_chees_names_its_roadmap_item():
    """NeuTraChEES, once a stub naming ROADMAP 1.5, now runs: a sampling run
    on the CPU with its counters (ChEES's 2 L C + 2 C calls, 2 L C
    gradients through the flow's inverse) and its ChEES inner sampler."""
    from nfmc_torch.samplers.mcmc import CheesHMC

    s = NeuTraChEES((D,), StandardGaussian((D,)), params=NeuTraParameters(n_iterations=3),
                    device="cpu")
    assert isinstance(s.inner_sampler, CheesHMC) and s.name == "NeuTra-ChEES"
    out = s.sample(torch.zeros(C, D), show_progress=False, seed=0)
    st = out.statistics
    n_lf = s.inner_sampler.leapfrog_total
    assert out.samples.shape == (3, C, D) and torch.isfinite(out.samples).all()
    assert st.n_target_gradient_calls == 2 * n_lf * C and n_lf >= 3
    assert st.n_target_calls == st.n_target_gradient_calls + 2 * C * 3


@pytest.mark.parametrize("tuning", [False, True])
@pytest.mark.parametrize("name", list(FLOWS))
def test_neutra_chees_steps_match_jax(name, tuning):
    """Four NeuTra-ChEES iterations (the latent-space ChEES step, each
    leapfrog's gradient through the flow's inverse) with the same injected
    draws: the latent states to 1e-5, the masks, the counters and the
    adapted state (step size, log T) after every step."""
    from nfmc_tpu.samplers.mcmc.chees import CheesHMCKernel as JCheesHMCKernel
    from nfmc_tpu.samplers.nfmc.neutra import NeuTraChEES as JNeuTraChEES
    from nfmc_torch.samplers.mcmc import CheesHMCKernel

    jflow, flow = _flows(name)
    jt, tt = _targets()
    kw = dict(event_size=D, step_size=0.15, trajectory_length=0.8)
    js = JNeuTraChEES((D,), jt, inner_kernel=JCheesHMCKernel(**kw),
                      kernel=JNeuTraKernel((D,), flow=jflow))
    ts = NeuTraChEES((D,), tt, inner_kernel=CheesHMCKernel(**kw),
                     kernel=NeuTraKernel((D,), flow=flow), device="cpu")
    ts._configure_inner()
    ji, ti = js.inner_sampler, ts.inner_sampler
    jstep, tstep = jax.jit(ji._make_step_aux(tuning)), ti._make_step_aux(tuning)
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((C, D)).astype(np.float32)
    jz, tz = jnp.asarray(z0), torch.from_numpy(z0)
    jst, tst = ji.kernel.make_state(), ti.kernel.make_state("cpu")
    for _ in range(4):
        d = (rng.standard_normal((C, D)).astype(np.float32),
             np.log(rng.random(C)).astype(np.float32), np.float32(1.0 - rng.random()))
        jz_new, jst, jinfo = jstep(jz, jst, None, tuple(jnp.asarray(a) for a in d))
        with torch.no_grad():
            tz_new, tst, tinfo = tstep(tz, tst, tuple(torch.as_tensor(a) for a in d))
        assert float(np.max(np.abs(tz_new.numpy() - np.asarray(jz_new)))) <= TOL * max(
            1.0, float(np.abs(np.asarray(jz_new)).max()))
        np.testing.assert_array_equal((tz_new != tz).any(-1).numpy(),
                                      np.any(np.asarray(jz_new) != np.asarray(jz), -1))
        assert int(tinfo.n_grads) == int(jinfo.n_grads) and int(tinfo.n_calls) == int(jinfo.n_calls)
        for f in ("step_size", "log_t"):
            assert abs(float(getattr(tst, f)) - float(getattr(jst, f))) <= TOL
        jz, tz = jz_new, tz_new

"""Jump NFMC warmup and flow refits in nfmc_torch on the CPU (d=6, 16
chains): the shape law of the warmup draws, that warmup tunes the inner
step and trains the flow, the rollback when the fit raises, ``fit_nf=True``
on both routes, and the front door's reshuffle of warmup draws into x0.

The one numeric tolerance, the run's moments against the mean of its
stored draws, is 1e-5: the device sums are compensated float32 and the
check's are float64."""
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.core.sampler import NFMCKernel
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.flows.train import fixed_effort_fit_config
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.samplers.mcmc import LangevinParameters
from nfmc_torch.samplers.nfmc import JumpMALA, JumpNFMCParameters

D, C = 6, 16
# short fits keep the CPU tests fast; the defaults are held elsewhere
FAST_FIT = {"early_stopping": True, "early_stopping_threshold": 5, "n_epochs": 10}


def _sampler(inner_n=2, n_warm=30, **params):
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=16), seed=0)
    target = DiagonalGaussian(np.linspace(-1, 1, D).astype(np.float32), np.float32(0.7))
    return JumpMALA((D,), target, kernel=NFMCKernel((D,), flow=flow),
                    params=JumpNFMCParameters(**params),
                    inner_params=LangevinParameters(n_iterations=inner_n,
                                                    n_warmup_iterations=n_warm),
                    device="cpu")


def _flat(flow):
    return torch.cat([t.reshape(-1) for p in flow.params for v in p.values() for t in v])


def test_warmup_tunes_and_fits():
    s = _sampler(flow_fit_kwargs=dict(FAST_FIT))
    assert s.params.n_jumps_before_training == 10
    assert s.params.warmup_fit_kwargs["lr"] == 0.005 and s.params.train_pct == 0.7
    before, step0 = _flat(s.kernel.flow).clone(), s.inner_sampler.kernel.step_size
    x0 = torch.randn((C, D), generator=torch.Generator().manual_seed(0))
    out = s.warmup(x0, show_progress=False, seed=0)
    assert out.samples.shape == (30, C, D) and torch.isfinite(out.samples).all()
    assert out.statistics.n_attempted_trajectories == 30 * C
    assert s.inner_sampler.kernel.step_size != pytest.approx(step0, rel=1e-6)
    after = _flat(s.kernel.flow)
    assert torch.isfinite(after).all() and not torch.equal(after, before)
    # the flow now describes the warmup draws better than the identity does
    draws = out.samples.reshape(-1, D)
    ident = Flow(RealNVP((D,), n_layers=2, hidden_size=16), seed=0)
    assert float(s.kernel.flow.log_prob(draws).mean()) > float(ident.log_prob(draws).mean())


def test_warmup_rolls_back_when_the_fit_raises(monkeypatch):
    s = _sampler(flow_fit_kwargs=dict(FAST_FIT))
    before = _flat(s.kernel.flow).clone()

    def failing_fit(self, x_train, **kwargs):
        self.params = [{k: [t + 1.0 for t in v] for k, v in p.items()} for p in self.params]
        raise ValueError("flow training diverged (non-finite loss)")

    monkeypatch.setattr(Flow, "fit", failing_fit)
    out = s.warmup(torch.zeros((C, D)), show_progress=False, seed=0)
    assert out.samples.shape == (30, C, D)
    assert torch.equal(_flat(s.kernel.flow), before)


@pytest.mark.parametrize("host", [False, True])
def test_fit_nf_refits_flow(host):
    """Fixed-effort kwargs refit inside the chunk runner; early stopping
    sends the outer loop to the host. The interleaving law, the counters and
    a trained flow hold on both."""
    inner_n, n_iter = 2, 4
    kw = dict(n_epochs=2, early_stopping=True) if host else dict(n_epochs=2)
    assert (fixed_effort_fit_config(kw) is None) == host
    s = _sampler(inner_n=inner_n, fit_nf=True, n_jumps_before_training=2, n_iterations=n_iter,
                 flow_fit_kwargs=kw)
    before = _flat(s.kernel.flow).clone()
    out = s.sample(torch.randn((8, D), generator=torch.Generator().manual_seed(0)),
                   show_progress=False, seed=1)
    st = out.statistics
    assert out.samples.shape == (n_iter * (inner_n + 1), 8, D)
    assert torch.isfinite(out.samples).all()
    assert st.n_attempted_jumps == n_iter * 8
    assert st.n_target_calls == n_iter * (inner_n * 2 * 8 + 2 * 8)
    assert st.n_attempted_trajectories == n_iter * inner_n * 8
    np.testing.assert_allclose(out.mean, out.samples.double().mean((0, 1)).numpy(), atol=1e-5)
    assert not torch.equal(_flat(s.kernel.flow), before)  # it trained


def test_fit_nf_gate_waits_for_n_jumps_before_training():
    s = _sampler(fit_nf=True, n_jumps_before_training=5, n_iterations=3,
                 flow_fit_kwargs=dict(n_epochs=1))
    before = _flat(s.kernel.flow).clone()
    s.sample(torch.zeros((8, D)), show_progress=False, seed=0)
    assert torch.equal(_flat(s.kernel.flow), before)


def test_front_door_warmup_takes_x0_from_the_warmup_draws(monkeypatch):
    seen = {}
    orig_sample = JumpMALA.sample

    def sample(self, x0, **kw):
        seen["x0"] = x0.clone()
        return orig_sample(self, x0, **kw)

    orig_warmup = JumpMALA.warmup

    def warmup(self, x0, **kw):
        seen["warm"] = out = orig_warmup(self, x0, **kw)
        return out

    monkeypatch.setattr(JumpMALA, "sample", sample)
    monkeypatch.setattr(JumpMALA, "warmup", warmup)
    kwargs = dict(strategy="jump_mala", flow=Flow(RealNVP((D,), n_layers=2, hidden_size=16), seed=0),
                  n_chains=C, n_iterations=3,
                  # the jump warmup runs the inner sampler's tuning length
                  inner_param_kwargs={"n_iterations": 2, "n_warmup_iterations": 10},
                  param_kwargs={"flow_fit_kwargs": dict(FAST_FIT)},
                  warmup=True, seed=0, show_progress=False, device="cpu")
    out = nfmc_torch.sample(StandardGaussian((D,)), **kwargs)
    assert out.samples.shape == (3 * 3, C, D)
    draws = seen["warm"].samples.reshape(-1, D)
    assert draws.shape == (10 * C, D)
    x0 = seen["x0"]
    # every chain starts at a warmup draw, and not all at the last state
    assert bool((x0[:, None, :] == draws[None]).all(-1).any(1).all())
    assert not torch.equal(x0, seen["warm"].running_samples.last_sample)
    # seeded
    again = nfmc_torch.sample(StandardGaussian((D,)), **{
        **kwargs, "flow": Flow(RealNVP((D,), n_layers=2, hidden_size=16), seed=0)})
    assert torch.equal(out.samples, again.samples)

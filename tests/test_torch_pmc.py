"""PMC in nfmc_torch against nfmc_tpu: ``_choose_delta`` on the same
inputs, the train scan with JAX's permutation injected (1e-4) and one pCN
sweep with JAX's draws (1e-5); then whole runs held to
``tests/test_transport.py``'s assertions, the 16-d pCN accuracy case
included."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import nfmc_tpu.transport as jtr
from nfmc_torch import transport as ttr
from nfmc_torch.flows import from_jax_params
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from tests.transport_parity import (FIT_TOL, FLOW, JPRIOR, JTARGET, PRIOR, STEP_TOL, TARGET,
                                   TRUE_LOG_Z, close, close_trees, flows, rows, t)
from tests.transport_parity import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---- PMC -----------------------------------------------------------------------------
def pmc_pair(**kw):
    jflow, flow = flows(pert=0.1)
    return (jtr.PreconditionedMonteCarlo(JPRIOR, JTARGET, jflow, **kw),
            ttr.PreconditionedMonteCarlo(PRIOR, TARGET, flow, **kw), jflow, flow)


def test_pmc_choose_delta_train_and_pcn_sweep():
    jp, tp, jflow, flow = pmc_pair(n_train_epochs=6, n_mcmc_steps=4)
    rng = np.random.default_rng(10)
    du = (rng.standard_normal(200) * 3.0).astype(np.float32)
    for lw, beta in ((np.full(200, -np.log(200.0)), 0.0), (rng.standard_normal(200) * 0.1, 0.4)):
        assert tp._choose_delta(du, lw, beta) == jp._choose_delta(du, lw, beta)
    x = rows(100, seed=11, shift=0.5)
    lw = (0.3 * rng.standard_normal(100)).astype(np.float32)
    key = jax.random.key(13)
    jparams, jlosses = jp._train(jflow.params, jnp.asarray(x), jnp.asarray(lw), key)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, 100)).astype(np.int64))
    params, losses = tp._train(flow.params, t(x), t(lw), perm)
    close(losses, np.asarray(jlosses), FIT_TOL, "losses")
    close_trees(params, jparams, FIT_TOL, "fitted params")
    key = jax.random.key(14)
    rho = np.float32(0.3)
    jx, jrho, jacc = jp._sweep(jparams, jnp.asarray(x), jnp.float32(0.5), rho, key)
    xi, unif = [], []
    for k in jax.random.split(key, 4):
        k_prop, k_acc = jax.random.split(k)
        xi.append(np.asarray(jax.random.normal(k_prop, x.shape)))
        unif.append(np.asarray(jax.random.uniform(k_acc, (100,))))
    got = tp._sweep(from_jax_params(jparams), t(x), 0.5, torch.tensor(rho),
                    (t(np.stack(xi)), t(np.stack(unif))))
    for a, b, what in zip(got, (jx, jrho, jacc), ("x", "rho_logit", "acceptance")):
        close(a, np.asarray(b), STEP_TOL, what)
    assert 0.0 < float(got[2]) < 1.0


def test_pmc():
    out = ttr.pmc(PRIOR, TARGET, FLOW, n_particles=256, seed=0, n_train_epochs=10,
                  n_mcmc_steps=5, device="cpu")
    assert np.isfinite(out["particles"]).all()
    assert out["beta_trace"][-1] == 1.0
    assert abs(out["log_Z"] - TRUE_LOG_Z) < 1.0
    assert np.abs(out["particles"].mean(0) - 2.0).max() < 0.5
    assert (np.diff(out["beta_trace"]) > 0).all()
    assert len(out["beta_trace"]) > 2


def test_pmc_pcn_log_z_accuracy():
    d = 16
    prior = StandardGaussian((d,))
    target = DiagonalGaussian(mu=np.full(d, 2.0), sigma=np.full(d, 0.5))
    out = ttr.pmc(prior, target, 'realnvp%{"n_layers": 2, "hidden_size": 32}', n_particles=512,
                  seed=0, n_train_epochs=20, n_mcmc_steps=10, device="cpu")
    assert out["beta_trace"][-1] == 1.0
    assert abs(out["log_Z"] - d * np.log(0.5)) < 0.4, out["log_Z"]
    assert 0.5 < out["acceptance_trace"].mean() < 0.9

"""FAB in nfmc_torch against nfmc_tpu: the AIS round toward p^2/q, the
replay training step, and whole iterations (the ring-buffer write, the
prioritized replay with JAX's Gumbel noise injected, the importance
correction of the buffered weights) with the same weights and the JAX
package's draws rebuilt from its keys (1e-5); then whole runs held to
``tests/test_transport.py``'s assertions, the divergent round, the no-op
run and the buffer-size check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.flow_training.fab import FAB as JFAB
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_torch.flow_training import FAB, fab, flow_annealed_importance_sampling_bootstrap_base
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.flows.train import _AdamW, _flatten
from nfmc_torch.ops.coupling import unpack_like
from nfmc_torch.utils import tree_leaves
from tests.transport_parity import (D, FLOW, JTARGET, STEP_TOL, TARGET, close, close_trees, t)
from tests.transport_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = STEP_TOL


def pair(buffer_size=100, **kw):
    jflow = JFlow(JRealNVP((D,), n_layers=2, hidden_size=16, use_pallas=False), seed=0)
    rng = np.random.default_rng(1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(RealNVP((D,), n_layers=2, hidden_size=16))
    flow.params = from_jax_params(jflow.params)
    return (JFAB(JTARGET, jflow, buffer_size=buffer_size, **kw),
            FAB(TARGET, flow, buffer_size=buffer_size, **kw))


def jax_ais_draws(jfab, key, n):
    """The AIS round's draws from its key: (k_draw, k_ais) = split(key); the
    base normal, then a key a level, a key a MALA step, (noise, accept)."""
    k_draw, k_ais = jax.random.split(key)
    z = t(jax.random.normal(k_draw, (n, D)))
    levels = []
    for kl in jax.random.split(k_ais, jfab.n_ais_steps):
        noise, unif = [], []
        for k in jax.random.split(kl, jfab.n_mcmc_steps):
            k_noise, k_acc = jax.random.split(k)
            noise.append(np.asarray(jax.random.normal(k_noise, (n, D))))
            unif.append(np.asarray(jax.random.uniform(k_acc, (n,))))
        levels.append((t(np.stack(noise)), t(np.stack(unif))))
    return z, levels


def test_ais_round_matches_jax():
    jf, tf = pair(n_ais_steps=4, n_mcmc_steps=2)
    key = jax.random.key(3)
    jx, jlw, jlq = jax.jit(jf._make_ais_round(), static_argnums=2)(jf.flow.params, key, 64)
    x, lw, lq = tf._ais_round(tf.flow.params, jax_ais_draws(jf, key, 64))
    for got, want, what in ((x, jx, "x"), (lw, jlw, "log_w"), (lq, jlq, "log_q")):
        close(got, np.asarray(want), TOL, what=what)
    shapes = tf.ais_draws(torch.Generator().manual_seed(0), 64)
    assert shapes[0].shape == (64, D) and len(shapes[1]) == 4


@pytest.mark.parametrize("enabled", [True, False])
def test_train_step_matches_jax(enabled):
    jf, tf = pair()
    rng = np.random.default_rng(4)
    x = (2.0 + 0.5 * rng.standard_normal((50, D))).astype(np.float32)
    lq_old = (rng.standard_normal(50) - 3.0).astype(np.float32)
    jp = jf.flow.params
    jp2, _, jloss, jlq = jax.jit(jf._make_train_step())(jp, jf.opt.init(jp), jnp.asarray(x),
                                                        jnp.asarray(lq_old), jnp.asarray(enabled))
    like = tf.flow.params
    theta = _flatten(like)
    theta2, loss, lq = tf._train_step(theta, _AdamW(theta, tf.lr), like, t(x), t(lq_old),
                                      torch.tensor(enabled))
    close(loss, np.asarray(jloss), TOL, what="loss")
    close(lq, np.asarray(jlq), TOL, what="log q new")
    close_trees(unpack_like(theta2, like), jp2, TOL, "params")
    assert torch.equal(theta2, theta) != enabled


def test_iterations_match_jax_with_the_gumbel_noise_injected():
    """Two iterations (the second wraps the ring) at buffer 100, 64 AIS
    particles, 6 replay steps of 20 draws: the buffer's rows, weights and
    densities, the fitted weights and the reported losses."""
    jf, tf = pair(buffer_size=100, n_ais_steps=3, n_mcmc_steps=2)
    n_it, n_steps, n_ais, n_train = 2, 6, 64, 20
    key = jax.random.key(5)
    jp = jf.flow.params
    run = jf._make_fused_run(n_it, n_steps, n_ais, n_train)
    jp2, _, jbuf, jlosses = run(jp, jf.opt.init(jp), jf._init_buffer(), key)
    like = tf.flow.params
    theta = _flatten(like)
    opt = _AdamW(theta, tf.lr)
    buf = tf._init_buffer(torch.device("cpu"))
    losses = []
    for k in jax.random.split(key, n_it):
        k_ais, k_train = jax.random.split(k)
        noise = [t(jax.random.gumbel(kt, (n_train, 100))) for kt in jax.random.split(k_train, n_steps)]
        theta, buf, loss = tf._iteration(theta, opt, like, buf, (jax_ais_draws(jf, k_ais, n_ais),
                                                                 noise))
        losses.append(loss)
    for got, want, what in zip(buf[:3], jbuf[:3], ("rows", "log w", "log q")):
        close(got, np.asarray(want), TOL, what=what)
    assert buf[3:] == (int(jbuf[3]), int(jbuf[4])) == (28, 100)
    close(torch.stack(losses), np.asarray(jlosses), TOL, what="losses")
    # Adam turns a gradient component within float32 error of 0 into a step
    # of +-lr whose sign is rounding's: a weight may part from JAX's by more
    # than TOL only there (the witness rule of chip_smoke.check_refit): its
    # RMS gradient over the run below 1e-5 of the largest; every other
    # weight within TOL
    want = torch.cat([b.reshape(-1) for b in tree_leaves(from_jax_params(jp2))])
    rms = (opt.nu / (1.0 - opt.b2 ** opt.count)).sqrt()
    parted = (theta - want).abs() > TOL * max(1.0, float(want.abs().max()))
    assert parted.sum() <= 16 and (rms[parted] <= 1e-5 * rms.max()).all(), (
        int(parted.sum()), rms[parted])


def test_fab():
    flow = fab(TARGET, FLOW, n_iterations=8, n_flow_training_steps=10, n_ais_particles=64,
               seed=0, device="cpu")
    s = flow.sample(256, seed=5)
    assert torch.isfinite(s).all()
    # bootstrap is slow at tiny budgets: assert clear movement toward mu=2
    assert float(s.mean()) > 0.3


def test_fab_survives_divergent_ais_round():
    """A divergent AIS sweep (absurd step on a quartic target) writes
    non-finite weights; sanitized rows and the train step's finite guard
    keep the weights finite, and with no finite buffered weight every step
    is vetoed (tests/test_transport.py's case)."""
    from nfmc_torch import create_flow_object

    quartic = lambda x: (x ** 4).sum(-1)
    f = create_flow_object(FLOW, (D,), seed=0)
    init = [p.clone() for p in tree_leaves(f.params)]
    alg = FAB(quartic, f, ais_step_size=1e6)
    flow = alg.run(n_iterations=6, n_flow_training_steps=5, n_ais_particles=64, seed=0)
    leaves = tree_leaves(flow.params)
    assert all(torch.isfinite(p).all() for p in leaves)
    assert torch.isfinite(flow.sample(128, seed=3)).all()
    if not torch.isfinite(alg._buf_state[1]).any():
        assert all(torch.equal(a, b) for a, b in zip(init, leaves)), \
            "params changed despite no valid replay row"
        assert torch.isnan(alg.loss_trace).all()


def test_fab_zero_iterations_noop_and_buffer_check():
    from nfmc_torch import create_flow_object

    f = create_flow_object(FLOW, (D,), seed=0)
    alg = FAB(TARGET, f)
    assert alg.run(n_iterations=0) is f
    assert alg.loss_trace.shape == (0,)
    with pytest.raises(ValueError, match="exceeds buffer_size"):
        FAB(TARGET, f, buffer_size=32).run(n_iterations=1, n_ais_particles=64, seed=0)
    # the buffer persists across runs: the second run appends to the first
    alg = FAB(TARGET, f, buffer_size=100, n_ais_steps=2)
    alg.run(n_iterations=1, n_flow_training_steps=2, n_ais_particles=30, seed=0)
    alg.run(n_iterations=1, n_flow_training_steps=2, n_ais_particles=30, seed=1)
    assert alg._buf_state[3:] == (60, 60)
    flow = flow_annealed_importance_sampling_bootstrap_base(
        TARGET, f, buffer_size=64, n_iterations=1, n_flow_training_steps=1, n_ais_particles=32,
        seed=0)
    assert flow is f


def test_fab_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fab(TARGET, FLOW, n_iterations=1)

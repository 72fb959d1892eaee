"""SNF in nfmc_torch against nfmc_tpu: the MALA, HMC and MH layers'
``delta_s`` with the JAX package's draws injected, the loss and its
gradient in the flow weights against ``jax.value_and_grad(SNF._loss)``
(second order in the potential through the HMC layers, 1e-5), a fit step;
then the whole run held to ``tests/test_transport.py``'s assertions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.transport import common as jcommon
from nfmc_torch import transport as ttr
from nfmc_torch.flows import RealNVP, from_jax_params
from nfmc_torch.flows.train import _flatten
from nfmc_torch.ops.coupling import unpack_like
from nfmc_torch.transport import common as tcommon
from nfmc_torch.utils import tree_leaves
from tests.transport_parity import (D, JPRIOR, JTARGET, PRIOR, STEP_TOL, TARGET, close,
                                   close_trees, jsnf, rows, t, tsnf)
from tests.transport_parity import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---- SNF -----------------------------------------------------------------------------
def jax_layer_draws(layer, key, shape):
    if isinstance(layer, jsnf.MALALayer):
        return t(jax.random.normal(key, shape))
    if isinstance(layer, jsnf.FlowLayer):
        return None
    a, b = [], []
    for k in jax.random.split(key, layer.n_steps):
        k1, k2 = jax.random.split(k)
        a.append(np.asarray(jax.random.normal(k1, shape)))
        b.append(np.asarray(jax.random.uniform(k2, (shape[0],))))
    return t(np.stack(a)), t(np.stack(b))


@pytest.mark.parametrize("kind", ["mala", "hmc", "mh"])
def test_snf_stochastic_layers_match_jax(kind):
    make = {"mala": lambda m: m.MALALayer((D,), time_step=0.1, beta=1.5),
            "hmc": lambda m: m.HMCLayer((D,), n_steps=2, n_leapfrog=4, step_size=0.15),
            "mh": lambda m: m.MHLayer((D,), n_steps=4, step_size=0.4)}[kind]
    jl, tl = make(jsnf), make(tsnf)
    ju = jcommon.tempered(JPRIOR, JTARGET)
    tu = tcommon.tempered(PRIOR, TARGET)
    x = rows(64, seed=16)
    key = jax.random.key(17)
    jx, jds = jl.apply((), jnp.asarray(x), lambda v: ju(v, 0.6), key)
    tx, tds = tl.apply((), t(x), lambda v: tu(v, 0.6), jax_layer_draws(jl, key, x.shape))
    close(tx, np.asarray(jx), STEP_TOL, "x")
    close(tds, np.asarray(jds), STEP_TOL, "delta_s")
    shapes = tl.draws(torch.Generator().manual_seed(0), x.shape)
    assert (shapes.shape if kind == "mala" else tuple(a.shape[0] for a in shapes)) in (
        (64, D), (2, 2), (4, 4))


def snf_pair():
    """SNF [HMC, RealNVP, HMC, RealNVP, HMC] in both packages with the same
    perturbed flow weights."""
    def layers(m, flow_cls, **kw):
        return [m.HMCLayer((D,), n_steps=2, n_leapfrog=5), m.FlowLayer(flow_cls((D,), n_layers=2,
                                                                               hidden_size=8, **kw)),
                m.HMCLayer((D,), n_steps=2, n_leapfrog=5), m.FlowLayer(flow_cls((D,), n_layers=2,
                                                                               hidden_size=8, **kw)),
                m.HMCLayer((D,), n_steps=2, n_leapfrog=5)]

    jm = jsnf.SNF(layers(jsnf, JRealNVP, use_pallas=False), JTARGET, JPRIOR, seed=0)
    rng = np.random.default_rng(18)
    jm.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.standard_normal(p.shape).astype(np.float32), jm.params)
    tm = tsnf.SNF(layers(tsnf, RealNVP), TARGET, PRIOR, seed=0, device="cpu")
    tm.params = from_jax_params(jm.params)
    return jm, tm


def test_snf_loss_gradient_through_the_hmc_layers_is_second_order():
    """SNF's loss and its gradient in the flow weights against
    ``jax.value_and_grad(SNF._loss)`` with the same draws: the HMC layers
    after each flow layer contribute grad U's Hessian, which a detached
    grad U (``utils.batched_grad``) drops."""
    jm, tm = snf_pair()
    z = rows(48, seed=19)
    key = jax.random.key(20)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm._loss))(jm.params, jnp.asarray(z), key)
    draws = [jax_layer_draws(l, k, z.shape)
             for l, k in zip(jm.layers, jax.random.split(key, len(jm.layers)))]
    like = tm.params
    theta = _flatten(like)
    loss, g = tcommon.flat_value_and_grad(lambda p: tm._loss(p, t(z), draws), theta, like)
    close(loss, np.asarray(jloss), STEP_TOL, "loss")
    close_trees(unpack_like(g, like), jgrads, STEP_TOL, "gradient")
    # the first-order-only gradient misses: the test discriminates
    orig = tsnf._grad_u
    try:
        tsnf._grad_u = lambda pot, x: tsnf.batched_grad(pot)(x)
        _, g1 = tcommon.flat_value_and_grad(lambda p: tm._loss(p, t(z), draws), theta, like)
    finally:
        tsnf._grad_u = orig
    want = np.concatenate([b.numpy().ravel() for b in tree_leaves(from_jax_params(jgrads))])
    assert np.abs(g1.numpy() - want).max() > 1e-3 * max(1.0, np.abs(want).max())


def test_snf_inverse_matches_jax_with_its_draws():
    """SNF's inverse (history, particles, log-weights) through a layer of
    each kind (MALA, RealNVP, HMC, MH) with the JAX package's draws: the
    unsharded path that a sharded batch cuts its rows from."""
    def layers(m, flow_cls, **kw):
        return [m.MALALayer((D,), time_step=0.1), m.FlowLayer(flow_cls((D,), n_layers=2,
                                                                       hidden_size=8, **kw)),
                m.HMCLayer((D,), n_steps=2, n_leapfrog=3), m.MHLayer((D,), n_steps=3)]

    jm = jsnf.SNF(layers(jsnf, JRealNVP, use_pallas=False), JTARGET, JPRIOR, seed=0)
    rng = np.random.default_rng(25)
    jm.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.2 * rng.standard_normal(p.shape).astype(np.float32), jm.params)
    tm = tsnf.SNF(layers(tsnf, RealNVP), TARGET, PRIOR, seed=0, device="cpu")
    tm.params = from_jax_params(jm.params)
    z = rows(40, seed=26)
    key = jax.random.key(27)
    jhist, jx, jlw = jm.inverse(jnp.asarray(z), key=key)
    draws = [jax_layer_draws(l, k, z.shape)
             for l, k in zip(jm.layers, jax.random.split(key, len(jm.layers)))]
    with torch.no_grad():
        hist, x, lw = tm._inverse_impl(tm.params, t(z), draws)
    close(hist, np.asarray(jhist), STEP_TOL, "history")
    close(x, np.asarray(jx), STEP_TOL, "x")
    close(lw, np.asarray(jlw), STEP_TOL, "log_weights")


def test_snf_fit_step_and_inverse_shapes():
    jm, tm = snf_pair()
    z = rows(32, seed=21)
    before = _flatten(tm.params).clone()
    tm.fit(z, n_epochs=2, seed=0)
    assert not torch.equal(_flatten(tm.params), before)
    hist, x, lw = tm.inverse(z, seed=1)
    assert hist.shape == (6, 32, D) and torch.isfinite(x).all() and torch.isfinite(lw).all()


def test_snf():
    out = ttr.snf(PRIOR, TARGET, n_particles=64, n_epochs=2, seed=0, device="cpu")
    assert np.isfinite(out["particles"]).all()
    assert np.abs(out["particles"].mean(0) - 2.0).max() < 1.0
    assert out["history"].shape[0] == 6  # 5 layers + initial

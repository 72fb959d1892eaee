"""Shared pieces of the transport parity tests (``test_torch_transport``,
``test_torch_pmc``, ``test_torch_snf``, ``test_torch_fab``): the d=3 targets
of ``tests/test_transport.py`` in both packages, a RealNVP pair with the same
weights, the closeness rule, the JAX package's draws rebuilt from its keys,
and one torch thread a test."""
import importlib

import jax
import numpy as np
import pytest
import torch

from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.potentials import DiagonalGaussian as JDiagonalGaussian
from nfmc_tpu.potentials import StandardGaussian as JStandardGaussian
from nfmc_torch.flows import Flow, RealNVP, from_jax_params
from nfmc_torch.potentials import DiagonalGaussian, StandardGaussian
from nfmc_torch.utils import tree_leaves

# the packages export the function ``snf`` under the module's name
jsnf = importlib.import_module("nfmc_tpu.transport.snf")
tsnf = importlib.import_module("nfmc_torch.transport.snf")

D = 3
JPRIOR, PRIOR = JStandardGaussian((D,)), StandardGaussian((D,))
JTARGET = JDiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
TARGET = DiagonalGaussian(mu=np.full(D, 2.0), sigma=np.full(D, 0.5))
TRUE_LOG_Z = D * np.log(0.5)
FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 16}'
STEP_TOL, FIT_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these eager loops of small operations slow down
    by two orders of magnitude when the pytest workers' thread pools
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|), with infinities equal."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def close_trees(got, want_jax, tol, what=""):
    want = tree_leaves(from_jax_params(want_jax))
    got = tree_leaves(got)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b.numpy(), tol, f"{what} leaf {i}")


def flows(d=D, hidden=16, pert=0.3, seed=0):
    """A JAX RealNVP (plain XLA path) with its weights moved ``pert`` N(0, 1)
    from the init, and the port's with the same weights."""
    jflow = JFlow(JRealNVP((d,), n_layers=2, hidden_size=hidden, use_pallas=False), seed=seed)
    rng = np.random.default_rng(seed + 1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + pert * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    flow = Flow(RealNVP((d,), n_layers=2, hidden_size=hidden))
    flow.params = from_jax_params(jflow.params)
    return jflow, flow


def rows(n, d=D, seed=0, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---- JAX's draws, rebuilt from its keys -----------------------------------------
def jax_sweep_draws(key, n_steps, shape):
    """``make_mala_sweep``'s draws: a key a step, split into (noise, accept)."""
    noise, unif = [], []
    for k in jax.random.split(key, n_steps):
        k_noise, k_acc = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_noise, shape)))
        unif.append(np.asarray(jax.random.uniform(k_acc, (shape[0],))))
    return t(np.stack(noise)), t(np.stack(unif))


def jax_chain_draws(key, n_levels, n_steps, shape):
    return [jax_sweep_draws(k, n_steps, shape) for k in jax.random.split(key, n_levels)]

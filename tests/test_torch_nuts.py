"""NUTS of nfmc_torch against nfmc_tpu's with the same numbers.

The JAX package derives each chain's randomness from a key chain that does
not depend on the state: ``split(key_c)`` gives the momentum, each doubling
``split(key, 4)`` the direction, the merge uniform and the subtree's key,
whose own chain gives one uniform a leaf. The tests rebuild exactly those
numbers with ``jax.random`` and hand them to the port's batched step:
states to 1e-5, per-chain leapfrog counts, divergence flags and moved
masks exactly, acceptance statistics to 1e-5; trees of depth >= 4 with
backward subtrees, a forced divergence (a potential that is NaN beyond a
radius), dual averaging in tuning steps, the counters and the front door.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.samplers.mcmc.nuts import NUTS as JNUTS
from nfmc_tpu.samplers.mcmc.nuts import NUTSKernel as JNUTSKernel
from nfmc_tpu.samplers.mcmc.nuts_impl import make_nuts_step as j_make_nuts_step
from nfmc_torch.flows.convert import from_jax_metropolis_state
from nfmc_torch.potentials import CallablePotential, StandardGaussian
from nfmc_torch.samplers.mcmc import NUTS, NUTSKernel
from nfmc_torch.samplers.mcmc.nuts_impl import make_nuts_step

TOL = 1e-5
D, C = 5, 8


def chain_draws(chain_keys, d, max_depth):
    """The numbers ``nuts_impl.single_chain_step`` consumes, per chain key:
    ``(p_raw (C, d), go_right (C, depth), merge_u (C, depth), leaf_u (C,
    2^depth - 1))``."""

    def one(key):
        key, k_mom = jax.random.split(key)
        p_raw = jax.random.normal(k_mom, (d,))
        dirs, merges, leaves = [], [], []
        for j in range(max_depth):
            key, k_dir, k_merge, k_sub = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(k_dir))
            merges.append(jax.random.uniform(k_merge, ()))

            def leaf(s, _):
                s, k_acc = jax.random.split(s)
                return s, jax.random.uniform(k_acc, ())

            leaves.append(jax.lax.scan(leaf, k_sub, None, length=1 << j)[1])
        return p_raw, jnp.stack(dirs), jnp.stack(merges), jnp.concatenate(leaves)

    return tuple(torch.from_numpy(np.array(a)) for a in jax.jit(jax.vmap(one))(chain_keys))


def _diag(sigma):
    s = np.asarray(sigma, np.float32)

    def jax_u(x):
        return 0.5 * jnp.sum((x / s) ** 2, -1)

    def torch_u(x):
        return 0.5 * ((x / torch.from_numpy(s)) ** 2).sum(-1)

    return jax_u, CallablePotential(torch_u, (len(s),))


def _nan_beyond(radius):
    """N(0, I) inside the ball of ``radius``, NaN outside."""
    def jax_u(x):
        r2 = jnp.sum(x * x, -1)
        return jnp.where(r2 > radius ** 2, jnp.nan, 0.5 * r2)

    def torch_u(x):
        r2 = (x * x).sum(-1)
        return torch.where(r2 > radius ** 2, torch.full_like(r2, float("nan")), 0.5 * r2)

    return jax_u, CallablePotential(torch_u, (D,))


def _per_chain(jax_u, torch_u, x0, eps, imd, max_depth, seed):
    """Each chain through the JAX step on its own (its own key), all of them
    through the port's batched step with those keys' numbers."""
    jstep = jax.jit(j_make_nuts_step(jax_u, (D,), max_tree_depth=max_depth))
    keys = jax.random.split(jax.random.key(seed), C)
    rows = [jstep(jnp.asarray(x0[c:c + 1]), jnp.float32(eps), jnp.asarray(imd), keys[c])
            for c in range(C)]
    # a one-chain call splits its key once more
    draws = chain_draws(jnp.stack([jax.random.split(k, 1)[0] for k in keys]), D, max_depth)
    tstep = make_nuts_step(torch_u, (D,), max_tree_depth=max_depth)
    got = tstep(torch.from_numpy(x0), torch.tensor(eps, dtype=torch.float32),
                torch.from_numpy(imd), draws)
    return rows, got, draws


@pytest.mark.parametrize("case", ["deep", "anisotropic"])
def test_nuts_step_matches_jax_chain_by_chain(case):
    """Trees of depth >= 4 with backward subtrees: every chain's end state,
    leapfrog count, acceptance statistic, moved flag and divergence flag."""
    rng = np.random.default_rng(0 if case == "deep" else 1)
    sigma = np.ones(D) if case == "deep" else 0.5 + 2 * rng.random(D)
    jax_u, torch_u = _diag(sigma)
    x0 = rng.standard_normal((C, D)).astype(np.float32)
    imd = (np.ones(D) if case == "deep" else 0.5 + rng.random(D)).astype(np.float32)
    rows, got, draws = _per_chain(jax_u, torch_u, x0, 0.1, imd, 6, seed=3)
    z, moved, diverged, accept_stat, n_leapfrog, depth = got
    for c, (jz, jmoved, jdiv, jacc, jtotal) in enumerate(rows):
        assert float(np.max(np.abs(z[c].numpy() - np.asarray(jz)[0]))) <= TOL * max(
            1.0, float(np.abs(np.asarray(jz)).max()))
        assert int(n_leapfrog[c]) == int(jtotal) - 1  # the total counts the start's call
        assert bool(moved[c]) == bool(jmoved[0]) and bool(diverged[c]) == bool(jdiv)
        assert abs(float(accept_stat[c]) - float(jacc[0])) <= TOL
    assert int(depth.max()) >= 4
    # some chain walked a backward subtree of a tree it kept growing
    used = torch.arange(6)[None] < depth[:, None]
    assert bool((used & ~draws[1]).any())


def test_nuts_forced_divergence_matches_jax():
    """A potential that is NaN beyond a radius: the trajectories that leave
    the ball diverge (a NaN energy), count acceptance 0 there, keep a finite
    state, and agree with the JAX package chain by chain."""
    jax_u, torch_u = _nan_beyond(2.5)
    rng = np.random.default_rng(2)
    x0 = (0.5 * rng.standard_normal((C, D))).astype(np.float32)
    rows, got, _ = _per_chain(jax_u, torch_u, x0, 0.4, np.ones(D, np.float32), 5, seed=4)
    z, moved, diverged, accept_stat, n_leapfrog, _ = got
    assert bool(diverged.any()) and not bool(diverged.all())
    assert bool(torch.isfinite(z).all()) and bool(torch.isfinite(accept_stat).all())
    for c, (jz, jmoved, jdiv, jacc, jtotal) in enumerate(rows):
        assert float(np.max(np.abs(z[c].numpy() - np.asarray(jz)[0]))) <= TOL
        assert int(n_leapfrog[c]) == int(jtotal) - 1
        assert bool(diverged[c]) == bool(jdiv) and bool(moved[c]) == bool(jmoved[0])
        assert abs(float(accept_stat[c]) - float(jacc[0])) <= TOL


def test_nuts_tuning_steps_match_jax():
    """Four tuning steps of the samplers with the keys' numbers: states, the
    dual-averaged step size and its state, the inverse mass, the moved
    count and the counters (sum of the leapfrogs + C)."""
    jax_u, torch_u = _diag(0.5 + np.arange(D) / D)
    js = JNUTS((D,), jax_u, JNUTSKernel(event_size=D, max_tree_depth=5, step_size=0.3))
    ts = NUTS((D,), torch_u, NUTSKernel(event_size=D, max_tree_depth=5, step_size=0.3),
              device="cpu")
    js.params.imd_adjustment = ts.params.imd_adjustment = 0.2
    jstep, tstep = jax.jit(js._make_step(True)), ts._make_step_aux(True)
    x0 = np.random.default_rng(5).standard_normal((C, D)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jm = js.kernel.make_state()
    tm = from_jax_metropolis_state(jm)
    for it in range(4):
        key = jax.random.key(10 + it)
        jx, jm, jinfo = jstep(jx, jm, key)
        draws = chain_draws(jax.random.split(key, C), D, 5)
        tx, tm, tinfo = tstep(tx, tm, draws)
        assert float(np.max(np.abs(tx.numpy() - np.asarray(jx)))) <= TOL
        assert int(tinfo.n_accepted) == int(jinfo.n_accepted)
        assert int(tinfo.n_calls) == int(jinfo.n_calls) == int(tinfo.n_grads)
        assert int(tinfo.diverged) == int(jinfo.diverged)
        np.testing.assert_allclose(float(tm.step_size), float(jm.step_size), rtol=TOL)
        for f in ("t", "error_sum", "log_step_averaged", "mu"):
            np.testing.assert_allclose(float(getattr(tm.da, f)), float(getattr(jm.da, f)),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tm.inv_mass_diag.numpy(), np.asarray(jm.inv_mass_diag),
                                   rtol=TOL)
    assert abs(float(tm.step_size) - 0.3) > 1e-3


def test_nuts_draws_and_counters():
    s = NUTS((2, 3), StandardGaussian((2, 3)), NUTSKernel(event_size=6, max_tree_depth=4),
             device="cpu")
    p_raw, go_right, merge_u, leaf_u = s.make_draws()(torch.Generator().manual_seed(0), (3,), C)
    assert p_raw.shape == (3, C, 6) and go_right.dtype == torch.bool
    assert go_right.shape == merge_u.shape == (3, C, 4) and leaf_u.shape == (3, C, 15)
    assert s.hoisted_elements_per_iter(torch.zeros(C, 2, 3)) == C * (6 + 8 + 15)
    assert s.calls_per_iter(C) == s.grads_per_iter(C) == 0
    out = s.sample(torch.zeros(C, 2, 3), show_progress=False, seed=0)
    st = out.statistics
    mean_depth, max_depth = s.tree_depths()
    assert out.samples.shape == (100, C, 2, 3) and torch.isfinite(out.samples).all()
    # every iteration: the leapfrogs and one evaluation a chain at the start
    assert st.n_target_calls == st.n_target_gradient_calls > 100 * C
    assert 1 <= mean_depth <= max_depth <= 4


def test_nuts_front_door_with_warmup():
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((4,)), strategy="nuts", n_chains=6,
                                 n_iterations=5, n_warmup_iterations=6, device="cpu", seed=0,
                                 show_progress=False, kernel_kwargs={"max_tree_depth": 5}, **kw)

    out = run()
    assert out.samples.shape == (5, 6, 4) and torch.isfinite(out.samples).all()
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    assert abs(warm.kernel.step_size - 0.1) > 1e-4  # dual averaging moved it
    assert warm.statistics.n_target_calls == warm.statistics.n_target_gradient_calls > 5 * 6

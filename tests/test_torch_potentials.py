"""Every potential of nfmc_torch.potentials against nfmc_tpu's on the same
numpy inputs: U(x) within 1e-5 relative (float32 on both sides), the
gradient against jax.grad within 1e-4 relative, the analytic moments equal,
and the exact samplers' shapes and moments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfmc_tpu.potentials as J
import nfmc_torch.potentials as T

RNG = np.random.default_rng(0)
_MEANS = RNG.standard_normal((3, 4)).astype(np.float32) * 2
_L = np.tril(RNG.standard_normal((4, 4))).astype(np.float32) + 3 * np.eye(4, dtype=np.float32)
_MU = RNG.standard_normal(4).astype(np.float32)

# name -> (constructor arguments, the input's scale)
CASES = {
    "StandardGaussian": (lambda m: m.StandardGaussian((5,)), 1.0),
    "DiagonalGaussian": (lambda m: m.DiagonalGaussian(_MU, np.float32(1.5)), 1.0),
    "DiagonalGaussian1": (lambda m: m.DiagonalGaussian1(30), 3.0),
    "FullRankGaussian": (lambda m: m.FullRankGaussian(_MU, _L), 2.0),
    "Funnel": (lambda m: m.Funnel(6), 1.0),
    "Rosenbrock": (lambda m: m.Rosenbrock(6), 1.0),
    "GaussianMixture": (lambda m: m.GaussianMixture(_MEANS, sigma=0.8), 2.0),
    "DoubleWell": (lambda m: m.DoubleWell((3, 2)), 1.5),
    "BayesianLogisticRegression": (lambda m: m.BayesianLogisticRegression.synthetic(n=50, d=6, seed=3), 1.0),
    "Phi4Lattice": (lambda m: m.Phi4Lattice(L=5), 1.0),
    "StudentT": (lambda m: m.StudentT(n_dim=5, df=3.0), 2.0),
    "EightSchools": (lambda m: m.EightSchools(), 1.0),
}


def _pair(name):
    make, scale = CASES[name]
    return make(J), make(T), scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_potential_matches_jax(name):
    jp, tp, scale = _pair(name)
    assert tp.event_shape == jp.event_shape
    x = (scale * np.random.default_rng(1).standard_normal((7, *jp.event_shape))).astype(np.float32)
    want = np.asarray(jp(jnp.asarray(x)))
    got = tp(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the gradient every sampler takes: one autograd pass over the sum
    g_want = np.asarray(jax.grad(lambda v: jp(v).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g_got,) = torch.autograd.grad(tp(xt).sum(), xt)
    np.testing.assert_allclose(g_got.numpy(), g_want, rtol=1e-4, atol=1e-4 * np.abs(g_want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_analytic_moments_match_jax(name):
    jp, tp, _ = _pair(name)
    for attr in ("mean", "second_moment"):
        want, got = getattr(jp, attr), getattr(tp, attr)
        assert (want is None) == (got is None), attr
        if want is not None:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


SAMPLED = ["StandardGaussian", "DiagonalGaussian", "DiagonalGaussian1", "FullRankGaussian",
           "Funnel", "StudentT", "GaussianMixture"]


@pytest.mark.parametrize("name", SAMPLED)
def test_exact_sampler(name):
    """Draws of the right shape on the generator's device, seeded, with the
    analytic moments within 5 standard errors where they are finite."""
    _, tp, _ = _pair(name)
    n = 20000
    a = tp.sample((n,), generator=torch.Generator().manual_seed(2))
    assert a.shape == (n, *tp.event_shape) and a.dtype == torch.float32
    assert torch.equal(a, tp.sample((n,), generator=torch.Generator().manual_seed(2)))
    assert tp.sample((2, 3)).shape == (2, 3, *tp.event_shape)
    x = a.double().numpy()
    if tp.mean is not None and name != "Funnel":  # the funnel's x_i have huge variance
        se = x.std(0) / np.sqrt(n)
        assert np.all(np.abs(x.mean(0) - tp.mean) < 5 * se + 1e-9)
    if tp.second_moment is not None and name not in ("Funnel", "StudentT"):
        se = (x ** 2).std(0) / np.sqrt(n)
        assert np.all(np.abs((x ** 2).mean(0) - tp.second_moment) < 5 * se)
    if name == "StudentT":  # nu = 3: E[x^2] = 3 has no finite variance; check the median |x|
        np.testing.assert_allclose(np.median(np.abs(x)), 0.7649, atol=0.03)


def test_no_exact_sampler_raises():
    with pytest.raises(NotImplementedError, match="no exact sampler"):
        T.Rosenbrock(3).sample((2,))


def test_logistic_regression_synthetic_data_is_the_jax_data():
    jp = J.BayesianLogisticRegression.synthetic(seed=5)
    tp = T.BayesianLogisticRegression.synthetic(seed=5)
    assert np.array_equal(tp.X, jp.X) and np.array_equal(tp.y, jp.y)
    assert tp.event_shape == (25,) and set(np.unique(tp.y)) == {-1.0, 1.0}


def test_phi4_takes_a_matrix_event_with_batch_dims():
    jp, tp, _ = _pair("Phi4Lattice")
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 5)).astype(np.float32)
    got = tp(torch.from_numpy(x))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp(jnp.asarray(x))), rtol=1e-5)


def test_eight_schools_checks_its_data():
    with pytest.raises(ValueError, match="differ in shape"):
        T.EightSchools(y=np.zeros(3), sigma=np.ones(4))

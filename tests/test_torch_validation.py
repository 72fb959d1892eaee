"""The port's two-sample validation (a NumPy copy of nfmc_tpu.validation,
which the chip script uses without the JAX package) against the JAX
package's: the same statistics, p-values and verdicts on the same stacks."""
import numpy as np
import pytest

from nfmc_tpu import validation as jv
from nfmc_torch import validation as tv


@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_two_sample_report_matches_the_jax_package(shift):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((80, 12, 3))
    b = rng.standard_normal((64, 10, 3)) + shift
    got = tv.mcmc_two_sample_report(a, b, alpha=0.05, n_perm=50, rng=np.random.default_rng(1))
    want = jv.mcmc_two_sample_report(a, b, alpha=0.05, n_perm=50, rng=np.random.default_rng(1))
    assert got == want
    assert got["ok"] == (shift == 0.0)


def test_statistics_match_the_jax_package():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((40, 4)), rng.standard_normal((30, 4)) + 0.1
    assert tv.ks_statistic(a[:, 0], b[:, 0]) == jv.ks_statistic(a[:, 0], b[:, 0])
    assert tv.energy_distance(a, b) == jv.energy_distance(a, b)
    stack = rng.standard_normal((50, 6, 2))
    np.testing.assert_array_equal(tv.per_dim_ess(stack), jv.per_dim_ess(stack))

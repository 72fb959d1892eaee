"""nfmc_torch's core runtime against nfmc_tpu's: the sample store, the
statistics, the compensated sums and the chunk schedule."""
import math

import numpy as np
import pytest
import torch

from nfmc_tpu.core.driver import chunk_schedule as jax_chunk_schedule
from nfmc_tpu.core.samples import MCMCSamples as JMCMCSamples
from nfmc_torch.core.driver import StatsAccum, StepInfo, _compensated_add, chunk_schedule
from nfmc_torch.core.samples import MCMCSamples
from nfmc_torch.core.statistics import JumpNFMCStatistics
from nfmc_torch.flows import Flow, RealNVP
from nfmc_torch.potentials import StandardGaussian
from nfmc_torch.samplers.mcmc import LangevinParameters
from nfmc_torch.samplers.nfmc import JumpMALA, JumpNFMCParameters
from nfmc_torch.core.sampler import NFMCKernel


@pytest.mark.parametrize("thinning,max_samples", [(1, None), (3, None), (1, 5), (2, 4)])
def test_sample_store_matches_jax(thinning, max_samples):
    blocks = [np.random.default_rng(i).standard_normal((k, 3, 2)).astype(np.float32)
              for i, k in enumerate((4, 1, 6))]
    ours = MCMCSamples((2,), thinning=thinning, max_samples=max_samples)
    ref = JMCMCSamples((2,), thinning=thinning, max_samples=max_samples)
    for b in blocks:
        ours.add(torch.from_numpy(b))
        ref.add(b)
    ours.add(torch.from_numpy(blocks[0][0]))  # a single (n_chains, *event) state
    ref.add(blocks[0][0])
    assert ours.n_samples == ref.n_samples and ours.seen_samples == ref.seen_samples
    np.testing.assert_array_equal(ours.as_tensor().numpy(), ref.as_tensor())
    np.testing.assert_array_equal(ours.last_sample.numpy(), ref.last_sample)
    np.testing.assert_array_equal(ours[-1].numpy(), np.asarray(ref[-1]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


def test_store_without_samples_keeps_only_the_last_state():
    s = MCMCSamples((2,), store_samples=False)
    s.add(torch.ones(4, 3, 2))
    assert s.n_samples == 0 and s.seen_samples == 0
    assert torch.equal(s.last_sample, torch.ones(3, 2))
    with pytest.raises(ValueError, match="trailing dims"):
        s.add(torch.ones(4, 3, 5))


def test_statistics_rates_and_formats():
    st = JumpNFMCStatistics((2,))
    assert math.isnan(st.acceptance_rate) and math.isnan(st.jump_acceptance_rate)
    st.update_counters(n_accepted_trajectories=3, n_attempted_trajectories=4,
                       n_target_calls=10, n_accepted_jumps=1, n_attempted_jumps=2)
    st.update_elapsed_time(2.0)
    st.update_moments_from_sums(np.array([2.0, 4.0]), np.array([4.0, 10.0]), 2)
    assert st.acceptance_rate == 0.75 and st.jump_acceptance_rate == 0.5
    np.testing.assert_allclose(st.running_variance, [1.0, 1.0])
    assert repr(st).startswith("MCMC acc-rate: 0.75, Jump acc-rate: 0.50, kcalls/s: 0.01")
    d = st.as_dict()
    assert d["jump_acceptance_rate"] == 0.5 and d["calls_per_second"] == 5.0
    with pytest.raises(TypeError):
        st.update_counters(1)  # the jump counters are keyword-only


def test_compensated_sums_stay_exact():
    """1e6 additions of 0.1 in float32: the plain sum drifts, the Neumaier
    pair does not."""
    v = torch.full((2,), 0.1)
    s, c = torch.zeros(2), torch.zeros(2)
    acc = StatsAccum.zeros((2,), "cpu")
    info = StepInfo(n_accepted=torch.tensor(1, dtype=torch.int32),
                    diverged=torch.tensor(0, dtype=torch.int32))
    for _ in range(20000):
        s, c = _compensated_add(s, c, v)
    for _ in range(100):
        acc = acc.add(info, v[None])
    assert abs(float(s[0] + c[0]) - 2000.0) < 1e-3
    assert int(acc.n_accepted) == 100
    assert abs(float(acc.moment_sums()[0][0]) - 10.0) < 1e-5


@pytest.mark.parametrize("n,max_chunk", [(1, 64), (7, 64), (100, 64), (1000, 256), (37, 16)])
def test_chunk_schedule_matches_jax(n, max_chunk):
    assert list(chunk_schedule(n, max_chunk)) == list(jax_chunk_schedule(n, max_chunk))


def test_time_limited_run_syncs_per_chunk_and_stops():
    s = JumpMALA((3,), StandardGaussian((3,)),
                 kernel=NFMCKernel((3,), flow=Flow(RealNVP((3,), n_layers=2, hidden_size=8), seed=0)),
                 params=JumpNFMCParameters(n_iterations=50),
                 inner_params=LangevinParameters(n_iterations=2), device="cpu")
    x0 = torch.zeros(4, 3)
    out = s.sample(x0, show_progress=False, time_limit_seconds=1e-9, seed=0)
    # the limit is checked before each chunk: the first chunk (1 iteration) runs
    assert out.statistics.n_attempted_jumps == 4
    assert out.samples.shape == (3, 4, 3)
    full = s.sample(x0, show_progress=False, time_limit_seconds=1e6, seed=0)
    assert full.samples.shape == (150, 4, 3) and full.statistics.n_attempted_jumps == 200


def test_dynamic_counters_stay_exact_past_int32():
    """NUTS-style device counts and ChEES-style host counts: 3000 steps of
    2^23 + 1 calls each (below 2^24, so each float32 add is exact) sum to
    past 2^31 without a lost call, as the JAX package's compensated pairs
    (nfmc_tpu/core/driver.py:149-221)."""
    from nfmc_torch.core.driver import StatsAccum, StepInfo

    acc = StatsAccum.zeros((2,), "cpu")
    x = torch.zeros((3, 2))
    zero = torch.zeros((), dtype=torch.int32)
    v = (1 << 23) + 1
    for _ in range(3000):
        acc = acc.add(StepInfo(zero, zero, n_calls=torch.tensor(v, dtype=torch.int32),
                               n_grads=v - 1), x)
    calls, grads = acc.dynamic_counts()
    assert calls == 3000 * v > 2 ** 31 and grads == 3000 * (v - 1)
    assert acc.host_calls == 0 and acc.host_grads == 3000 * (v - 1)

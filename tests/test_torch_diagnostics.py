"""The port's ESS and split R-hat (nfmc_torch.diagnostics) and the
diagnostic methods of its MCMCOutput, held against nfmc_tpu's on the same
numpy chains: float32 on both sides, ESS and R-hat within 1e-3 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfmc_tpu import diagnostics as jdiag
from nfmc_tpu.core.output import MCMCOutput as JMCMCOutput
from nfmc_torch import diagnostics as tdiag
from nfmc_torch.core.output import MCMCOutput

RTOL = 1e-3


def _ar1(phi, n, c, d, seed):
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((n, c, d))
    x = np.zeros((n, c, d))
    for t in range(n):
        x[t] = (phi * x[t - 1] if t else 0.0) + eps[t]
    return x.astype(np.float32)


def _antithetic_mix(n=4096, c=8):
    """Mostly an antithetic AR(-0.5) mode with a heavy slow AR(0.9) tail:
    Geyer pairs at odd offsets would truncate the slow tail
    (tests/test_diagnostics.py)."""
    fast, slow = _ar1(-0.5, n, c, 1, 1), _ar1(0.9, n, c, 1, 2)
    return (np.sqrt(0.88) * fast / fast.std() + np.sqrt(0.12) * slow / slow.std()).astype(np.float32)


def _stuck_mix():
    healthy = np.random.default_rng(7).standard_normal((1000, 3, 2)).astype(np.float32)
    return np.concatenate([healthy, np.full((1000, 1, 2), 3.0, np.float32)], axis=1)


CHAINS = {
    "iid": lambda: np.random.default_rng(0).standard_normal((512, 4, 3)).astype(np.float32),
    "ar1": lambda: _ar1(0.95, 512, 4, 2, 1),
    "antithetic_mix": _antithetic_mix,
    "stuck": lambda: np.full((1000, 2, 1), 3.0, np.float32),
    "stuck_mix": _stuck_mix,
    "unmixed": lambda: _ar1(0.3, 256, 4, 2, 3) + np.array([10.0, 0, 0, 0], np.float32)[None, :, None],
}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_ess_and_rhat_match_jax(case):
    x = CHAINS[case]()
    _close(tdiag.effective_sample_size(torch.from_numpy(x)), jdiag.effective_sample_size(x))
    want = np.asarray(jdiag.potential_scale_reduction(x))
    got = tdiag.potential_scale_reduction(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(got[np.isfinite(want)], want[np.isfinite(want)])


def test_stuck_chain_scores_zero_and_antithetic_mix_keeps_its_tail():
    assert tdiag.effective_sample_size(torch.from_numpy(CHAINS["stuck"]()))[0] == 0.0
    ess = float(tdiag.effective_sample_size(torch.from_numpy(_antithetic_mix()))[0])
    assert 0.2 * 4096 * 8 < ess < 0.55 * 4096 * 8


@pytest.mark.parametrize("max_window,dim_slab", [(1024, 2), (700, 5), (None, None)])
def test_long_history_window_and_slab_match_jax(max_window, dim_slab):
    """A history longer than max_window: the trailing window's ESS,
    extrapolated linearly in n, the event in slabs."""
    x = _ar1(0.6, 3000, 3, 5, 4)
    kw = dict(max_window=max_window, dim_slab=dim_slab)
    _close(tdiag.effective_sample_size(torch.from_numpy(x), **kw),
           jdiag.effective_sample_size(x, **kw))


def test_rhat_needs_four_draws_and_stuck_chains():
    with pytest.raises(ValueError, match="at least 4 draws"):
        tdiag.potential_scale_reduction(torch.zeros((3, 4, 2)))
    assert float(tdiag.potential_scale_reduction(torch.full((64, 4, 1), 2.0))[0]) == 1.0
    apart = torch.full((64, 4, 1), 2.0)
    apart[:, 1] = 5.0
    assert torch.isinf(tdiag.potential_scale_reduction(apart)[0])


def test_summarize_matches_jax():
    x = np.random.default_rng(4).standard_normal((128, 4, 5)).astype(np.float32)
    got, want = tdiag.summarize(torch.from_numpy(x)), jdiag.summarize(x)
    assert set(got) == set(want) == {"ess_mean", "ess_min", "rhat_max"}
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=RTOL)
    assert tdiag.summarize(torch.from_numpy(x[:3]))["rhat_max"] is None


def _outputs(draws):
    event = draws.shape[2:]
    t, j = MCMCOutput(event), JMCMCOutput(event)
    t.running_samples.add(torch.from_numpy(draws))
    j.running_samples.add(jnp.asarray(draws))
    return t, j


def test_output_methods_match_jax():
    draws = _ar1(0.5, 200, 6, 4, 5).reshape(200, 6, 2, 2)  # a matrix event
    t, j = _outputs(draws)
    _close(t.effective_sample_size(), j.effective_sample_size())
    _close(t.effective_sample_size(max_window=64, dim_slab=3),
           j.effective_sample_size(max_window=64, dim_slab=3))
    ess, factor = t.effective_sample_size(max_window=64, return_extrapolation=True)
    assert factor == j.effective_sample_size(max_window=64, return_extrapolation=True)[1] == 200 / 64
    _close(t.potential_scale_reduction(), j.potential_scale_reduction())
    # the same numpy indices, so the same draws
    assert np.array_equal(t.resample(9, seed=3).numpy(), np.asarray(j.resample(9, seed=3)))


@pytest.mark.parametrize("n_draws", [50, 3])
def test_summary_layout_matches_jax(n_draws):
    """The same table, line for line: the text columns equal, the numbers
    within rounding of a float32 ESS (R-hat reads n/a under 4 draws)."""
    draws = _ar1(0.5, n_draws, 6, 12, 6)
    t, j = _outputs(draws)
    got, want = t.summary().splitlines(), j.summary().splitlines()
    assert len(got) == len(want) == 1 + 10 + 1 + 1
    assert got[0] == want[0] and got[11] == want[11]
    for a, b in zip(got[1:11] + got[12:], want[1:11] + want[12:]):
        wa, wb = a.replace("|", " ").split(), b.replace("|", " ").split()
        assert len(wa) == len(wb)
        for u, v in zip(wa, wb):
            try:
                # an ESS prints as an integer: one unit of rounding
                step = 1e-3 if "." in v else 1.0
                assert float(u) == pytest.approx(float(v), rel=RTOL, abs=step, nan_ok=True)
            except ValueError:
                assert u == v
    assert ("n/a" in got[1]) == (n_draws < 4)


def test_diagnostics_need_stored_draws():
    out = MCMCOutput((3,), store_samples=False)
    with pytest.raises(ValueError, match="no stored samples"):
        out.effective_sample_size()
    with pytest.raises(ValueError, match="no stored samples"):
        out.resample(4)

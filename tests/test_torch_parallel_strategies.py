"""Every strategy and the transport layer sharded over several ranks on the
CPU: the strategies declared after ``tests/test_torch_parallel.py``'s (ULA,
UHMC, MH / RandomWalk, NUTS, ESS, AdaptiveIMH, NeuTra-MH / NeuTra-ChEES,
the eight other ``jump_*``) on a 2-rank gloo group, AIES on three ranks (a
block across both halves), each held against its unsharded port run; AFT,
PMC, CRAFT, AIS and SNF with their particles sharded; nested sampling and
FAB with their mesh-placed inputs (a sharded live set, replicated flow
parameters), run whole on every rank as the JAX package runs them.

The ranks are spawned once for the file (``tests/parallel_strategy_ranks.
py`` runs the scenarios; it imports no JAX) with their own time limit, so
that a hung collective fails the tests instead of stalling the suite.

Tolerances: on several ranks the sums over the chains change order, so
draws, last states and means agree to ``atol=1e-5`` with equal counters
(``tests/test_sharding.py``'s). AFT with its fits off: log Z to 1e-3 (that
file's) and the particles to 1e-5; with its fits on that file's bounds
(both finite, |delta log Z| < 0.75, particle means to 0.15). PMC: log Z
within that file's 0.3 and, tighter, within 1e-4 of the unsharded port
run. CRAFT's sampling pass, AIS and SNF's inverse: to 1e-5 (log Z to
1e-3); CRAFT trained: that file's AFT bounds with fits (log Z within 0.75,
particle means to 0.15) and at most CRAFT_PARTED of its weights more than
1e-5 from the unsharded run's; SNF fitted: each epoch's loss, the weights
and log Z on fresh draws to 1e-5; nested sampling and FAB bit for bit. Each
transport method given no seed, on ranks whose global streams differ, is
held to the unsharded run from the first rank's stream at the same
bounds."""
import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.api.registry import PORTED_STRATEGIES
from nfmc_torch.core.chains import support_multi_rank
from nfmc_torch.potentials import StandardGaussian
from tests import parallel_strategy_ranks as psr

RANKS_TIMEOUT_S = 240
ATOL = 1e-5
# trained CRAFT: the share of its weights that may part from the unsharded
# run's by more than ATOL. A fresh Adam step moves a weight by about lr in
# the sign of its gradient, so a gradient within rounding of 0, summed over
# the ranks in another order, may move its weight the other way (none here:
# a sound run parts no weight); a wrong loss (weights normalised on each
# rank alone) parts many
CRAFT_PARTED = 0.01


def _spawn(workdir, world, names):
    """Run ``names`` on ``world`` spawned gloo ranks; their results."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=psr.run_rank, args=(r, world, workdir, names))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.time() + RANKS_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            pytest.fail(f"ranks {hung} did not finish within {RANKS_TIMEOUT_S} s "
                        "(a collective that never completed?)")
        results = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        errors = [f"rank {r} {k}: {v['error']}" for r, res in enumerate(results)
                  for k, v in res.items() if "error" in v]
        # a scenario that raises on one rank leaves the others in a
        # collective until gloo's timeout: report the scenarios' own errors
        assert [p.exitcode for p in procs] == [0] * world, "\n".join(errors)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return results, workdir


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("ranks2")), 2, list(psr.SCENARIOS))


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("ranks3")), 3, list(psr.ODD_SCENARIOS))


def _sharded(ranks, name):
    """A scenario's result, the same on every rank (gathered, reduced)."""
    results = ranks[0]
    for res in results:
        assert "error" not in res[name], res[name].get("error")
    r0 = results[0][name]
    for res in results[1:]:
        for k in r0:
            if isinstance(r0[k], np.ndarray):
                np.testing.assert_array_equal(r0[k], res[name][k], err_msg=k)
            else:
                assert r0[k] == res[name][k], k
    return r0


def _assert_matches(got, want):
    assert got["samples"].shape == want["samples"].shape
    for k in ("samples", "last", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    assert got["counters"] == want["counters"]
    for k in ("step_size", "inv_mass", "flow", "warm_flow", "warm", "ellipse", "cont", "depths"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


SAMPLER_SCENARIOS = ["ula", "uhmc", "mh", "random_walk", "nuts", "ess_dense", "ess_diag",
                     "adaptive_imh_fused", "adaptive_imh_host", "neutra_mh", "neutra_chees",
                     "jump_ula", "jump_hmc", "jump_uhmc", "jump_mh", "jump_ess", "jump_nuts",
                     "jump_chees", "jump_aies"]


@pytest.mark.parametrize("name", SAMPLER_SCENARIOS)
def test_two_ranks_match_unsharded(ranks, name):
    """Each newly declared class on two ranks, its warmup (the inner one
    and the flow's fit for the jump samplers, both refit routes for
    AdaptiveIMH and the jump samplers) and its sampling, as the unsharded
    run."""
    torch.set_num_threads(1)
    _assert_matches(_sharded(ranks, name), psr.SCENARIOS[name](None, ranks[1]))


def test_nuts_tree_depths_are_global(ranks):
    """NUTS's ``tree_depths()``: the same on both ranks (``_sharded``) and
    equal to the unsharded run's, though each rank built its own trees."""
    torch.set_num_threads(1)
    got = _sharded(ranks, "nuts")["depths"]
    want = psr.nuts(None, ranks[1])["depths"]
    np.testing.assert_array_equal(got, want)
    assert want[1] >= 1


def test_aies_three_ranks_match_unsharded(three_ranks):
    """AIES on 12 walkers over three ranks (rank 1's block across both
    halves): counters bit for bit, draws to 1e-5."""
    torch.set_num_threads(1)
    got = _sharded(three_ranks, "aies_odd")
    want = psr.aies_odd(None, three_ranks[1])
    _assert_matches(got, want)
    assert got["counters"][0] > 0


def test_aft_without_fits_matches_unsharded(ranks):
    """AFT with the fits off: log Z to 1e-3, particles and their history to
    1e-5, log-weights and the ESS trace likewise."""
    torch.set_num_threads(1)
    _aft_nofit(_sharded(ranks, "aft_nofit"), psr.aft_nofit(None, ranks[1]))


def _aft_nofit(got, want):
    assert abs(got["log_Z"] - want["log_Z"]) < 1e-3
    for k in ("particles", "history", "log_weights", "ess_trace"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def test_aft_with_fits_matches_unsharded(ranks):
    """AFT with 3 epochs a level (``tests/test_sharding.py``'s bounds)."""
    torch.set_num_threads(1)
    got, want = _sharded(ranks, "aft_fit"), psr.aft_fit(None, ranks[1])
    assert np.isfinite(got["log_Z"]) and np.isfinite(want["log_Z"])
    assert abs(got["log_Z"] - want["log_Z"]) < 0.75
    assert np.isfinite(got["particles"]).all()
    np.testing.assert_allclose(got["particles"].mean(0), want["particles"].mean(0), atol=0.15)


def test_aft_level_fit_shares_a_whole_group(ranks):
    """A level fit whose train group is sharded and whose val group is
    whole on every rank: the fitted weights and the best val loss to 1e-5
    of the unsharded fit's."""
    torch.set_num_threads(1)
    got, want = _sharded(ranks, "aft_level_fit"), psr.aft_level_fit(None, ranks[1])
    np.testing.assert_allclose(got["flow"], want["flow"], rtol=0, atol=ATOL)
    assert abs(got["best"] - want["best"]) < ATOL
    assert not np.allclose(want["flow"], psr._flat(psr._transport_problem()[2].params))


def test_pmc_matches_unsharded(ranks):
    """PMC: log Z within 0.3 (``tests/test_sharding.py``) and within 1e-4
    of the unsharded port run, with the same temperature ladder."""
    torch.set_num_threads(1)
    _pmc(_sharded(ranks, "pmc"), psr.pmc(None, ranks[1]))


def _pmc(got, want):
    assert np.isfinite(got["log_Z"])
    assert abs(got["log_Z"] - want["log_Z"]) < 0.3
    assert abs(got["log_Z"] - want["log_Z"]) < 1e-4
    assert got["beta_trace"].shape == want["beta_trace"].shape
    np.testing.assert_allclose(got["beta_trace"], want["beta_trace"], rtol=0, atol=ATOL)


def _close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def _craft_sample(got, want):
    assert abs(got["log_Z"] - want["log_Z"]) < 1e-3
    _close(got, want, ("particles", "log_weights", "history"))


def _craft_train(got, want):
    assert np.isfinite(got["log_Z"]) and np.isfinite(want["log_Z"])
    assert abs(got["log_Z"] - want["log_Z"]) < 0.75
    assert np.isfinite(got["particles"]).all() and np.isfinite(got["flow"]).all()
    np.testing.assert_allclose(got["particles"].mean(0), want["particles"].mean(0), atol=0.15)
    # the trained weights: at most CRAFT_PARTED of them part by more than ATOL
    parted = np.mean(np.abs(got["flow"] - want["flow"]) > ATOL)
    assert parted <= CRAFT_PARTED, parted
    # the passes trained the maps
    assert not np.array_equal(want["flow"], psr._craft(None, 0)["flow"])


def _ais(got, want):
    assert got["plain"]
    _close(got, want, ("particles", "log_w"))


def _snf_fit(got, want):
    assert np.isfinite(got["log_Z"]) and abs(got["log_Z"] - want["log_Z"]) < ATOL
    assert np.isfinite(got["flow"]).all()
    # each epoch's loss summed over the ranks, and the steps taken on it
    _close(got, want, ("loss", "flow"))


def _bit_for_bit(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


TRANSPORT_CHECKS = {
    "craft_sample": _craft_sample, "craft_train": _craft_train, "ais_base": _ais,
    "ais_chain": _ais, "snf_inverse": lambda got, want: _close(
        got, want, ("history", "particles", "log_w")),
    "snf_fit": _snf_fit, "ns": _bit_for_bit, "fab": _bit_for_bit,
}


@pytest.mark.parametrize("name", list(TRANSPORT_CHECKS))
def test_sharded_transport_matches_unsharded(ranks, name):
    """CRAFT (sampling, training), AIS (``ais_base``, the chain), SNF
    (``inverse``, ``fit``), nested sampling and FAB on their mesh-placed
    inputs over two ranks: the same result on both, held against the
    unsharded run at the bounds of the module doc; FAB's and nested
    sampling's flow parameters come back replicated on the mesh."""
    torch.set_num_threads(1)
    got, want = _sharded(ranks, name), psr.SCENARIOS[name](None, ranks[1])
    TRANSPORT_CHECKS[name](got, want)


def _aft_unseeded(got, want):
    """``_aft_nofit`` with the ESS trace, a count of particles, to a
    relative 1e-6 (float32's rounding of a sum taken in another order)."""
    assert abs(got["log_Z"] - want["log_Z"]) < 1e-3
    _close(got, want, ("particles", "history", "log_weights"))
    np.testing.assert_allclose(got["ess_trace"], want["ess_trace"], rtol=1e-6, atol=0)


UNSEEDED_CHECKS = {**TRANSPORT_CHECKS, "aft_nofit": _aft_unseeded, "pmc": _pmc}


@pytest.mark.parametrize("name", list(psr.UNSEEDED))
def test_unseeded_transport_draws_from_the_first_rank_seed(ranks, name):
    """Each transport method given no seed on two ranks whose global streams
    differ (the second rank's advanced by one seed): every rank draws from
    the first rank's seed, so the run is the unsharded one from that
    stream, at the bounds of its seeded scenario."""
    torch.set_num_threads(1)
    got = _sharded(ranks, f"unseeded_{name}")
    want = psr.SCENARIOS[f"unseeded_{name}"](None, ranks[1])
    UNSEEDED_CHECKS[name](got, want)


def test_fab_refuses_a_parameter_placed_shard(ranks):
    """FAB given a flow with a parameter placed ``Shard(0)``: ValueError,
    naming the placements."""
    caught = _sharded(ranks, "fab_sharded_parameter")["caught"]
    assert caught.startswith("ValueError") and "Shard(dim=0)" in caught, caught


def _strategy_kwargs(strategy):
    kw = {"flow": 'realnvp%{"n_layers": 2, "hidden_size": 8}', "device": "cpu"}
    if strategy in ("ess", "jump_ess", "tess", "dlmc"):
        kw["negative_log_likelihood"] = StandardGaussian((3,))
    return kw


@pytest.mark.parametrize("strategy", PORTED_STRATEGIES)
def test_every_strategy_declares_multi_rank(strategy):
    """Every class ``create_sampler`` builds, and every sampler it holds,
    declares ``multi_rank_chains``: each of the 31 strategies shards."""
    sampler = nfmc_torch.create_sampler(StandardGaussian((3,)), strategy=strategy,
                                        **_strategy_kwargs(strategy))
    assert support_multi_rank(sampler)

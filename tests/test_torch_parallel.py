"""``nfmc_torch.parallel`` on the CPU: chain-sharded sampling and
data-parallel fits on a 2-rank gloo group, held against the unsharded port
and, for the fits, against the JAX package on its 8-device virtual mesh; and
one-rank meshes, bit for bit as the runs without a mesh.

The two ranks are spawned once for the file (``tests/parallel_ranks.py``
runs the scenarios; they import no JAX) with their own time limit, so that
a hung collective fails the tests instead of stalling the suite.

Tolerances: on two ranks the sums over the chains change order, so draws
and means agree to ``atol=1e-5`` with equal counters (``tests/
test_sharding.py``'s), except DenseHMC's draws, to 1e-4 (that file's for the
dense metric's draws: the covariance's sum order reaches the metric, 20
leapfrogs carry it; the metric itself to 1e-5, as there); fitted weights agree with JAX's to 1e-4 for ``fit`` and to
1e-5 relative plus 1e-4 of the largest weight for ``variational_fit``, the
tolerances of the port's unsharded fits (``tests/test_torch_train.py``,
``tests/test_torch_imh.py``)."""
import multiprocessing
import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_tpu.flows import Flow as JFlow
from nfmc_tpu.flows import RealNVP as JRealNVP
from nfmc_tpu.parallel import chain_mesh as jax_chain_mesh
from nfmc_torch.flows import from_jax_params
from nfmc_torch.potentials import StandardGaussian
from tests import parallel_ranks as pr

RANKS_TIMEOUT_S = 180
ATOL = 1e-5
FIT_D = 6
FIT_KW = dict(shuffle=False, batch_size=16, n_epochs=3, early_stopping=False)
VFIT_KW = dict(n_samples=16, n_epochs=6, lr=0.01)
VFIT_MU = 1.5


def _fit_inputs(workdir):
    """The JAX flow, its perturbed weights carried across, the data and the
    JAX variational fit's own base draws, written for the ranks."""
    jflow = JFlow(JRealNVP((FIT_D,), n_layers=3, hidden_size=16, use_pallas=False), seed=0)
    rng = np.random.default_rng(1)
    jflow.params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jflow.params)
    data = np.random.default_rng(2)
    key = jax.random.key(7)
    _, sub = jax.random.split(key)
    inputs = {
        "d": FIT_D, "params": from_jax_params(jflow.params),
        "x_train": (1.3 * data.standard_normal((70, FIT_D)) + 0.5).astype(np.float32),
        "x_val": (1.3 * data.standard_normal((30, FIT_D)) + 0.5).astype(np.float32),
        "zs": [torch.from_numpy(np.array(jax.random.normal(k, (VFIT_KW["n_samples"], FIT_D))))
               for k in jax.random.split(sub, VFIT_KW["n_epochs"])],
        "mu": VFIT_MU, "fit_kwargs": FIT_KW, "vfit_kwargs": VFIT_KW}
    path = os.path.join(workdir, "fit_inputs.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(inputs, f)
    os.replace(path + ".tmp", path)  # the ranks wait for the whole file
    return jflow, key


def _jax_fits(jflow, key, workdir):
    """JAX's fit and variational fit on its 8-device mesh, from the same
    weights as the ranks'."""
    import copy

    import jax.numpy as jnp

    inputs = pr._fit_inputs(workdir)
    mesh = jax_chain_mesh()
    jfit = copy.deepcopy(jflow)
    jfit.fit(inputs["x_train"], x_val=inputs["x_val"], seed=0, mesh=mesh, **FIT_KW)
    jvfit = copy.deepcopy(jflow)
    jvfit.variational_fit(lambda x: -0.5 * jnp.sum((x - VFIT_MU) ** 2, -1), key=key, mesh=mesh,
                          **VFIT_KW)
    return {"fit": pr._flat(from_jax_params(jfit.params)),
            "variational_fit": pr._flat(from_jax_params(jvfit.params))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run every scenario on 2 spawned gloo ranks; the fits' inputs and the
    JAX references are computed here meanwhile. Yields ``(per-rank results,
    JAX fits, workdir)``."""
    workdir = str(tmp_path_factory.mktemp("ranks"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=pr.run_rank, args=(r, 2, workdir, list(pr.SCENARIOS)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        jflow, key = _fit_inputs(workdir)
        jax_fits = _jax_fits(jflow, key, workdir)
        deadline = time.time() + RANKS_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            pytest.fail(f"ranks {hung} did not finish within {RANKS_TIMEOUT_S} s "
                        "(a collective that never completed?)")
        results = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        errors = [f"rank {r} {k}: {v['error']}" for r, res in enumerate(results)
                  for k, v in res.items() if "error" in v]
        # a scenario that raises on one rank leaves the other in a collective
        # until gloo's timeout: report the scenarios' own errors first
        assert [p.exitcode for p in procs] == [0, 0], "\n".join(errors)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    yield results, jax_fits, workdir


def _sharded(ranks, name):
    """A scenario's result, the same on both ranks (gathered, reduced)."""
    results = ranks[0]
    r0, r1 = results[0][name], results[1][name]
    assert "error" not in r0, r0.get("error")
    assert "error" not in r1, r1.get("error")
    for k in r0:
        if isinstance(r0[k], np.ndarray):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        else:
            assert r0[k] == r1[k], k
    return r0


# tests/test_sharding.py's tolerance for the dense metric's draws
LOOSER = {"dense_hmc": 1e-4}


def _assert_matches(got, want, atol=ATOL):
    assert got["samples"].shape == want["samples"].shape
    np.testing.assert_allclose(got["samples"], want["samples"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["last"], want["last"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0, atol=atol)
    assert got["counters"] == want["counters"]
    assert got.get("swaps") == want.get("swaps")
    for k in ("step_size", "inv_mass", "flow", "warm_flow", "warm", "warm_counters", "betas",
              "step_sizes", "hot", "trajectory", "synced_samples", "synced_counters"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
    if "mass_cov" in want:
        np.testing.assert_allclose(got["mass_cov"], want["mass_cov"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["mala", "hmc", "imh", "jump_mala_fused", "jump_mala_host",
                                  "front_door", "front_door_checkpoint", "mala_divergent",
                                  "mala_divergent_graphed", "jump_divergent_graphed",
                                  "dense_mala", "dense_hmc", "neutra_hmc", "tess_fused",
                                  "tess_host", "dlmc_fused", "dlmc_host", "pt_mala", "pt_mh",
                                  "pt_hmc", "aies", "chees_hmc", "mesh_2x1", "mesh_1x2",
                                  "custom_axis"])
def test_two_ranks_match_unsharded(ranks, name):
    """Each required strategy (MALA, HMC with its tuning warmup, IMH with
    its reverse-KL warmup, JumpMALA with the warmup's fit and both
    ``fit_nf`` routes), the front door with ``warmup=True`` and with a
    checkpoint, divergences, the further strategies that declare multi-rank
    support (DenseMALA, DenseHMC, NeuTraHMC, TESS and DLMC with either
    refit route, the PT family through a checkpointed continuation, AIES,
    ChEES-HMC tuning), MALA and JumpMALA through the capture layer's
    protocol,
    and (2, 1), (1, 2) and custom-axis meshes: sharded over two ranks, as
    the unsharded run."""
    torch.set_num_threads(1)
    _assert_matches(_sharded(ranks, name), pr.SCENARIOS[name](None, ranks[2]),
                    LOOSER.get(name, ATOL))


def test_front_door_checkpoint_is_removed(ranks):
    """Global rank 0 alone writes the checkpoint; it is gone on success."""
    assert _sharded(ranks, "front_door_checkpoint")["left"] is False


def test_resumable_shard_fn_reshards_between_segments(ranks):
    """``sample_resumable(shard_fn=...)``: applied after each of the three
    segments, to a rank's 8 of the 16 chains, and the draws match the
    unsharded segmented run."""
    got = _sharded(ranks, "resumable_shard_fn")
    assert got["pinned"] == [(8, pr.D)] * 3
    _assert_matches(got, pr.resumable_shard_fn(None, ranks[2]))


def test_uneven_chains_and_unsupported_strategies_raise(ranks):
    caught = _sharded(ranks, "rejections")["caught"]
    assert caught[0].startswith("ValueError") and "divisible" in caught[0]
    assert caught[1].startswith("ValueError") and "divisible" in caught[1]
    assert caught[2].startswith("NotImplementedError") and "ROADMAP 1.8d" in caught[2]


@pytest.mark.parametrize("name", ["fit", "variational_fit"])
def test_two_rank_fits_match_jax_on_its_mesh(ranks, name):
    """The port's 2-rank data-parallel fit against JAX's ``mesh=`` fit on its
    8-device CPU mesh, from the same weights (batch 16, no shuffle)."""
    got = _sharded(ranks, name)["flow"]
    want = ranks[1][name]
    scale = max(1.0, float(np.abs(want).max()))
    if name == "fit":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * scale)
    # the weights moved
    assert not np.allclose(got, pr._flat(pr._fit_inputs(ranks[2])["params"]))


# ---- one-rank meshes in this process ----------------------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist

    from nfmc_torch.parallel import chain_mesh

    assert not dist.is_initialized()
    mesh = chain_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


# a strategy of each family, every one declared for several ranks
ONE_RANK_STRATEGIES = ["mala", "ula", "mh", "adaptive_imh", "jump_hmc", "nuts", "ess",
                       "neutra_mh", "uhmc", "jump_ula", "jump_uhmc", "jump_mh", "jump_ess",
                       "jump_nuts", "jump_chees", "jump_aies", "neutra_chees"]


@pytest.mark.parametrize("strategy", ONE_RANK_STRATEGIES)
def test_one_rank_mesh_is_bit_identical(one_rank_mesh, strategy):
    """On a one-rank mesh every strategy runs, bit for bit as without a
    mesh."""
    torch.set_num_threads(1)
    kw = dict(flow='realnvp%{"n_layers": 2, "hidden_size": 8}', n_chains=8, n_iterations=3,
              device="cpu", seed=3, show_progress=False, inner_param_kwargs={"n_iterations": 2})
    if strategy in ("ess", "jump_ess"):
        kw["negative_log_likelihood"] = StandardGaussian((3,))
    plain = nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy, **kw)
    sharded = nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy, mesh=one_rank_mesh,
                                **kw)
    assert torch.equal(plain.samples, sharded.samples)
    assert plain.statistics.n_accepted_trajectories == sharded.statistics.n_accepted_trajectories


def test_one_rank_fit_and_warmup_are_bit_identical(one_rank_mesh):
    """``fit(mesh=...)`` and a tuned front-door warmup on one rank."""
    torch.set_num_threads(1)
    weights = []
    for mesh in (None, one_rank_mesh):
        flow = pr._flow(seed=4)
        flow.fit(np.random.default_rng(0).standard_normal((100, pr.D)).astype(np.float32),
                 n_epochs=3, seed=1, mesh=mesh)
        weights.append(pr._flat(flow.params))
    np.testing.assert_array_equal(weights[0], weights[1])
    outs = [nfmc_torch.sample(StandardGaussian((3,)), strategy="hmc", n_chains=8, n_iterations=3,
                              n_warmup_iterations=5, warmup=True, device="cpu", seed=5,
                              show_progress=False, mesh=mesh) for mesh in (None, one_rank_mesh)]
    assert torch.equal(outs[0].samples, outs[1].samples)
    assert outs[0].kernel.step_size == outs[1].kernel.step_size


def test_parallel_exports_and_placements(one_rank_mesh):
    """The five names of ``nfmc_tpu.parallel``; ``shard_chains`` gives a
    DTensor of the global shape placed ``Shard(0)``, ``replicate`` places
    ``Replicate()``, ``constrain_chains`` is the identity on a local tensor,
    and ``chain_mesh`` refuses more ranks than the group has."""
    from torch.distributed.tensor import Replicate, Shard

    import nfmc_tpu.parallel
    from nfmc_torch import parallel

    assert parallel.__all__ == nfmc_tpu.parallel.__all__
    x = parallel.shard_chains(np.zeros((16, 5), np.float32), one_rank_mesh)
    assert tuple(x.shape) == (16, 5) and x.placements == (Shard(0),)
    tree = parallel.replicate({"w": [np.ones(3)], "b": np.zeros(2)}, one_rank_mesh)
    assert tree["w"][0].placements == (Replicate(),) and tuple(tree["b"].shape) == (2,)
    local = torch.ones(4, 5)
    assert parallel.constrain_chains(local, one_rank_mesh) is local
    assert parallel.constrain_chains(x, one_rank_mesh).placements == (Shard(0),)
    with pytest.raises(ValueError, match="n_devices=2"):
        parallel.chain_mesh(n_devices=2, device_type="cpu")
    with pytest.raises(ValueError, match="nccl"):
        parallel.chain_mesh(device_type="cuda")
